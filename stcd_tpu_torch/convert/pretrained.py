"""Resolution of pretrained encoder weights (counterpart of
stcd_tpu/convert/pretrained.py).

The reference trains every stage from ImageNet-pretrained encoders
(``encoder_weights="imagenet"``). The port loads torch state_dicts under
each encoder family's upstream names (``encoders.load_encoder_weights``), so
what is left of the JAX module is the path resolution. It downloads nothing.

Contract (loud, never a silent no-op):
- ``weights=None``        -> random init (the only silent path).
- ``weights=<path>``      -> that file; raise if it is missing. A literal path
  is never searched for in the directory.
- ``weights="imagenet"``  -> ``{encoder}.pth`` (or ``{encoder}_imagenet.pth``)
  under ``$STCD_PRETRAINED_DIR`` (default
  ``~/.cache/stcd_tpu_torch/pretrained``); raise FileNotFoundError with
  instructions if absent.

``patch_first_conv`` adapts such a state_dict's RGB stem to another number
of input channels, as smp does for ``in_channels != 3``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

_DEFAULT_DIR = os.path.join("~", ".cache", "stcd_tpu_torch", "pretrained")


def pretrained_dir() -> str:
    return os.environ.get("STCD_PRETRAINED_DIR", os.path.expanduser(_DEFAULT_DIR))


def resolve_encoder_weights(weights: Optional[str],
                            encoder_name: Optional[str] = None) -> Optional[str]:
    """Map an ``encoder_weights`` argument to a local state_dict path, or raise."""
    if weights is None:
        return None
    if os.path.isfile(weights):
        return weights
    if os.sep in weights or weights.endswith(".pth"):
        # a literal path: never fall back to the directory (a mistyped or deleted
        # path silently becoming stock ImageNet weights is what this contract bans)
        raise FileNotFoundError(
            f"encoder_weights path {weights!r} does not exist. Literal paths are not "
            "searched in $STCD_PRETRAINED_DIR; pass a name like 'imagenet' for "
            "directory resolution.")
    if encoder_name:
        d = pretrained_dir()
        for cand in (os.path.join(d, f"{encoder_name}.pth"),
                     os.path.join(d, f"{encoder_name}_{weights}.pth")):
            if os.path.isfile(cand):
                return cand
    name = encoder_name or "<arch>"
    raise FileNotFoundError(
        f"encoder_weights={weights!r}"
        + (f" for encoder {encoder_name!r}" if encoder_name else "")
        + f" not found (searched the literal path and {pretrained_dir()}). Nothing is "
        "downloaded: save the encoder's upstream state_dict (torch.save of "
        f"model.state_dict()) as {os.path.join(pretrained_dir(), name + '.pth')}, or "
        "set $STCD_PRETRAINED_DIR to the directory that holds it.")


def patch_first_conv(state_dict: Dict[str, torch.Tensor], new_in_channels: int,
                     default_in_channels: int = 3) -> Dict[str, torch.Tensor]:
    """smp's ``encoders/_utils.py`` ``patch_first_conv`` on a state_dict of
    OIHW tensors (stcd_tpu/convert/torch_to_flax.py:1099, which does it on
    HWIO kernels): the stem, the first 4-D weight with ``default_in_channels``
    input channels in module order, is adapted so that pretrained RGB weights
    drive ``new_in_channels`` inputs. One channel: the sum over the input
    channels. Otherwise the source channels cycle (i mod 3), rescaled by
    3 / new. Returns a new dict; the other entries are the same tensors."""
    stem = next((k for k, w in state_dict.items()
                 if w.dim() == 4 and w.shape[1] == default_in_channels), None)
    if stem is None:
        raise ValueError(f"no stem conv with {default_in_channels} input channels found")
    if new_in_channels == default_in_channels:
        return dict(state_dict)
    w = state_dict[stem]
    if new_in_channels == 1:
        patched = w.sum(dim=1, keepdim=True)
    else:
        idx = [i % default_in_channels for i in range(new_in_channels)]
        patched = w[:, idx] * (default_in_channels / new_in_channels)
    return {**state_dict, stem: patched.to(w.dtype)}
