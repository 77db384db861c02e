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
"""

from __future__ import annotations

import os
from typing import Optional

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
