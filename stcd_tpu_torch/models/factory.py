"""Model factory (counterpart of stcd_tpu/models/factory.py::define_G)."""

from __future__ import annotations


def define_G(net_G: str, n_class: int = 2, embed_dim: int = 256, device=None):
    """Build a change-detection generator by the reference's net_G key.

    Only ``ChangeFormerV6`` is ported so far. As in the reference and the
    JAX factory, V6 ignores ``n_class`` and has a 2-class head; its
    ``embed_dim`` defaults to the published 256."""
    if net_G == "ChangeFormerV6":
        from stcd_tpu_torch.models.changeformer import ChangeFormerV6
        return ChangeFormerV6(embed_dim=embed_dim, device=device)
    raise NotImplementedError(
        f"net_G {net_G!r} is not ported to stcd_tpu_torch yet; ROADMAP.md "
        "Queue 1 lists the order in which the other models come")
