"""Model factory (counterpart of stcd_tpu/models/factory.py::define_G)."""

from __future__ import annotations

from torch import nn

_BIT_KEYS = {
    "base_transformer_pos_s4": dict(),
    "base_transformer_pos_s4_dd8": dict(enc_depth=1, dec_depth=8),
    "base_transformer_pos_s4_dd8_dedim8": dict(enc_depth=1, dec_depth=8,
                                               decoder_dim_head=8),
}


def define_G(net_G: str, n_class: int = 2, embed_dim: int = 256,
             device=None) -> nn.Module:
    """Build a change-detection generator by the reference's net_G key.

    Ported: ``ChangeFormerV6`` and the BIT family (``base_resnet18``,
    ``base_transformer_pos_s4``, ``base_transformer_pos_s4_dd8``,
    ``base_transformer_pos_s4_dd8_dedim8``). As in the reference and the JAX
    factory, all of them ignore ``n_class`` and have a 2-class head; V6's
    ``embed_dim`` defaults to the published 256."""
    if net_G == "ChangeFormerV6":
        from stcd_tpu_torch.models.changeformer import ChangeFormerV6
        return ChangeFormerV6(embed_dim=embed_dim, device=device)
    if net_G == "base_resnet18":
        from stcd_tpu_torch.models.bit import ResNetCD
        return ResNetCD(output_nc=2, output_sigmoid=False, device=device)
    if net_G in _BIT_KEYS:
        from stcd_tpu_torch.models.bit import BASETransformer
        return BASETransformer(output_nc=2, token_len=4, resnet_stages_num=4,
                               with_pos="learned", device=device, **_BIT_KEYS[net_G])
    raise NotImplementedError(
        f"net_G {net_G!r} is not ported to stcd_tpu_torch yet; ROADMAP.md "
        "Queue 1 lists the order in which the other models come")


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights by the model family's own rules."""
    from stcd_tpu_torch.models import bit, changeformer
    if isinstance(model, changeformer.ChangeFormerV6):
        return changeformer.init_weights(model, seed)
    if isinstance(model, bit.ResNetCD):
        return bit.init_weights(model, seed)
    raise NotImplementedError(f"no seeded init for {type(model).__name__}")
