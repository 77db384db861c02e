"""Model factories (counterpart of stcd_tpu/models/factory.py): smp's
``create_model`` over the 12 architectures of the JAX ``_ARCHS``, and
``define_G`` over the bespoke change-detection zoo."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from stcd_tpu_torch.models import segcd as _segcd
from stcd_tpu_torch.models import smp_models as _smp

_ARCHS = {
    "unet": _segcd.Unet,
    "unetseg": _segcd.UnetSeg,
    "segcd": _segcd.SegCD,
    "ffctlcd": _segcd.FFCTLCD,
    "unetplusplus": _smp.UnetPlusPlus,
    "manet": _smp.MAnet,
    "linknet": _smp.Linknet,
    "fpn": _smp.FPN,
    "pspnet": _smp.PSPNet,
    "deeplabv3": _smp.DeepLabV3,
    "deeplabv3plus": _smp.DeepLabV3Plus,
    "pan": _smp.PAN,
}


def create_model(arch: str, encoder_name: str = "resnet34",
                 encoder_weights: Optional[str] = None, in_channels: int = 3,
                 classes: int = 1, device=None, **kwargs) -> nn.Module:
    """smp's ``create_model`` (stcd_tpu/models/factory.py:32-71): ``arch`` is
    one of ``_ARCHS`` (any case); ``kwargs`` go to its constructor.
    ``encoder_weights`` (a path, or a name such as ``"imagenet"`` looked up
    in ``$STCD_PRETRAINED_DIR``) is resolved here, so a missing file raises
    before anything is built, and loaded into the encoder. ``in_channels``
    other than 3 builds the first conv at that width; with pretrained
    weights it raises, as in the JAX package: the file's stem is adapted
    first, by ``convert.pretrained.patch_first_conv``."""
    arch_l = arch.lower()
    if arch_l not in _ARCHS:
        raise KeyError(f"Wrong architecture `{arch}`. Available: {sorted(_ARCHS)}")
    if in_channels != 3 and encoder_weights is not None:
        raise NotImplementedError(
            f"in_channels={in_channels} with pretrained weights needs the first-conv "
            "adaptation: apply stcd_tpu_torch.convert.pretrained.patch_first_conv("
            f"torch.load(file), {in_channels}) to the encoder's file, torch.save the result, "
            "build with encoder_weights=None and load it with "
            "encoders.load_encoder_weights(model.encoder, path).")
    if encoder_weights is not None:
        from stcd_tpu_torch.convert.pretrained import resolve_encoder_weights
        encoder_weights = resolve_encoder_weights(encoder_weights, encoder_name)
    return _ARCHS[arch_l](encoder_name=encoder_name, encoder_weights=encoder_weights,
                          in_channels=in_channels, classes=classes, device=device, **kwargs)


def register_arch(name: str, cls) -> None:
    _ARCHS[name.lower()] = cls


_BIT_KEYS = {
    "base_transformer_pos_s4": dict(),
    "base_transformer_pos_s4_dd8": dict(enc_depth=1, dec_depth=8),
    "base_transformer_pos_s4_dd8_dedim8": dict(enc_depth=1, dec_depth=8,
                                               decoder_dim_head=8),
}
_CHANGEFORMER_KEYS = tuple(f"ChangeFormerV{v}" for v in range(1, 7))
_SIAM_KEYS = {"Unet": "ef", "SiamUnet_sub": "sub", "SiamUnet_abs": "diff",
              "SiamUnet_conc": "conc", "SiamUnet_cross_conc": "crossconc"}
_GNN_COMPARE_KEYS = ("ChangeGNNV2_sub", "ChangeGNNV2_abs", "ChangeGNNV2_conc")
# every define_G key of the JAX package, in its order
NET_G_KEYS = (tuple(_SIAM_KEYS) + ("DTCDSCN", "IFNet", "SNUNet", "base_resnet18")
              + tuple(_BIT_KEYS) + _CHANGEFORMER_KEYS
              + ("ChangeGNNV1", "ChangeGNNV2") + _GNN_COMPARE_KEYS + ("GNN",))


def define_G(net_G: str, n_class: int = 2, embed_dim: int = 64, img_size: int = 256,
             device=None) -> nn.Module:
    """Build a change-detection generator by the reference's net_G key (any
    of ``NET_G_KEYS``), with the JAX factory's arguments: the FC-Siam family,
    DTCDSCN, SNUNet (``out_ch=n_class``) and the ViG models take ``n_class``;
    IFNet has a 1-channel head, and the BIT and ChangeFormer families a
    2-class one, whatever ``n_class`` is. ``embed_dim`` (64 by default, as
    in the JAX package) is the decoder width of ChangeFormerV5/V6 and of the
    ViG models; ``img_size`` sizes ``pos_embed`` of ChangeGNNV2 and its
    ``_sub``/``_abs``/``_conc`` variants (ChangeGNNV1 and GNN keep 256, as
    in the JAX factory)."""
    if net_G in _SIAM_KEYS:
        from stcd_tpu_torch.models.siam_unet import SiamUnet
        return SiamUnet(_SIAM_KEYS[net_G], label_nbr=n_class, device=device)
    if net_G == "DTCDSCN":
        from stcd_tpu_torch.models.dtcdscn import CDNet34
        return CDNet34(num_classes=n_class, device=device)
    if net_G == "IFNet":
        from stcd_tpu_torch.models.dsifn import DSIFN
        return DSIFN(device=device)
    if net_G == "SNUNet":
        from stcd_tpu_torch.models.snunet import SNUNetECAM
        return SNUNetECAM(out_ch=n_class, device=device)
    if net_G in _CHANGEFORMER_KEYS:
        from stcd_tpu_torch.models import changeformer
        cls = getattr(changeformer, net_G)
        if net_G in ("ChangeFormerV5", "ChangeFormerV6"):
            return cls(embed_dim=embed_dim, device=device)
        return cls(device=device)
    if net_G == "base_resnet18":
        from stcd_tpu_torch.models.bit import ResNetCD
        return ResNetCD(output_nc=2, output_sigmoid=False, device=device)
    if net_G in _BIT_KEYS:
        from stcd_tpu_torch.models.bit import BASETransformer
        return BASETransformer(output_nc=2, token_len=4, resnet_stages_num=4,
                               with_pos="learned", device=device, **_BIT_KEYS[net_G])
    from stcd_tpu_torch.models import changevig
    if net_G == "ChangeGNNV1":
        return changevig.ChangeGNNV1(n_class, embed_dim, device=device)
    if net_G == "ChangeGNNV2":
        return changevig.ChangeGNNV2(n_class, embed_dim, img_size=img_size, device=device)
    if net_G in _GNN_COMPARE_KEYS:
        return changevig.ChangeGNNV2Compare(n_class, embed_dim, img_size=img_size,
                                            diff_mode=net_G.split("_")[-1], device=device)
    if net_G == "GNN":
        return changevig.VIG(n_class, embed_dim, device=device)
    raise NotImplementedError(f"Generator model name [{net_G}] is not recognized; "
                              f"one of {', '.join(NET_G_KEYS)}")


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights by the model family's own rules: ChangeFormer
    and BIT keep theirs; every other ``define_G`` family takes the
    reference's ``init_weights`` (normal, gain 0.02; ``models/init.py``)."""
    from stcd_tpu_torch.models import bit, changeformer
    from stcd_tpu_torch.models import init as zoo_init
    if isinstance(model, changeformer._SiamBase):
        return changeformer.init_weights(model, seed)
    if isinstance(model, bit.ResNetCD):
        return bit.init_weights(model, seed)
    return zoo_init.init_weights(model, "normal", 0.02,
                                 generator=torch.Generator().manual_seed(seed))
