"""JAX variables -> the port's state_dict: the exact inverses of
stcd_tpu/convert/torch_to_flax.py::convert_changeformer_v6 and
_convert_mit_encoder (:458-493, :588-616), of convert_changeformer_v1 to v4
(:632-701), of convert_mix_transformer (:1392-1425), of convert_resnet,
convert_unet_decoder and convert_unetseg (:39-70, :177-212), of convert_bit
(:365-436), and of the bespoke zoo's: convert_siam_unet (:261), convert_snunet
(:323), convert_dtcdscn (:496), convert_dsifn (:549) with
convert_vgg16_features (:77), convert_cdnet (:215) and convert_changevig
(:1103) with its decoder helpers (:876-1100), and of the smp assemblies of
``create_model``: convert_vgg (:1480), convert_fpn_decoder (:704),
convert_psp_decoder (:721), convert_linknet_decoder (:736),
convert_unetplusplus_decoder (:757), convert_manet_decoder (:771), _aspp,
convert_deeplabv3_decoder and convert_deeplabv3plus_decoder (:797-846) and
convert_pan_decoder (:847), with the parts no JAX converter reads (the scse
gates, the VGG center block, the classification head), all reached through
``smp_model_from_flax``. ``resnet_from_flax`` takes ResNeXt's grouped kernels
as they are.

It takes the nested dicts of arrays that flax holds (numpy or anything
``np.asarray`` reads) and returns a flat state_dict of CPU tensors under the
original reference's names, which ``ChangeFormerV6.load_state_dict`` takes
with ``strict=True`` (and so do UnetSeg, SegCD and FFCTLCD for
``unetseg_from_flax``). Each helper undoes one helper of the forward
converter.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))  # JAX arrays are read-only views


def _conv_w(k) -> torch.Tensor:
    """Inverse of _conv (:27-28): flax HWIO -> torch OIHW. Also inverts
    _convT_2x (:241-244): flax (kH, kW, O, I) -> torch ConvTranspose2d
    (I, O, kH, kW); both are the axis order (3, 2, 0, 1)."""
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _dense_w(k) -> torch.Tensor:
    """Inverse of _dense (:361-362): flax (I, O) -> torch (O, I)."""
    return _t(np.transpose(np.asarray(k), (1, 0)))


def _put_bias(sd: StateDict, prefix: str, p: dict) -> None:
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv_b(sd: StateDict, prefix: str, p: dict) -> None:
    """Inverse of _conv_b (:451-455)."""
    sd[f"{prefix}.weight"] = _conv_w(p["kernel"])
    _put_bias(sd, prefix, p)


def _linear(sd: StateDict, prefix: str, p: dict) -> None:
    """Inverse of _linear (:444-448)."""
    sd[f"{prefix}.weight"] = _dense_w(p["kernel"])
    _put_bias(sd, prefix, p)


def _ln(sd: StateDict, prefix: str, p: dict) -> None:
    """Inverse of _ln (:439-441)."""
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd: StateDict, prefix: str, p: dict, s: dict) -> None:
    """Inverse of _bn (:31-36); num_batches_tracked, which flax does not
    keep, is 0."""
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def mit_encoder_from_flax(enc: Dict[str, Any], prefix: str) -> StateDict:
    """Inverse of _convert_mit_encoder: SegFormerEncoder params -> the
    ``{prefix}.patch_embed*/block*/norm*`` subtree (no prefix for "")."""
    sd: StateDict = {}
    n_stages = sum(1 for key in enc if key.startswith("patch_embed"))
    prefix = f"{prefix}." if prefix else ""
    for s in range(1, n_stages + 1):
        pe = enc[f"patch_embed{s}"]
        _conv_b(sd, f"{prefix}patch_embed{s}.proj", pe["proj"])
        _ln(sd, f"{prefix}patch_embed{s}.norm", pe["norm"])
        i = 0
        while f"block{s}_{i}" in enc:
            blk = enc[f"block{s}_{i}"]
            base = f"{prefix}block{s}.{i}"
            _ln(sd, f"{base}.norm1", blk["norm1"])
            _ln(sd, f"{base}.norm2", blk["norm2"])
            attn = blk["attn"]
            for name in ("q", "kv", "proj"):
                _linear(sd, f"{base}.attn.{name}", attn[name])
            if "sr" in attn:
                _conv_b(sd, f"{base}.attn.sr", attn["sr"])
                _ln(sd, f"{base}.attn.norm", attn["norm"])
            _linear(sd, f"{base}.mlp.fc1", blk["mlp"]["fc1"])
            _linear(sd, f"{base}.mlp.fc2", blk["mlp"]["fc2"])
            _conv_b(sd, f"{base}.mlp.dwconv.dwconv", blk["mlp"]["dw"]["dwconv"])
            i += 1
        _ln(sd, f"{prefix}norm{s}", enc[f"norm{s}"])
    return sd


def mix_transformer_from_flax(params: Dict[str, Any]) -> StateDict:
    """Inverse of convert_mix_transformer: MixTransformerEncoder params
    (``{"mit": ...}``; LayerNorm only, no batch_stats) -> smp's names."""
    return mit_encoder_from_flax(params["mit"], "")


def changeformer_v6_from_flax(params: Dict[str, Any],
                              batch_stats: Dict[str, Any]) -> StateDict:
    """JAX ChangeFormerV6 (params, batch_stats) -> the port's state_dict;
    ``convert_changeformer_v6`` of the result gives the inputs back."""
    sd = mit_encoder_from_flax(params["Tenc_x2"], "Tenc_x2")
    _diff_pyramid_from_flax(sd, params["TDec_x2"], batch_stats["TDec_x2"])
    dec, dst = params["TDec_x2"], batch_stats["TDec_x2"]
    _conv_b(sd, "TDec_x2.linear_fuse.0", dec["linear_fuse_conv"])
    _bn(sd, "TDec_x2.linear_fuse.1", dec["linear_fuse_bn"], dst["linear_fuse_bn"])
    for name in ("convd2x", "convd1x"):
        _upsample_conv(sd, f"TDec_x2.{name}", dec[name])
    for name in ("dense_2x", "dense_1x"):
        _residual_block(sd, f"TDec_x2.{name}", dec[name])
    _conv_b(sd, "TDec_x2.change_probability.conv2d", dec["change_probability"])
    return sd


# V5's encoder and decoder are V6's modules (convert_changeformer_v6 with
# depths=(3, 6, 16, 3) reads its state_dict)
changeformer_v5_from_flax = changeformer_v6_from_flax


def _upsample_conv(sd: StateDict, prefix: str, p: dict) -> None:
    """Inverse of _upsample_conv (:626-629)."""
    _conv_b(sd, f"{prefix}.conv2d", p["ConvTranspose_0"])


def _residual_block(sd: StateDict, prefix: str, p: dict) -> None:
    """Inverse of _residual_block (:619-623)."""
    _conv_b(sd, f"{prefix}.0.conv1.conv2d", p["conv1"])
    _conv_b(sd, f"{prefix}.0.conv2.conv2d", p["conv2"])


def _diff_pyramid_from_flax(sd: StateDict, dec: Dict[str, Any], dst: Dict[str, Any]) -> None:
    """The per-scale ``linear_c*``, ``diff_c*`` and ``make_pred_c*`` of the V4
    to V6 decoders (convert_changeformer_v4 :680-694, v6 :466-480)."""
    k = 1
    while f"linear_c{k}" in dec:
        _linear(sd, f"TDec_x2.linear_c{k}.proj", dec[f"linear_c{k}"])
        dc, ds = dec[f"diff_c{k}"], dst[f"diff_c{k}"]
        for j, off in ((0, 0), (1, 4)):
            base = f"TDec_x2.diff_c{k}"
            _conv_b(sd, f"{base}.{off}", dc[f"conv{j}"])
            sd[f"{base}.{off + 1}.weight"] = _t(dc[f"prelu{j}"])
            _bn(sd, f"{base}.{off + 2}", dc[f"bn{j}"], ds[f"bn{j}"])
        mp = dec[f"make_pred_c{k}"]
        _conv_b(sd, f"TDec_x2.make_pred_c{k}.0", mp["conv1"])
        _bn(sd, f"TDec_x2.make_pred_c{k}.2", mp["bn"], dst[f"make_pred_c{k}"]["bn"])
        _conv_b(sd, f"TDec_x2.make_pred_c{k}.3", mp["conv2"])
        k += 1


def changeformer_v1_from_flax(params: Dict[str, Any],
                              batch_stats: Optional[Dict[str, Any]] = None) -> StateDict:
    """Inverse of convert_changeformer_v1: Tenc, the conv projection and the
    head (V1 has no BatchNorm)."""
    sd = mit_encoder_from_flax(params["Tenc"], "Tenc")
    cp = params["convproj"]
    for name in ("convd16x", "convd8x", "convd4x", "convd2x", "convd1x"):
        _upsample_conv(sd, f"convproj.{name}", cp[name])
    for name in ("dense_4", "dense_3", "dense_2", "dense_1"):
        _residual_block(sd, f"convproj.{name}", cp[name])
    _conv_b(sd, "change_probability.conv2d", params["change_probability"])
    return sd


def changeformer_v2_from_flax(params: Dict[str, Any],
                              batch_stats: Optional[Dict[str, Any]] = None) -> StateDict:
    """Inverse of convert_changeformer_v2: Tenc and TDec."""
    sd = mit_encoder_from_flax(params["Tenc"], "Tenc")
    td = params["TDec"]
    for k in (1, 2, 3, 4):
        _linear(sd, f"TDec.linear_c{k}.proj", td[f"linear_c{k}"])
    _conv_b(sd, "TDec.linear_fuse", td["linear_fuse"])
    for name in ("convd2x", "convd1x"):
        _upsample_conv(sd, f"TDec.{name}", td[name])
    for name in ("dense_2x", "dense_1x"):
        _residual_block(sd, f"TDec.{name}", td[name])
    _conv_b(sd, "TDec.change_probability.conv2d", td["change_probability"])
    return sd


def changeformer_v3_from_flax(params: Dict[str, Any],
                              batch_stats: Optional[Dict[str, Any]] = None) -> StateDict:
    """Inverse of convert_changeformer_v3: Tenc and TDecV2."""
    sd = mit_encoder_from_flax(params["Tenc"], "Tenc")
    td = params["TDec"]
    for k in (1, 2, 3, 4):
        _linear(sd, f"TDec.linear_c{k}.proj", td[f"linear_c{k}"])
    _conv_b(sd, "TDec.linear_fuse", td["linear_fuse"])
    _conv_b(sd, "TDec.pix_shuffle_conv", td["pix_shuffle_conv"])
    return sd


def changeformer_v4_from_flax(params: Dict[str, Any],
                              batch_stats: Dict[str, Any]) -> StateDict:
    """Inverse of convert_changeformer_v4: the 5-stage Tenc_x2 and
    DecoderTransformerX2."""
    sd = mit_encoder_from_flax(params["Tenc_x2"], "Tenc_x2")
    dec = params["TDec_x2"]
    _diff_pyramid_from_flax(sd, dec, batch_stats["TDec_x2"])
    _conv_b(sd, "TDec_x2.linear_fuse", dec["linear_fuse"])
    _upsample_conv(sd, "TDec_x2.convd2x", dec["convd2x"])
    _residual_block(sd, "TDec_x2.dense_2x", dec["dense_2x"])
    _conv_b(sd, "TDec_x2.change_probability.conv2d", dec["change_probability"])
    return sd


def resnet_from_flax(params: Dict[str, Any], stats: Dict[str, Any],
                     prefix: str = "") -> StateDict:
    """Inverse of convert_resnet: ResNetEncoder (params, batch_stats) ->
    torchvision names under ``prefix`` (e.g. ``"encoder."``)."""
    sd: StateDict = {}
    sd[f"{prefix}conv1.weight"] = _conv_w(params["conv1"]["kernel"])
    _bn(sd, f"{prefix}bn1", params["bn1"], stats["bn1"])
    li = 1
    while f"layer{li}" in params:
        lp, ls = params[f"layer{li}"], stats[f"layer{li}"]
        bi = 0
        while f"block{bi}" in lp:
            bp, bs = lp[f"block{bi}"], ls[f"block{bi}"]
            base = f"{prefix}layer{li}.{bi}"
            ci = 1
            while f"conv{ci}" in bp:
                sd[f"{base}.conv{ci}.weight"] = _conv_w(bp[f"conv{ci}"]["kernel"])
                _bn(sd, f"{base}.bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
                ci += 1
            if "downsample_conv" in bp:
                sd[f"{base}.downsample.0.weight"] = _conv_w(bp["downsample_conv"]["kernel"])
                _bn(sd, f"{base}.downsample.1", bp["downsample_bn"], bs["downsample_bn"])
            bi += 1
        li += 1
    return sd


def _conv_bn_relu(sd: StateDict, prefix: str, p: dict, s: dict) -> None:
    """Inverse of _conv_block (:166-174): a ConvBNReLU's ``conv`` and ``bn``
    -> smp's ``{prefix}.0`` and ``{prefix}.1``."""
    _conv_b(sd, f"{prefix}.0", p["conv"])
    if "bn" in p:
        _bn(sd, f"{prefix}.1", p["bn"], s["bn"])


def _scse(sd: StateDict, prefix: str, p: dict) -> None:
    """The JAX SCSEModule (``cse_fc1``, ``cse_fc2``, ``sse_conv``) -> smp's
    ``{prefix}.cSE.1``, ``.cSE.3`` and ``.sSE.0`` (no JAX converter writes it)."""
    _conv_b(sd, f"{prefix}.cSE.1", p["cse_fc1"])
    _conv_b(sd, f"{prefix}.cSE.3", p["cse_fc2"])
    _conv_b(sd, f"{prefix}.sSE.0", p["sse_conv"])


def _decoder_block(sd: StateDict, prefix: str, p: dict, s: dict) -> None:
    """A U-Net DecoderBlock: ``conv{1,2}`` and the scse gates
    ``attention{1,2}``, which sit under ``attention{1,2}.attention``."""
    for cname in ("conv1", "conv2"):
        _conv_bn_relu(sd, f"{prefix}.{cname}", p[cname], s.get(cname, {}))
    for gate in ("attention1", "attention2"):
        if gate in p:
            _scse(sd, f"{prefix}.{gate}.attention", p[gate]["SCSEModule_0"])


def unet_decoder_from_flax(params: Dict[str, Any], stats: Dict[str, Any],
                           prefix: str = "decoder") -> StateDict:
    """Inverse of convert_unet_decoder: ``block{i}/conv{1,2}/{conv,bn}`` ->
    smp's ``{prefix}.blocks.{i}.conv{1,2}.{0,1}``; also the scse gates and the
    VGG center block (``center/conv{1,2}`` -> ``{prefix}.center.{0,1}``),
    which convert_unet_decoder does not read."""
    sd: StateDict = {}
    i = 0
    while f"block{i}" in params:
        _decoder_block(sd, f"{prefix}.blocks.{i}", params[f"block{i}"],
                       stats.get(f"block{i}", {}))
        i += 1
    if "center" in params:
        for j, cname in enumerate(("conv1", "conv2")):
            _conv_bn_relu(sd, f"{prefix}.center.{j}", params["center"][cname],
                          stats["center"].get(cname, {}))
    return sd


def unetseg_from_flax(params: Dict[str, Any], batch_stats: Dict[str, Any]) -> StateDict:
    """JAX UnetSeg / SegCD / FFCTLCD (params, batch_stats) -> the port's
    state_dict; ``convert_unetseg`` of the result gives the inputs back."""
    sd = resnet_from_flax(params["encoder"], batch_stats["encoder"], "encoder.")
    sd.update(unet_decoder_from_flax(params["decoder"], batch_stats["decoder"]))
    _conv_b(sd, "segmentation_head.0", params["segmentation_head"]["conv"])
    return sd


def _bit_transformer_from_flax(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    """Inverse of _bit_transformer (:374-401)."""
    i = 0
    while f"attn{i}" in p:
        a, f = f"{prefix}.layers.{i}.0.fn", f"{prefix}.layers.{i}.1.fn"
        _ln(sd, f"{a}.norm", p[f"norm_attn{i}"])
        attn = p[f"attn{i}"]
        for name in ("to_qkv", "to_q", "to_k", "to_v"):
            if name in attn:
                _linear(sd, f"{a}.fn.{name}", attn[name])
        _linear(sd, f"{a}.fn.to_out.0", attn["to_out"])
        _ln(sd, f"{f}.norm", p[f"norm_ff{i}"])
        _linear(sd, f"{f}.fn.net.0", p[f"ff{i}"]["Dense_0"])
        _linear(sd, f"{f}.fn.net.3", p[f"ff{i}"]["Dense_1"])
        i += 1


def bit_from_flax(params: Dict[str, Any], batch_stats: Dict[str, Any]) -> StateDict:
    """JAX BASETransformer / ResNetCD (params, batch_stats) -> the port's
    state_dict under the original BIT's names; ``convert_bit`` of the result
    gives the inputs back."""
    bb = params["backbone"]
    sd = resnet_from_flax(bb["ResNetEncoder_0"],
                          batch_stats["backbone"]["ResNetEncoder_0"], "resnet.")
    _conv_b(sd, "conv_pred", bb["conv_pred"])
    cls = params["classifier"]
    sd["classifier.0.weight"] = _conv_w(cls["conv1"]["kernel"])
    _bn(sd, "classifier.1", cls["bn"], batch_stats["classifier"]["bn"])
    _conv_b(sd, "classifier.3", cls["conv2"])
    if "conv_a" in params:
        sd["conv_a.weight"] = _conv_w(params["conv_a"]["kernel"])
    if "pos_embedding" in params:
        sd["pos_embedding"] = _t(params["pos_embedding"])
    if "pos_embedding_decoder" in params:  # (1, H, W, C) -> (1, C, H, W)
        sd["pos_embedding_decoder"] = _t(np.transpose(
            np.asarray(params["pos_embedding_decoder"]), (0, 3, 1, 2)))
    for name in ("transformer", "transformer_decoder"):
        if name in params:
            _bit_transformer_from_flax(sd, name, params[name])
    return sd


# --- the bespoke zoo: FC-Siam, SNUNet, DTCDSCN, DSIFN, CDNet, ChangeVIG ---

def _convT_s1_w(k) -> torch.Tensor:
    """Inverse of _convT_s1_as_conv (:247-256): the flax conv HWIO kernel of
    a stride-1 ConvTranspose2d back to torch (I, O, kH, kW), unflipped."""
    w = np.transpose(np.asarray(k), (2, 3, 0, 1))
    return _t(np.flip(w, (2, 3)))


def _conv_bn_pair(sd: StateDict, conv_prefix: str, bn_prefix: str, p: dict, s: dict,
                  conv_key: str = "conv", bn_key: str = "bn", weight=_conv_w) -> None:
    """A conv (``p[conv_key]``, kernel through ``weight``) and its BatchNorm."""
    sd[f"{conv_prefix}.weight"] = weight(p[conv_key]["kernel"])
    _put_bias(sd, conv_prefix, p[conv_key])
    _bn(sd, bn_prefix, p[bn_key], s[bn_key])


def siam_unet_from_flax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                        fusion: str = "diff") -> StateDict:
    """Inverse of convert_siam_unet (:261-320), every fusion mode: the
    encoder's ``conv{s}{i}``/``bn{s}{i}``, the ``upconv*`` transposed convs,
    the decoder's stride-1 transposed ``conv*d`` (their flax kernels are
    flipped and IO-swapped) and, for crossconc, ``cross_conc{1..4}``."""
    sd: StateDict = {}
    enc_p, enc_s = params["encoder"], batch_stats["encoder"]
    for name in enc_p:
        _conv_bn_pair(sd, name, "bn" + name[len("conv"):], enc_p[name], enc_s[name])
    for name, p in params.items():
        if name.startswith("upconv"):
            _conv_b(sd, name, p["ConvTranspose_0"])
        elif name.endswith("d") and name.startswith("conv") and name != "conv11d":
            _conv_bn_pair(sd, name, "bn" + name[len("conv"):], p, batch_stats[name],
                          weight=_convT_s1_w)
    sd["conv11d.weight"] = _convT_s1_w(params["conv11d"]["kernel"])
    sd["conv11d.bias"] = _t(params["conv11d"]["bias"])
    if fusion == "crossconc":
        for s in range(1, 5):
            base = f"cross_conc{s}"
            p, st = params[base], batch_stats[base]
            _conv_bn_pair(sd, f"{base}.diff.0", f"{base}.diff.1", p, st, "diff_conv",
                          "diff_bn")
            _conv_bn_pair(sd, f"{base}.conv_res.0", f"{base}.conv_res.1", p, st, "res_conv",
                          "res_bn")
    return sd


def snunet_from_flax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                     ecam: bool = True) -> StateDict:
    """Inverse of convert_snunet (:323-358): SNUNetECAM (``ecam``) or
    SiamNestedUNetConc."""
    sd: StateDict = {}
    for name, p in params["body"].items():
        if name.startswith("Up"):
            _conv_b(sd, f"{name}.up", p["ConvTranspose_0"])
            continue
        for j in (1, 2):
            _conv_bn_pair(sd, f"{name}.conv{j}", f"{name}.bn{j}", p,
                          batch_stats["body"][name], f"conv{j}", f"bn{j}")
    if ecam:
        for att in ("ca", "ca1"):
            for fc in ("fc1", "fc2"):
                sd[f"{att}.{fc}.weight"] = _conv_w(params[att][fc]["kernel"])
    else:
        for i in (1, 2, 3, 4):
            _conv_b(sd, f"final{i}", params[f"final{i}"])
    _conv_b(sd, "conv_final", params["conv_final"])
    return sd


def dtcdscn_from_flax(params: Dict[str, Any], batch_stats: Dict[str, Any]) -> StateDict:
    """Inverse of convert_dtcdscn (:496-546): the live CD path of CDNet34."""
    sd: StateDict = {"firstconv.weight": _conv_w(params["firstconv"]["kernel"])}
    _bn(sd, "firstbn", params["firstbn"], batch_stats["firstbn"])
    for k in (1, 2, 3, 4):
        lp, ls = params[f"encoder{k}"], batch_stats[f"encoder{k}"]
        for bname, bp in lp.items():
            base = f"encoder{k}.{int(bname[len('block'):])}"
            bs = ls[bname]
            for j in (1, 2):
                _conv_bn_pair(sd, f"{base}.conv{j}", f"{base}.bn{j}", bp, bs, f"conv{j}",
                              f"bn{j}")
            sd[f"{base}.se.fc.0.weight"] = _dense_w(bp["se"]["fc1"]["kernel"])
            sd[f"{base}.se.fc.2.weight"] = _dense_w(bp["se"]["fc2"]["kernel"])
            if "down_conv" in bp:
                _conv_bn_pair(sd, f"{base}.downsample.0", f"{base}.downsample.1", bp, bs,
                              "down_conv", "down_bn")
    for i in (1, 2, 3, 4):
        _conv_b(sd, f"dblock_master.dilate{i}", params["dblock_master"][f"dilate{i}"])
    for k in (1, 2, 3, 4):
        base = f"decoder{k}_master"
        dp, ds = params[base], batch_stats[base]
        _conv_b(sd, f"{base}.conv1", dp["conv1"])
        _conv_b(sd, f"{base}.conv3", dp["conv3"])
        scse = dp["scse"]
        sd[f"{base}.scse.channel_excitation.0.weight"] = _conv_w(scse["ce1"]["kernel"])
        sd[f"{base}.scse.channel_excitation.2.weight"] = _conv_w(scse["ce2"]["kernel"])
        sd[f"{base}.scse.spatial_se.0.weight"] = _conv_w(scse["se"]["kernel"])
        _conv_b(sd, f"{base}.deconv2", dp["deconv2"])
        for nm in ("norm1", "norm2", "norm3"):
            _bn(sd, f"{base}.{nm}", dp[nm], ds[nm])
    _conv_b(sd, "finaldeconv1_master", params["finaldeconv1_master"])
    _conv_b(sd, "finalconv2_master", params["finalconv2_master"])
    _conv_b(sd, "finalconv3_master", params["finalconv3_master"])
    return sd


# torchvision vgg16 .features indices of the 13 convs (torch_to_flax.py:74)
_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def vgg16_features_from_flax(params: Dict[str, Any], prefix: str = "") -> StateDict:
    """Inverse of convert_vgg16_features (:77-86): ``conv{i}`` ->
    ``{prefix}features.{torchvision index}``."""
    sd: StateDict = {}
    for ours, tv in enumerate(_VGG16_CONV_IDX):
        _conv_b(sd, f"{prefix}features.{tv}", params[f"conv{ours}"])
    return sd


def dsifn_from_flax(params: Dict[str, Any], batch_stats: Dict[str, Any]) -> StateDict:
    """Inverse of convert_dsifn (:549-585). The shared VGG16 base is written
    under both ``t1_base`` and ``t2_base``, as the reference's state_dict
    holds it; convert_dsifn reads ``t1_base``."""
    sd = vgg16_features_from_flax(params["base"], "t1_base.")
    sd.update({"t2_base." + k[len("t1_base."):]: v for k, v in list(sd.items())})
    for name, p in params.items():
        if name == "base":
            continue
        if "prelu" in p:  # o{k}_conv{j}: Conv -> PReLU -> BN -> Dropout
            _conv_b(sd, f"{name}.0", p["conv"])
            sd[f"{name}.1.weight"] = _t(p["prelu"])
            _bn(sd, f"{name}.2", p["bn"], batch_stats[name]["bn"])
        elif name.startswith("bn_sa"):
            _bn(sd, name, p, batch_stats[name])
        elif name.startswith("sa"):
            sd[f"{name}.conv1.weight"] = _conv_w(p["conv1"]["kernel"])
        elif name.startswith("ca"):
            for fc in ("fc1", "fc2"):
                sd[f"{name}.{fc}.weight"] = _conv_w(p[fc]["kernel"])
        elif name.startswith("trans_conv"):
            _conv_b(sd, name, p["ConvTranspose_0"])
        else:  # the 1-channel heads o1_conv3, o2_conv4 .. o5_conv4
            _conv_b(sd, name, p)
    return sd


def cdnet_from_flax(params: Dict[str, Any]) -> StateDict:
    """Inverse of convert_cdnet (:215-238): the CDNet head (no BatchNorm)."""
    sd: StateDict = {}
    _conv_b(sd, "AttBlock.block.0", params["att_conv"])
    se = params["att_se"]
    _linear(sd, "AttBlock.block.2.cSE.fc1", se["cSE"]["fc1"])
    _linear(sd, "AttBlock.block.2.cSE.fc2", se["cSE"]["fc2"])
    _conv_b(sd, "AttBlock.block.2.sSE.conv", se["sSE"]["conv"])
    _conv_b(sd, "cd1", params["cd1"])
    _conv_b(sd, "cd2", params["cd2"])
    return sd


def _conv1x1_w(k) -> torch.Tensor:
    """Inverse of _conv1x1_dense (:876-882): flax Dense (I, O) -> torch 1x1
    Conv2d (O, I, 1, 1)."""
    return _t(np.asarray(k).T[:, :, None, None])


def _seq_conv_bn(sd: StateDict, prefix: str, ic: int, ib: int, name: str, p: dict,
                 s: dict, dense: bool = False) -> None:
    """Inverse of _seq_conv_bn (:885-889): ``{name}_conv``/``{name}_bn`` ->
    the Sequential's ``{prefix}.{ic}`` and ``{prefix}.{ib}``."""
    _conv_bn_pair(sd, f"{prefix}.{ic}", f"{prefix}.{ib}", p, s, f"{name}_conv",
                  f"{name}_bn", weight=_conv1x1_w if dense else _conv_w)


def _grapher(sd: StateDict, prefix: str, p: dict, s: dict) -> None:
    """Inverse of _convert_grapher (:892-903)."""
    _seq_conv_bn(sd, f"{prefix}.fc1", 0, 1, "fc1", p, s, dense=True)
    _conv_bn_pair(sd, f"{prefix}.graph_conv.0", f"{prefix}.graph_conv.1", p["graph_conv"]["nn"],
                  s["graph_conv"]["nn"], weight=_conv1x1_w)
    _seq_conv_bn(sd, f"{prefix}.fc2", 0, 1, "fc2", p, s, dense=True)


def vig_backbone_from_flax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                           prefix: str = "encoder", blocks=(2, 2, 6, 2)) -> StateDict:
    """Inverse of _convert_vig_backbone (:906-935): VIGBackbone -> the
    ``{prefix}.stem`` / ``.pos_embed`` / ``.backbone.{i}`` names."""
    sd: StateDict = {}
    for name, ic, ib in (("c1", 0, 1), ("c2", 3, 4), ("c3", 6, 7)):
        _seq_conv_bn(sd, f"{prefix}.stem.convs", ic, ib, name, params["stem"],
                     batch_stats["stem"])
    sd[f"{prefix}.pos_embed"] = _t(np.transpose(np.asarray(params["pos_embed"]), (0, 3, 1, 2)))
    seq = idx = 0
    for i, nb in enumerate(blocks):
        if i > 0:
            _seq_conv_bn(sd, f"{prefix}.backbone.{seq}.conv", 0, 1, "c", params[f"down{i}"],
                         batch_stats[f"down{i}"])
            seq += 1
        for _ in range(nb):
            base = f"{prefix}.backbone.{seq}"
            _grapher(sd, f"{base}.0", params[f"grapher{idx}"], batch_stats[f"grapher{idx}"])
            fp, fs = params[f"ffn{idx}"], batch_stats[f"ffn{idx}"]
            _seq_conv_bn(sd, f"{base}.1.fc1", 0, 1, "fc1", fp, fs)
            _seq_conv_bn(sd, f"{base}.1.fc2", 0, 1, "fc2", fp, fs)
            idx += 1
            seq += 1
    return sd


def _fuse_block(sd: StateDict, prefix: str, p: dict, s: dict) -> None:
    """Inverse of _convert_fuse_block (:938-950): the optional ``diff``, then
    ``conv_res`` and the bottleneck ``conv``."""
    if "diff_conv" in p:
        _seq_conv_bn(sd, f"{prefix}.diff", 0, 1, "diff", p, s)
    _seq_conv_bn(sd, f"{prefix}.conv_res", 0, 1, "conv_res", p, s)
    for name, ic, ib in (("conv1", 0, 1), ("conv2", 3, 4), ("conv3", 6, 7)):
        _seq_conv_bn(sd, f"{prefix}.conv", ic, ib, name, p, s)


def _global_local(sd: StateDict, prefix: str, p: dict, s: dict) -> None:
    """Inverse of _convert_global_local (:953-964)."""
    for name in ("channel_conv", "spatial_conv") + tuple(f"local_conv{k}" for k in range(1, 6)):
        _conv_b(sd, f"{prefix}.{name}", p[name])
    for name in ("channel_bn", "local_bn"):
        _bn(sd, f"{prefix}.{name}", p[name], s[name])


def _final_head(sd: StateDict, prefix: str, p: dict) -> None:
    """Inverse of _convert_final_head (:1032-1040)."""
    for name in ("convd2x", "convd1x"):
        _upsample_conv(sd, f"{prefix}.{name}", p[name])
    for name in ("dense_2x", "dense_1x"):
        _residual_block(sd, f"{prefix}.{name}", p[name])
    _conv_b(sd, f"{prefix}.change_probability.conv2d", p["change_probability"])


def _decoder_v1(sd: StateDict, prefix: str, p: dict, s: dict) -> None:
    """Inverse of convert_changevig_decoder_v1 (:1043-1066)."""
    for k in (1, 2, 3, 4):
        _linear(sd, f"{prefix}.decoder_heads_c{k}.proj", p[f"linear_c{k}"])
        dc, ds = p[f"diff_c{k}"], s[f"diff_c{k}"]
        for j, off in ((0, 0), (1, 4)):
            _conv_b(sd, f"{prefix}.diff_c{k}.{off}", dc[f"conv{j}"])
            sd[f"{prefix}.diff_c{k}.{off + 1}.weight"] = _t(dc[f"prelu{j}"])
            _bn(sd, f"{prefix}.diff_c{k}.{off + 2}", dc[f"bn{j}"], ds[f"bn{j}"])
        mp = p[f"make_pred_c{k}"]
        _conv_b(sd, f"{prefix}.make_pred_c{k}.0", mp["conv1"])
        _bn(sd, f"{prefix}.make_pred_c{k}.2", mp["bn"], s[f"make_pred_c{k}"]["bn"])
        _conv_b(sd, f"{prefix}.make_pred_c{k}.3", mp["conv2"])
    _conv_bn_pair(sd, f"{prefix}.linear_fuse.0", f"{prefix}.linear_fuse.1", p, s,
                  "linear_fuse_conv", "linear_fuse_bn")


def _decoder_v2(sd: StateDict, prefix: str, p: dict, s: dict, mode: str) -> None:
    """Inverse of convert_changevig_decoder_v2 (:1069-1080) with _convert_hffm
    and _convert_vffm (:967-991)."""
    fuse = "cross_conc" if mode == "crossconc" else "diff"
    for k in (1, 2, 3, 4):
        hp, hs = p[f"hffm{k}"], s[f"hffm{k}"]
        _fuse_block(sd, f"{prefix}.hffm{k}.{fuse}", hp["fuse"], hs["fuse"])
        _global_local(sd, f"{prefix}.hffm{k}.global_local", hp["global_local"],
                      hs["global_local"])
    for k in (1, 2, 3):
        base, vp, vs = f"{prefix}.vffm{k}", p[f"vffm{k}"], s[f"vffm{k}"]
        _conv_b(sd, f"{base}.up.up", vp["up"])
        for branch, i0 in (("global_avg", 1), ("global_max", 1), ("local_att", 0)):
            _seq_conv_bn(sd, f"{base}.{branch}", i0, i0 + 1, f"{branch}_1", vp, vs)
            _seq_conv_bn(sd, f"{base}.{branch}", i0 + 3, i0 + 4, f"{branch}_2", vp, vs)


def _decoder_v20(sd: StateDict, prefix: str, p: dict, s: dict) -> None:
    """Inverse of convert_changevig_decoder_v20 (:1083-1100) with
    _convert_csam_v20 and _convert_aff (:994-1018)."""
    for k in (1, 2, 3, 4):
        _fuse_block(sd, f"{prefix}.diff_c{k}", p[f"diff_c{k}"], s[f"diff_c{k}"])
        base, cp, cs = f"{prefix}.csam{k}", p[f"csam{k}"], s[f"csam{k}"]
        for name in ("conv1_1", "conv2_1", "conv2_2"):
            _conv_b(sd, f"{base}.{name}", cp[name])
        for name in ("liner1", "liner2"):
            _linear(sd, f"{base}.{name}", cp[name])
        _bn(sd, f"{base}.batch_normal1", cp["bn1"], cs["bn1"])
        _bn(sd, f"{base}.bt", cp["bt"], cs["bt"])
    for k in (1, 2, 3):
        base, ap, as_ = f"{prefix}.aff{k}", p[f"aff{k}"], s[f"aff{k}"]
        for ours, ref, i0 in (("local1", "local_att", 0), ("local2", "local_att", 3),
                              ("global1", "global_att", 1), ("global2", "global_att", 4)):
            _seq_conv_bn(sd, f"{base}.{ref}", i0, i0 + 1, ours, ap, as_)
    for k in (2, 3, 4):
        _conv_b(sd, f"{prefix}.trans_conv{k}", p[f"trans_conv{k}"])


CHANGEVIG_MODELS = {"ChangeGNNV1": "gnn_v1", "ChangeGNNV2": "gnn_v2",
                    "ChangeGNNV2_sub": "gnn_v2_sub", "ChangeGNNV2_abs": "gnn_v2_abs",
                    "ChangeGNNV2_conc": "gnn_v2_conc", "GNN": "vig_v20_2"}


def changevig_from_flax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                        model: str, blocks=(2, 2, 6, 2)) -> StateDict:
    """Inverse of convert_changevig (:1103-1120); ``model`` is one of its
    names (gnn_v1, gnn_v2, gnn_v2_sub, gnn_v2_abs, gnn_v2_conc, vig_v20_2;
    ``CHANGEVIG_MODELS`` maps the define_G keys to them)."""
    enc, dec = ("VIG_x2", "TDec_x2") if model == "vig_v20_2" else ("encoder", "decoder")
    dec_key = "TDec_x2" if model == "vig_v20_2" else "decoder"
    sd = vig_backbone_from_flax(params["encoder"], batch_stats["encoder"], enc, blocks)
    p, s = params[dec_key], batch_stats[dec_key]
    if model == "vig_v20_2":
        _decoder_v20(sd, dec, p, s)
    elif model == "gnn_v1":
        _decoder_v1(sd, dec, p, s)
    else:
        mode = {"gnn_v2": "crossconc", "gnn_v2_sub": "sub", "gnn_v2_abs": "abs",
                "gnn_v2_conc": "conc"}[model]
        _decoder_v2(sd, dec, p, s, mode)
    _final_head(sd, dec, p["head"])
    return sd


# ---------------------------------------------------------------------------
# The smp assemblies of create_model (torch_to_flax.py:704-874, :1480-1504)
# ---------------------------------------------------------------------------

def vgg_from_flax(params: Dict[str, Any], stats: Dict[str, Any],
                  prefix: str = "") -> StateDict:
    """Inverse of convert_vgg (:1480-1504): VGGEncoder's ``conv{i}`` (and
    ``bn{i}`` in a ``_bn`` variant) -> torchvision's ``{prefix}features.{j}``.
    The indices follow from the stages, which are read from the kernels'
    output widths: 64, 128 and 256, then 512 in two stages as long as the
    256 one (torchvision's configs A, B, D and E)."""
    sd: StateDict = {}
    n = sum(1 for k in params if k.startswith("conv"))
    widths = [np.asarray(params[f"conv{i}"]["kernel"]).shape[-1] for i in range(n)]
    stage_len = widths.count(256)
    stage_of = [min(3 + (i - widths.index(512)) // stage_len, 4) if w == 512
                else (64, 128, 256).index(w) for i, w in enumerate(widths)]
    bn = "bn0" in params
    j = 0
    for i in range(n):
        if i > 0 and stage_of[i] != stage_of[i - 1]:
            j += 1  # the max pool between two stages
        _conv_b(sd, f"{prefix}features.{j}", params[f"conv{i}"])
        if bn:
            _bn(sd, f"{prefix}features.{j + 1}", params[f"bn{i}"], stats[f"bn{i}"])
        j += 3 if bn else 2
    return sd


def _encoder_from_flax(params: Dict[str, Any], stats: Dict[str, Any]) -> StateDict:
    """The ``encoder`` of any create_model arch, by its tree: MiT, VGG or ResNet."""
    if "mit" in params:
        return mit_encoder_from_flax(params["mit"], "encoder")
    if "conv0" in params:
        return vgg_from_flax(params, stats, "encoder.")
    return resnet_from_flax(params, stats, "encoder.")


def fpn_decoder_from_flax(params: Dict[str, Any], prefix: str = "decoder") -> StateDict:
    """Inverse of convert_fpn_decoder (:704-718)."""
    sd: StateDict = {}
    _conv_b(sd, f"{prefix}.p5", params["p5"])
    for name in ("p4", "p3", "p2"):
        _conv_b(sd, f"{prefix}.{name}.skip_conv", params[f"{name}_skip"])
    for i, n_up in enumerate((3, 2, 1, 0)):
        for j in range(max(n_up, 1)):
            p = params[f"seg{i}_{j}"]
            base = f"{prefix}.seg_blocks.{i}.block.{j}.block"
            _conv_b(sd, f"{base}.0", p["conv"])
            sd[f"{base}.1.weight"] = _t(p["gn"]["scale"])
            sd[f"{base}.1.bias"] = _t(p["gn"]["bias"])
    return sd


def psp_decoder_from_flax(params: Dict[str, Any], stats: Dict[str, Any],
                          prefix: str = "decoder") -> StateDict:
    """Inverse of convert_psp_decoder (:721-733)."""
    sd: StateDict = {}
    for i in range(4):
        _conv_bn_relu(sd, f"{prefix}.psp.blocks.{i}.pool.1", params[f"psp{i}"],
                      stats.get(f"psp{i}", {}))
    _conv_bn_relu(sd, f"{prefix}.conv", params["conv"], stats.get("conv", {}))
    return sd


def linknet_decoder_from_flax(params: Dict[str, Any], stats: Dict[str, Any],
                              prefix: str = "decoder") -> StateDict:
    """Inverse of convert_linknet_decoder (:736-754); the transposed conv's
    kernel goes back by _conv_w (the inverse of _convT_2x)."""
    sd: StateDict = {}
    i = 0
    while f"block{i}" in params:
        p, s = params[f"block{i}"], stats.get(f"block{i}", {})
        base = f"{prefix}.blocks.{i}.block"
        _conv_bn_relu(sd, f"{base}.0", p["conv1"], s.get("conv1", {}))
        _conv_b(sd, f"{base}.1.0", p["transpose"])
        if "transpose_bn" in p:
            _bn(sd, f"{base}.1.1", p["transpose_bn"], s["transpose_bn"])
        _conv_bn_relu(sd, f"{base}.2", p["conv2"], s.get("conv2", {}))
        i += 1
    return sd


def unetplusplus_decoder_from_flax(params: Dict[str, Any], stats: Dict[str, Any],
                                   prefix: str = "decoder") -> StateDict:
    """Inverse of convert_unetplusplus_decoder (:757-768): the nodes keep
    their ``x_{depth}_{layer}`` names under ``{prefix}.blocks``."""
    sd: StateDict = {}
    for node, p in params.items():
        _decoder_block(sd, f"{prefix}.blocks.{node}", p, stats.get(node, {}))
    return sd


def manet_decoder_from_flax(params: Dict[str, Any], stats: Dict[str, Any],
                            prefix: str = "decoder") -> StateDict:
    """Inverse of convert_manet_decoder (:771-795)."""
    sd: StateDict = {}
    c = params["center"]
    for ours, ref in (("top", "top_conv"), ("center", "center_conv"),
                      ("bottom", "bottom_conv"), ("out_conv", "out_conv")):
        _conv_b(sd, f"{prefix}.center.{ref}", c[ours])
    i = 0
    while f"block{i}" in params:
        p, s = params[f"block{i}"], stats.get(f"block{i}", {})
        base = f"{prefix}.blocks.{i}"
        if "hl1" in p:  # MFAB
            _conv_bn_relu(sd, f"{base}.hl_conv.0", p["hl1"], s.get("hl1", {}))
            _conv_bn_relu(sd, f"{base}.hl_conv.1", p["hl2"], s.get("hl2", {}))
            for ours, ref in (("se_hl", "SE_hl"), ("se_ll", "SE_ll")):
                _conv_b(sd, f"{base}.{ref}.1", p[ours]["fc1"])
                _conv_b(sd, f"{base}.{ref}.3", p[ours]["fc2"])
        _conv_bn_relu(sd, f"{base}.conv1", p["conv1"], s.get("conv1", {}))
        _conv_bn_relu(sd, f"{base}.conv2", p["conv2"], s.get("conv2", {}))
        i += 1
    return sd


def _separable(sd: StateDict, prefix: str, p: dict) -> None:
    _conv_b(sd, f"{prefix}.0", p["dw"])
    _conv_b(sd, f"{prefix}.1", p["pw"])


def _aspp(sd: StateDict, prefix: str, p: dict, s: dict) -> None:
    """Inverse of _aspp (:797-819), plain or separable by the tree."""
    _conv_b(sd, f"{prefix}.convs.0.0", p["b0_conv"])
    _bn(sd, f"{prefix}.convs.0.1", p["b0_bn"], s["b0_bn"])
    for i in (1, 2, 3):
        if f"b{i}" in p:  # separable
            _separable(sd, f"{prefix}.convs.{i}.0", p[f"b{i}"])
            _bn(sd, f"{prefix}.convs.{i}.1", p[f"b{i}"]["bn"], s[f"b{i}"]["bn"])
        else:
            _conv_b(sd, f"{prefix}.convs.{i}.0", p[f"b{i}_conv"])
            _bn(sd, f"{prefix}.convs.{i}.1", p[f"b{i}_bn"], s[f"b{i}_bn"])
    _conv_b(sd, f"{prefix}.convs.4.1", p["pool_conv"])
    _bn(sd, f"{prefix}.convs.4.2", p["pool_bn"], s["pool_bn"])
    _conv_b(sd, f"{prefix}.project.0", p["project_conv"])
    _bn(sd, f"{prefix}.project.1", p["project_bn"], s["project_bn"])


def deeplabv3_decoder_from_flax(params: Dict[str, Any], stats: Dict[str, Any],
                                prefix: str = "decoder") -> StateDict:
    """Inverse of convert_deeplabv3_decoder (:822-829)."""
    sd: StateDict = {}
    _aspp(sd, f"{prefix}.0", params["aspp"], stats["aspp"])
    _conv_b(sd, f"{prefix}.1", params["conv"])
    _bn(sd, f"{prefix}.2", params["bn"], stats["bn"])
    return sd


def deeplabv3plus_decoder_from_flax(params: Dict[str, Any], stats: Dict[str, Any],
                                    prefix: str = "decoder") -> StateDict:
    """Inverse of convert_deeplabv3plus_decoder (:832-846)."""
    sd: StateDict = {}
    _aspp(sd, f"{prefix}.aspp.0", params["aspp"], stats["aspp"])
    _separable(sd, f"{prefix}.aspp.1", params["aspp_sep"])
    _bn(sd, f"{prefix}.aspp.2", params["aspp_sep"]["bn"], stats["aspp_sep"]["bn"])
    _conv_b(sd, f"{prefix}.block1.0", params["block1_conv"])
    _bn(sd, f"{prefix}.block1.1", params["block1_bn"], stats["block1_bn"])
    _separable(sd, f"{prefix}.block2.0", params["block2"])
    _bn(sd, f"{prefix}.block2.1", params["block2"]["bn"], stats["block2"]["bn"])
    return sd


def pan_decoder_from_flax(params: Dict[str, Any], stats: Dict[str, Any],
                          prefix: str = "decoder") -> StateDict:
    """Inverse of convert_pan_decoder (:847-870)."""
    sd: StateDict = {}

    def cbr(name: str, p: dict, s: dict) -> None:
        _conv_b(sd, f"{prefix}.{name}.conv", p["conv"])
        _bn(sd, f"{prefix}.{name}.bn", p["bn"], s["bn"])

    fpa, fpa_s = params["fpa"], stats["fpa"]
    for ours, ref in (("branch1", "branch1.1"), ("mid", "mid.0"), ("down1", "down1.1"),
                      ("down2", "down2.1"), ("down3a", "down3.1"), ("down3b", "down3.2"),
                      ("conv1", "conv1"), ("conv2", "conv2")):
        cbr(f"fpa.{ref}", fpa[ours], fpa_s[ours])
    for k in (1, 2, 3):
        g, gs = params[f"gau{k}"], stats[f"gau{k}"]
        cbr(f"gau{k}.conv1.1", g["conv1"], gs["conv1"])
        cbr(f"gau{k}.conv2", g["conv2"], gs["conv2"])
    return sd


_DECODERS = {
    "unet": unet_decoder_from_flax, "unetseg": unet_decoder_from_flax,
    "segcd": unet_decoder_from_flax, "ffctlcd": unet_decoder_from_flax,
    "unetplusplus": unetplusplus_decoder_from_flax, "manet": manet_decoder_from_flax,
    "linknet": linknet_decoder_from_flax, "fpn": lambda p, s: fpn_decoder_from_flax(p),
    "pspnet": psp_decoder_from_flax, "deeplabv3": deeplabv3_decoder_from_flax,
    "deeplabv3plus": deeplabv3plus_decoder_from_flax, "pan": pan_decoder_from_flax,
}


def smp_model_from_flax(arch: str, params: Dict[str, Any],
                        batch_stats: Optional[Dict[str, Any]] = None) -> StateDict:
    """A JAX ``create_model(arch, ...)``'s (params, batch_stats) -> the port's
    state_dict for ``create_model(arch, ...)`` with the same settings: the
    encoder (ResNet/ResNeXt, VGG or MiT, told apart by the tree), the decoder,
    the segmentation head and Unet's classification head."""
    batch_stats = batch_stats or {}
    sd = _encoder_from_flax(params["encoder"], batch_stats.get("encoder", {}))
    sd.update(_DECODERS[arch.lower()](params["decoder"], batch_stats.get("decoder", {})))
    _conv_b(sd, "segmentation_head.0", params["segmentation_head"]["conv"])
    if "classification_head" in params:
        _linear(sd, "classification_head.3", params["classification_head"]["Dense_0"])
    return sd
