"""JAX variables -> the port's state_dict: the exact inverses of
stcd_tpu/convert/torch_to_flax.py::convert_changeformer_v6 and
_convert_mit_encoder (:458-493, :588-616), and of convert_resnet,
convert_unet_decoder and convert_unetseg (:39-70, :177-212), and of convert_bit
(:365-436).

It takes the nested dicts of arrays that flax holds (numpy or anything
``np.asarray`` reads) and returns a flat state_dict of CPU tensors under the
original reference's names, which ``ChangeFormerV6.load_state_dict`` takes
with ``strict=True`` (and so do UnetSeg, SegCD and FFCTLCD for
``unetseg_from_flax``). Each helper undoes one helper of the forward
converter.
"""

from __future__ import annotations

from typing import Any, Dict

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
    ``{prefix}.patch_embed*/block*/norm*`` subtree."""
    sd: StateDict = {}
    n_stages = sum(1 for key in enc if key.startswith("patch_embed"))
    for s in range(1, n_stages + 1):
        pe = enc[f"patch_embed{s}"]
        _conv_b(sd, f"{prefix}.patch_embed{s}.proj", pe["proj"])
        _ln(sd, f"{prefix}.patch_embed{s}.norm", pe["norm"])
        i = 0
        while f"block{s}_{i}" in enc:
            blk = enc[f"block{s}_{i}"]
            base = f"{prefix}.block{s}.{i}"
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
        _ln(sd, f"{prefix}.norm{s}", enc[f"norm{s}"])
    return sd


def changeformer_v6_from_flax(params: Dict[str, Any],
                              batch_stats: Dict[str, Any]) -> StateDict:
    """JAX ChangeFormerV6 (params, batch_stats) -> the port's state_dict;
    ``convert_changeformer_v6`` of the result gives the inputs back."""
    sd = mit_encoder_from_flax(params["Tenc_x2"], "Tenc_x2")
    dec, dst = params["TDec_x2"], batch_stats["TDec_x2"]
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
    _conv_b(sd, "TDec_x2.linear_fuse.0", dec["linear_fuse_conv"])
    _bn(sd, "TDec_x2.linear_fuse.1", dec["linear_fuse_bn"], dst["linear_fuse_bn"])
    for name in ("convd2x", "convd1x"):
        _conv_b(sd, f"TDec_x2.{name}.conv2d", dec[name]["ConvTranspose_0"])
    for name in ("dense_2x", "dense_1x"):
        _conv_b(sd, f"TDec_x2.{name}.0.conv1.conv2d", dec[name]["conv1"])
        _conv_b(sd, f"TDec_x2.{name}.0.conv2.conv2d", dec[name]["conv2"])
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


def unet_decoder_from_flax(params: Dict[str, Any], stats: Dict[str, Any],
                           prefix: str = "decoder") -> StateDict:
    """Inverse of convert_unet_decoder: ``block{i}/conv{1,2}/{conv,bn}`` ->
    smp's ``{prefix}.blocks.{i}.conv{1,2}.{0,1}``."""
    sd: StateDict = {}
    i = 0
    while f"block{i}" in params:
        for cname in ("conv1", "conv2"):
            p = params[f"block{i}"][cname]
            base = f"{prefix}.blocks.{i}.{cname}"
            _conv_b(sd, f"{base}.0", p["conv"])
            if "bn" in p:
                _bn(sd, f"{base}.1", p["bn"], stats[f"block{i}"][cname]["bn"])
        i += 1
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
