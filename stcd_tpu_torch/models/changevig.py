"""ChangeVIG, graph-neural-network change detection, on NCHW tensors
(counterpart of stcd_tpu/models/changevig.py:52-697).

- ``VIGBackbone``: the pyramid ViG encoder (Stem to 1/4, ``pos_embed``,
  stages of Grapher + FFN with a Downsample between them), tapped at the end
  of each stage (the taps {1, 4, 11, 14} of blocks (2, 2, 6, 2)); dilation
  ``min(idx // 4 + 1, 49 // k)``, neighbour pooling 4/2/1/1.
- the fusion blocks ``CrossConCat`` (= ``ConvDiffV20``), the sub/abs/conc
  fusions, ``GlobalLocal``, ``HFFM``, ``VFFM``, ``CSAMV20``, ``AFF``;
- the decoders ``DecoderV1``, ``DecoderV2`` (modes crossconc/sub/abs/conc)
  and ``DecoderVIGV20``;
- the ``define_G`` models ``ChangeGNNV1``, ``ChangeGNNV2``,
  ``ChangeGNNV2Compare`` and ``VIG`` (key ``GNN``), and ``pvig_ti/s/m/b``.

The state_dict names are those ``stcd_tpu/convert/torch_to_flax.py::
convert_changevig`` reads: ``encoder.stem.convs.0``, ``encoder.pos_embed``
(1, C, H/4, W/4), ``encoder.backbone.{i}`` (a Downsample's ``conv``, or a
block's ``0`` Grapher and ``1`` FFN), ``decoder.hffm1.cross_conc.diff.0``,
``decoder.vffm1.up.up``, ``TDec_x2.csam1.batch_normal1`` and so on; ``VIG``
keeps its encoder under ``VIG_x2`` and its decoder under ``TDec_x2``. The
Siamese encoder runs once on the 2N-batched pair, as in the JAX models.
``VIGBackbone.pipeline`` runs the encoder's stages as a GPipe over the
grid's stage axis (``parallel.pipeline``).
"""

from __future__ import annotations

import logging
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.layers.modules import resize_bilinear
from stcd_tpu_torch.layers.norm import BatchNorm
from stcd_tpu_torch.layers.stochastic import DropPath
from stcd_tpu_torch.models.changeformer import (MLP, ConvDiff, ConvLayer, MakePrediction,
                                                ResidualBlock, UpsampleConvLayer)
from stcd_tpu_torch.models.gcn_lib import Grapher, act_layer, linear_resize_matrix
from stcd_tpu_torch.models.snunet import Up

_PP_TRAIN_WARNED = False

VIG_CHANNELS = (80, 160, 400, 640)


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
             bias: bool = True, device=None) -> List[nn.Module]:
    """A 'same' conv and its BatchNorm, to splice into an ``nn.Sequential``."""
    return [nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=bias, device=device),
            BatchNorm(cout, device=device)]


class Stem(nn.Module):
    """conv s2 + BN + act, conv s2 + BN + act, conv + BN (``convs.0`` .. ``.7``)."""

    def __init__(self, in_dim: int = 3, out_dim: int = 80, act: str = "gelu", device=None):
        super().__init__()
        self.convs = nn.Sequential(*_conv_bn(in_dim, out_dim // 2, 3, 2, device=device),
                                   act_layer(act),
                                   *_conv_bn(out_dim // 2, out_dim, 3, 2, device=device),
                                   act_layer(act),
                                   *_conv_bn(out_dim, out_dim, 3, device=device))

    def forward(self, x):
        return self.convs(x)


class Downsample(nn.Module):
    """conv 3x3 s2 + BN (``conv.0``, ``conv.1``)."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.conv = nn.Sequential(*_conv_bn(in_dim, out_dim, 3, 2, device=device))

    def forward(self, x):
        return self.conv(x)


class FFN(nn.Module):
    """1x1 + BN -> act -> 1x1 + BN, DropPath, plus the input."""

    def __init__(self, channels: int, hidden: int, act: str = "gelu", drop_path: float = 0.0,
                 device=None):
        super().__init__()
        self.fc1 = nn.Sequential(*_conv_bn(channels, hidden, 1, device=device))
        self.act = act_layer(act)
        self.fc2 = nn.Sequential(*_conv_bn(hidden, channels, 1, device=device))
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        return self.drop_path(self.fc2(self.act(self.fc1(x)))) + x


def resize_linear_2d(x: torch.Tensor, size) -> torch.Tensor:
    """(N, C, h, w) -> (N, C, H, W) as ``jax.image.resize(..., "linear")``
    (anti-aliased when it downsizes); differentiable in ``x``."""
    wh = torch.from_numpy(linear_resize_matrix(x.shape[2], size[0])).to(x.device, x.dtype)
    ww = torch.from_numpy(linear_resize_matrix(x.shape[3], size[1])).to(x.device, x.dtype)
    return torch.einsum("nchw,hH,wW->ncHW", x, wh, ww)


class VIGBackbone(nn.Module):
    """Pyramid ViG encoder; ``forward(x)`` -> the 4 stage outputs at /4 /8
    /16 /32.

    ``pipeline`` (None: sequential) is ``{"n_micro": m}`` to run the stages
    as a heterogeneous GPipe over the grid's stage axis (its size the stage
    count, 4), each stage's output its aux (JAX's ``VIGBackbone._pipelined``,
    stcd_tpu/models/changevig.py:160-245). The stem and ``pos_embed`` run
    before the pipeline. Inside it the stages run in eval mode, BatchNorm on
    its running statistics and no DropPath, also in training: JAX's
    documented deviation (per-microbatch batch statistics would differ from
    the sequential ones anyway), of which training warns once. The decoder
    keeps train-mode BatchNorm."""

    def __init__(self, blocks: Sequence[int] = (2, 2, 6, 2),
                 channels: Sequence[int] = VIG_CHANNELS, k: int = 9, conv: str = "mr",
                 act: str = "gelu", drop_path_rate: float = 0.0, img_size: int = 256,
                 in_chans: int = 3, pipeline=None, device=None):
        super().__init__()
        self.pipeline = pipeline
        n_blocks = sum(blocks)
        dpr = [drop_path_rate * i / max(n_blocks - 1, 1) for i in range(n_blocks)]
        max_dilation = 49 // k
        reduce_ratios = (4, 2, 1, 1)
        self.stem = Stem(in_chans, channels[0], act, device=device)
        hw = img_size // 4
        self.pos_embed = nn.Parameter(torch.zeros(1, channels[0], hw, hw, device=device))
        layers: List[nn.Module] = []
        self.taps = []
        idx = 0
        for i, (nb, ch) in enumerate(zip(blocks, channels)):
            if i > 0:
                layers.append(Downsample(channels[i - 1], ch, device=device))
            for _ in range(nb):
                layers.append(nn.Sequential(
                    Grapher(ch, k, min(idx // 4 + 1, max_dilation), conv, act,
                            reduce_ratios[i], dpr[idx], device=device),
                    FFN(ch, ch * 4, act, dpr[idx], device=device)))
                idx += 1
            self.taps.append(len(layers) - 1)
        self.backbone = nn.ModuleList(layers)

    def stage_modules(self) -> List[nn.Module]:
        """The layers of each stage (a Downsample first after stage 0), one
        container a stage, built once and not registered."""
        if "_stages" not in self.__dict__:
            ends = [-1] + list(self.taps)
            self.__dict__["_stages"] = [nn.Sequential(*self.backbone[a + 1:b + 1])
                                        for a, b in zip(ends[:-1], ends[1:])]
        return self.__dict__["_stages"]

    def _pipelined(self, h: torch.Tensor) -> List[torch.Tensor]:
        from stcd_tpu_torch.parallel.pipeline import eval_mode, gpipe_hetero

        global _PP_TRAIN_WARNED
        if self.training and not _PP_TRAIN_WARNED:
            _PP_TRAIN_WARNED = True
            logging.getLogger(__name__).warning(
                "VIGBackbone.pipeline in training: the pipelined encoder stages run "
                "frozen-BN / no-DropPath (the JAX package's documented deviation); "
                "from-scratch pp training normalizes with init-valued running stats")
        mods = self.stage_modules()

        def fn(stage):
            def run(a):
                with eval_mode([stage]):
                    y = stage(a)
                return y, y
            return run

        _, feats = gpipe_hetero([fn(m) for m in mods], h,
                                n_micro=self.pipeline.get("n_micro") or len(mods),
                                collect_aux=True, stage_modules=mods)
        return list(feats)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = self.stem(x)
        pos = self.pos_embed
        if tuple(h.shape[2:]) != tuple(pos.shape[2:]):  # other input sizes
            pos = resize_linear_2d(pos, h.shape[2:])
        h = h + pos.to(h.dtype)
        if self.pipeline is not None:
            return self._pipelined(h)
        outs = []
        for i, layer in enumerate(self.backbone):
            h = layer(h)
            if i in self.taps:
                outs.append(h)
        return outs


class _Fuse(nn.Module):
    """Cross_ConCat (mode crossconc) and the Sub / Abs / Conc fusions
    (stcd_tpu/models/changevig.py:282-358): the pair's ``diff`` (crossconc:
    channel interleave + grouped 3x3 conv + BN + ReLU; conc: concat + 3x3
    conv + BN + ReLU; sub, abs: a - b, |a - b|), then ReLU(``conv_res`` +
    the 1x1 / 3x3 / 1x1 bottleneck ``conv``)."""

    def __init__(self, in_channels: int, out_channels: int, mode: str = "crossconc",
                 device=None):
        super().__init__()
        if mode not in ("crossconc", "sub", "abs", "conc"):
            raise ValueError(f"fusion mode {mode!r}: crossconc, sub, abs or conc")
        c, o2 = in_channels, out_channels // 2
        self.mode = mode
        if mode in ("crossconc", "conc"):
            groups = c if mode == "crossconc" else 1
            self.diff = nn.Sequential(*_conv_bn(2 * c, c, 3, groups=groups, device=device),
                                      nn.ReLU())
        self.conv_res = nn.Sequential(*_conv_bn(c, out_channels, 3, device=device))
        self.conv = nn.Sequential(*_conv_bn(c, o2, 1, device=device), nn.ReLU(),
                                  *_conv_bn(o2, o2, 3, device=device), nn.ReLU(),
                                  *_conv_bn(o2, out_channels, 1, device=device))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.mode == "crossconc":  # channels [a0, b0, a1, b1, ...]
            n, c, h, w = a.shape
            x = self.diff(torch.stack([a, b], dim=2).reshape(n, 2 * c, h, w))
        elif self.mode == "conc":
            x = self.diff(torch.cat([a, b], dim=1))
        elif self.mode == "sub":
            x = a - b
        else:
            x = torch.abs(a - b)
        return torch.relu(self.conv_res(x) + self.conv(x))


def CrossConCat(in_channels: int, out_channels: int, device=None) -> _Fuse:
    return _Fuse(in_channels, out_channels, "crossconc", device=device)


ConvDiffV20 = CrossConCat  # the reference's conv_diff_V20 is Cross_ConCat's math


def _pooled_stats(x: torch.Tensor) -> torch.Tensor:
    """(N, C, 2, 1): the spatial mean and max of each channel."""
    return torch.cat([x.mean((2, 3), keepdim=True), x.amax((2, 3), keepdim=True)], dim=2)


def _channel_stats(x: torch.Tensor) -> torch.Tensor:
    """(N, 2, H, W): the channel mean and max of each pixel."""
    return torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], dim=1)


class GlobalLocal(nn.Module):
    """sigmoid(channel gate * spatial gate) * x plus the local multi-kernel
    depthwise branch (stcd_tpu/models/changevig.py:361-393)."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.channel_conv = nn.Conv2d(c, c, (2, 1), groups=c, device=device)
        self.channel_bn = BatchNorm(c, device=device)
        self.spatial_conv = nn.Conv2d(2, 1, 5, padding=2, device=device)
        self.local_conv1 = nn.Conv2d(c, c, 1, groups=c, device=device)
        self.local_conv2 = nn.Conv2d(c, c, 3, padding=1, groups=c, device=device)
        self.local_conv3 = nn.Conv2d(c, c, 7, padding=3, groups=c, device=device)
        self.local_conv4 = nn.Conv2d(3 * c, c, 1, device=device)
        self.local_bn = BatchNorm(c, device=device)
        self.local_conv5 = nn.Conv2d(c, c, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ch = torch.relu(self.channel_bn(self.channel_conv(_pooled_stats(x))))
        sp = torch.relu(self.spatial_conv(_channel_stats(x)))
        gated = torch.sigmoid(ch * sp) * x
        loc = self.local_conv4(torch.cat([self.local_conv1(x), self.local_conv2(x),
                                          self.local_conv3(x)], dim=1))
        loc = self.local_conv5(torch.relu(self.local_bn(loc)))
        return gated + loc


class HFFM(nn.Module):
    """The pair's fusion (``cross_conc`` in mode crossconc, else ``diff``),
    then ``global_local``."""

    def __init__(self, in_channels: int, out_channels: int, mode: str = "crossconc",
                 device=None):
        super().__init__()
        fuse = _Fuse(in_channels, out_channels, mode, device=device)
        self.fuse_name = "cross_conc" if mode == "crossconc" else "diff"
        setattr(self, self.fuse_name, fuse)
        self.global_local = GlobalLocal(out_channels, device=device)

    def forward(self, a, b):
        return self.global_local(getattr(self, self.fuse_name)(a, b))


def _gate_branch(c: int, inter: int, pool: str = None, device=None) -> nn.Sequential:
    """[pool,] 1x1 + BN + ReLU + 1x1 + BN: the gates of VFFM and AFF."""
    head = {"avg": [nn.AdaptiveAvgPool2d(1)], "max": [nn.AdaptiveMaxPool2d(1)], None: []}[pool]
    return nn.Sequential(*head, *_conv_bn(c, inter, 1, device=device), nn.ReLU(),
                         *_conv_bn(inter, c, 1, device=device))


class VFFM(nn.Module):
    """Upsample the high level (``up.up``, ConvTranspose2d k2 s2), then the
    gate between the low and high levels (stcd_tpu/models/changevig.py:413-440)."""

    def __init__(self, c: int, r: int = 4, device=None):
        super().__init__()
        self.up = Up(c, device=device)
        self.global_avg = _gate_branch(c, c // r, "avg", device=device)
        self.global_max = _gate_branch(c, c // r, "max", device=device)
        self.local_att = _gate_branch(c, c // r, device=device)

    def forward(self, low, high):
        high = self.up(high)
        mixed = low + high
        wei = torch.sigmoid(self.global_avg(mixed) + self.global_max(mixed)
                            + self.local_att(mixed))
        return 2 * low * wei + 2 * high * (1 - wei)


class CSAMV20(nn.Module):
    """BN((sigmoid(channel MLP gate) + sigmoid(spatial gate)) * x)
    (stcd_tpu/models/changevig.py:446-474)."""

    def __init__(self, c: int, ratio: int = 8, device=None):
        super().__init__()
        self.conv1_1 = nn.Conv2d(c, c, (2, 1), groups=c, device=device)
        self.batch_normal1 = BatchNorm(c, device=device)
        self.liner1 = nn.Linear(c, c // ratio, bias=False, device=device)
        self.liner2 = nn.Linear(c // ratio, c, device=device)
        self.conv2_1 = nn.Conv2d(2, 1, 3, padding=1, bias=False, device=device)
        self.conv2_2 = nn.Conv2d(1, 1, 3, padding=1, bias=False, device=device)
        self.bt = BatchNorm(c, device=device)

    def forward(self, x):
        ch = F.gelu(self.batch_normal1(self.conv1_1(_pooled_stats(x))))  # (N, C, 1, 1)
        ch = self.liner2(torch.relu(self.liner1(ch[:, :, 0, 0])))[:, :, None, None]
        sp = self.conv2_2(torch.relu(self.conv2_1(_channel_stats(x))))
        return self.bt((torch.sigmoid(ch) + torch.sigmoid(sp)) * x)


class AFF(nn.Module):
    """Attentional feature fusion: 2 x wei + 2 r (1 - wei), wei from a local
    and a global gate of x + r."""

    def __init__(self, c: int, r: int = 4, device=None):
        super().__init__()
        self.local_att = _gate_branch(c, c // r, device=device)
        self.global_att = _gate_branch(c, c // r, "avg", device=device)

    def forward(self, x, residual):
        xa = x + residual
        wei = torch.sigmoid(self.local_att(xa) + self.global_att(xa))
        return 2 * x * wei + 2 * residual * (1 - wei)


class _FinalHead(nn.Module):
    """convd2x + dense_2x + convd1x + dense_1x + change_probability, held on
    the decoder itself (the reference's names)."""

    def _build_head(self, e: int, output_nc: int, device) -> None:
        self.convd2x = UpsampleConvLayer(e, e, device=device)
        self.dense_2x = nn.Sequential(ResidualBlock(e, device=device))
        self.convd1x = UpsampleConvLayer(e, e, device=device)
        self.dense_1x = nn.Sequential(ResidualBlock(e, device=device))
        self.change_probability = ConvLayer(e, output_nc, 3, 1, 1, device=device)

    def _head(self, x):
        x = self.dense_2x(self.convd2x(x))
        x = self.dense_1x(self.convd1x(x))
        return self.change_probability(x)


class DecoderV1(_FinalHead):
    """The ChangeFormerV5-style difference cascade
    (stcd_tpu/models/changevig.py:516-548); returns the 4 side predictions
    and the full-resolution one."""

    def __init__(self, in_channels: Sequence[int] = VIG_CHANNELS, embedding_dim: int = 256,
                 output_nc: int = 2, decoder_softmax: bool = False, device=None):
        super().__init__()
        e = embedding_dim
        self.decoder_softmax = decoder_softmax
        for k, c in enumerate(in_channels, start=1):
            setattr(self, f"decoder_heads_c{k}", MLP(c, e, device=device))
            setattr(self, f"diff_c{k}", ConvDiff(2 * e, e, device=device))
            setattr(self, f"make_pred_c{k}", MakePrediction(e, output_nc, device=device))
        self.linear_fuse = nn.Sequential(nn.Conv2d(4 * e, e, 1, device=device),
                                         BatchNorm(e, device=device))
        self._build_head(e, output_nc, device)

    def forward(self, f1, f2):
        size = tuple(f1[0].shape[2:])
        outs, ups, prev = [], [], None
        for s in (3, 2, 1, 0):
            proj = getattr(self, f"decoder_heads_c{s + 1}")
            d = getattr(self, f"diff_c{s + 1}")(torch.cat([proj(f1[s]), proj(f2[s])], dim=1))
            if prev is not None:
                d = d + resize_bilinear(prev, (prev.shape[2] * 2, prev.shape[3] * 2))
            outs.append(getattr(self, f"make_pred_c{s + 1}")(d))
            ups.append(d if s == 0 else resize_bilinear(d, size))
            prev = d
        outs.append(self._head(self.linear_fuse(torch.cat(ups, dim=1))))
        return [torch.sigmoid(o) for o in outs] if self.decoder_softmax else outs


class DecoderV2(_FinalHead):
    """HFFM at every level, then the VFFM cascade (mode crossconc: ChangeGNNV2;
    sub / abs / conc: ChangeGNNV2Compare); returns [prediction]."""

    def __init__(self, in_channels: Sequence[int] = VIG_CHANNELS, embedding_dim: int = 256,
                 output_nc: int = 2, decoder_softmax: bool = False, mode: str = "crossconc",
                 device=None):
        super().__init__()
        e = embedding_dim
        self.decoder_softmax = decoder_softmax
        for k, c in enumerate(in_channels, start=1):
            setattr(self, f"hffm{k}", HFFM(c, e, mode, device=device))
        for k in (1, 2, 3):
            setattr(self, f"vffm{k}", VFFM(e, device=device))
        self._build_head(e, output_nc, device)

    def forward(self, f1, f2):
        h4 = self.hffm4(f1[3], f2[3])
        h3 = self.hffm3(f1[2], f2[2])
        h2 = self.hffm2(f1[1], f2[1])
        h1 = self.hffm1(f1[0], f2[0])
        c = self.vffm1(h1, self.vffm2(h2, self.vffm3(h3, h4)))
        cp = self._head(c)
        return [torch.sigmoid(cp) if self.decoder_softmax else cp]


class DecoderVIGV20(_FinalHead):
    """conv_diff_V20 + CSAM at every level, transposed-conv upsampling and the
    AFF cascade (stcd_tpu/models/changevig.py:576-607); returns [prediction]."""

    def __init__(self, in_channels: Sequence[int] = VIG_CHANNELS, embedding_dim: int = 256,
                 output_nc: int = 2, decoder_softmax: bool = False, device=None):
        super().__init__()
        e = embedding_dim
        self.decoder_softmax = decoder_softmax
        for k, c in enumerate(in_channels, start=1):
            setattr(self, f"diff_c{k}", ConvDiffV20(c, e, device=device))
            setattr(self, f"csam{k}", CSAMV20(e, device=device))
        for k in (1, 2, 3):
            setattr(self, f"aff{k}", AFF(e, device=device))
        for k in (2, 3, 4):
            setattr(self, f"trans_conv{k}", nn.ConvTranspose2d(e, e, 2, stride=2,
                                                               device=device))
        self._build_head(e, output_nc, device)

    def _level(self, k, f1, f2):
        return getattr(self, f"csam{k}")(getattr(self, f"diff_c{k}")(f1[k - 1], f2[k - 1]))

    def forward(self, f1, f2):
        c4 = self.trans_conv4(self._level(4, f1, f2))
        c3 = self.trans_conv3(self.aff3(self._level(3, f1, f2), c4))
        c2 = self.trans_conv2(self.aff2(self._level(2, f1, f2), c3))
        c1 = self.aff1(self._level(1, f1, f2), c2)
        cp = self._head(c1)
        return [torch.sigmoid(cp) if self.decoder_softmax else cp]


class _VIGSiam(nn.Module):
    """The ViG encoder (channels 80/160/400/640) on the 2N-batched pair and a
    decoder of width ``embed_dim``."""

    encoder_name, decoder_name = "encoder", "decoder"

    def __init__(self, decoder: nn.Module, img_size: int = 256, device=None):
        super().__init__()
        setattr(self, self.encoder_name, VIGBackbone((2, 2, 6, 2), VIG_CHANNELS,
                                                     img_size=img_size, device=device))
        setattr(self, self.decoder_name, decoder)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> List[torch.Tensor]:
        n = x1.shape[0]
        feats = getattr(self, self.encoder_name)(torch.cat([x1, x2], dim=0))
        return getattr(self, self.decoder_name)([f[:n] for f in feats],
                                                [f[n:] for f in feats])


class ChangeGNNV1(_VIGSiam):
    def __init__(self, output_nc: int = 2, embed_dim: int = 256,
                 decoder_softmax: bool = False, img_size: int = 256, device=None):
        super().__init__(DecoderV1(VIG_CHANNELS, embed_dim, output_nc, decoder_softmax,
                                   device=device), img_size, device)


class ChangeGNNV2(_VIGSiam):
    def __init__(self, output_nc: int = 2, embed_dim: int = 256,
                 decoder_softmax: bool = False, img_size: int = 256, device=None):
        super().__init__(DecoderV2(VIG_CHANNELS, embed_dim, output_nc, decoder_softmax,
                                   "crossconc", device=device), img_size, device)


class ChangeGNNV2Compare(_VIGSiam):
    def __init__(self, output_nc: int = 2, embed_dim: int = 256,
                 decoder_softmax: bool = False, img_size: int = 256, diff_mode: str = "sub",
                 device=None):
        super().__init__(DecoderV2(VIG_CHANNELS, embed_dim, output_nc, decoder_softmax,
                                   diff_mode, device=device), img_size, device)


class VIG(_VIGSiam):
    """VIG_V20_2 (``define_G("GNN")``)."""

    encoder_name, decoder_name = "VIG_x2", "TDec_x2"

    def __init__(self, output_nc: int = 2, embed_dim: int = 256,
                 decoder_softmax: bool = False, img_size: int = 256, device=None):
        super().__init__(DecoderVIGV20(VIG_CHANNELS, embed_dim, output_nc, decoder_softmax,
                                       device=device), img_size, device)


def pvig_ti(img_size=224, device=None):
    return VIGBackbone((2, 2, 6, 2), (48, 96, 240, 384), img_size=img_size, device=device)


def pvig_s(img_size=224, device=None):
    return VIGBackbone((2, 2, 6, 2), (80, 160, 400, 640), img_size=img_size, device=device)


def pvig_m(img_size=224, device=None):
    return VIGBackbone((2, 2, 16, 2), (96, 192, 384, 768), img_size=img_size, device=device)


def pvig_b(img_size=224, device=None):
    return VIGBackbone((2, 2, 18, 2), (128, 256, 512, 1024), img_size=img_size, device=device)
