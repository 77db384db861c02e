"""ChangeFormer V1-V6 in PyTorch (counterpart of
stcd_tpu/models/changeformer.py, sequential paths).

The modules keep the original reference's state_dict names
(ref models/ChangeFormer.py), the names ``stcd_tpu/convert/torch_to_flax.py``
reads: ``Tenc_x2.block1.0.attn.q.weight``, ``TDec_x2.diff_c1.0.weight``,
``TDec_x2.convd2x.conv2d.weight``, ``Tenc.block1.0.attn.q.weight``,
``convproj.dense_4.0.conv1.conv2d.weight`` and so on. Modules the reference
builds but never calls in its forward (the ``patch_block*`` / ``pnorm*`` of its
encoders, V4's ``convd1x`` and ``dense_1x``) are not built, as in the JAX
package, so a reference state_dict loads with those keys dropped. Inside an
encoder stage the activations are tokens (B, H*W, C) in row-major pixel order,
as in the reference; between stages and in the decoders they are NCHW.

Numerics follow the JAX package: LayerNorm eps 1e-5 in the patch embeds and
the SRA norm and 1e-6 in the blocks and stage norms (1e-5 throughout V4's
encoder); exact GELU; BatchNorm with the JAX semantics (``layers/norm.py``);
the SRA product goes through ``ops.attention.cross_attention`` (the CUDA
kernels on a CUDA tensor, in both directions). Train-mode randomness
(dropout, DropPath, the attention mask's seeds) is drawn from one explicit
generator: ``layers/stochastic.py``.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.layers.modules import resize_bilinear
from stcd_tpu_torch.layers.norm import BatchNorm
from stcd_tpu_torch.layers.stochastic import Dropout, DropPath, Stochastic, draw_seed
from stcd_tpu_torch.ops.attention import cross_attention


class OverlapPatchEmbed(nn.Module):
    """Conv k=patch s=stride pad=patch//2, then LayerNorm (eps 1e-5, ref :195-236).
    NCHW in, (tokens, H, W) out."""

    def __init__(self, patch_size: int, stride: int, in_chans: int, embed_dim: int,
                 device=None):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride,
                              patch_size // 2, device=device)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5, device=device)

    def forward(self, x):
        x = self.proj(x)
        _, _, h, w = x.shape
        return self.norm(x.flatten(2).transpose(1, 2)), h, w


class DWConv(nn.Module):
    """Depthwise 3x3 conv over tokens (ref :512-523)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim, device=device)

    def forward(self, x, h, w):
        b, n, c = x.shape
        x = self.dwconv(x.transpose(1, 2).reshape(b, c, h, w))
        return x.flatten(2).transpose(1, 2)


class MixFFN(nn.Module):
    """fc1 -> DWConv -> exact GELU -> fc2, with dropout (ref :260-295)."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.dwconv = DWConv(hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)
        self.drop = Dropout(drop)

    def forward(self, x, h, w):
        x = F.gelu(self.dwconv(self.fc1(x), h, w))
        return self.drop(self.fc2(self.drop(x)))


class SRAttention(Stochastic):
    """Spatial-reduction attention (ref :298-358): queries from every token,
    keys and values from an sr-strided conv + LayerNorm (eps 1e-5). In
    training with ``attn_drop > 0`` each call draws one uint32 seed for the
    attention kernel's hash mask from ``self.generator``, on the device."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.attn_drop = attn_drop
        self.scale = (dim // num_heads) ** -0.5
        self.q = nn.Linear(dim, dim, bias=qkv_bias, device=device)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.proj_drop = Dropout(proj_drop)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio, device=device)
            self.norm = nn.LayerNorm(dim, eps=1e-5, device=device)

    def forward(self, x, h, w):
        b, n, c = x.shape
        hd = c // self.num_heads
        q = self.q(x).reshape(b, n, self.num_heads, hd).transpose(1, 2)
        if self.sr_ratio > 1:
            kv_in = self.sr(x.transpose(1, 2).reshape(b, c, h, w))
            kv_in = self.norm(kv_in.flatten(2).transpose(1, 2))
        else:
            kv_in = x
        kv = self.kv(kv_in).reshape(b, -1, 2, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        if self.training and self.attn_drop > 0.0:
            seed = draw_seed(self.generator, x.device)
            rate = self.attn_drop
        else:
            seed, rate = None, 0.0
        out = cross_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              scale=self.scale, dropout_rate=rate, dropout_seed=seed)
        out = out.transpose(1, 2).reshape(b, n, c)
        return self.proj_drop(self.proj(out))


class Block(nn.Module):
    """Pre-norm SRA + MixFFN with DropPath (ref :505-510)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4, sr_ratio: int = 1,
                 qkv_bias: bool = True, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, norm_eps: float = 1e-6, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps, device=device)
        self.attn = SRAttention(dim, num_heads, sr_ratio, qkv_bias, attn_drop, drop,
                                device=device)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps, device=device)
        self.mlp = MixFFN(dim, dim * mlp_ratio, drop, device=device)

    def forward(self, x, h, w):
        x = x + self.drop_path(self.attn(self.norm1(x), h, w))
        return x + self.drop_path(self.mlp(self.norm2(x), h, w))


class SegFormerEncoder(nn.Module):
    """The MiT encoder of V6 (EncoderTransformer_v3, ref :1342-1473),
    sequential path. NCHW in, one NCHW map per stage out."""

    def __init__(self, in_chans: int = 3, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 depths: Sequence[int] = (3, 3, 4, 3),
                 num_heads: Sequence[int] = (1, 2, 4, 8),
                 mlp_ratios: Sequence[int] = (4, 4, 4, 4),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1), first_patch: int = 7,
                 first_stride: int = 4, patch_size: int = 7, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, norm_eps: float = 1e-6, device=None):
        super().__init__()
        self.depths = tuple(depths)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        cur = 0
        prev = in_chans
        for s, (dim, depth) in enumerate(zip(embed_dims, depths), start=1):
            patch = first_patch if s == 1 else patch_size
            stride = first_stride if s == 1 else 2
            setattr(self, f"patch_embed{s}",
                    OverlapPatchEmbed(patch, stride, prev, dim, device=device))
            setattr(self, f"block{s}", nn.ModuleList([
                Block(dim, num_heads[s - 1], mlp_ratios[s - 1], sr_ratios[s - 1],
                      qkv_bias, drop_rate, attn_drop_rate, dpr[cur + i], norm_eps,
                      device=device)
                for i in range(depth)]))
            setattr(self, f"norm{s}", nn.LayerNorm(dim, eps=norm_eps, device=device))
            cur += depth
            prev = dim

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        b = x.shape[0]
        for s in range(1, len(self.depths) + 1):
            x, h, w = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                x = blk(x, h, w)
            x = getattr(self, f"norm{s}")(x)
            x = x.transpose(1, 2).reshape(b, -1, h, w)
            outs.append(x)
        return outs


class ConvDiff(nn.Sequential):
    """conv_diff (ref :1138-1149): 2x (Conv3x3 -> PReLU -> BN -> Dropout 0.6).
    Reference indices .0 .1 .2 (.3) .4 .5 .6 (.7)."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, device=device),
            nn.PReLU(1, 0.25, device=device),
            BatchNorm(out_channels, device=device),
            Dropout(0.6),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, device=device),
            nn.PReLU(1, 0.25, device=device),
            BatchNorm(out_channels, device=device),
            Dropout(0.6))


class MakePrediction(nn.Sequential):
    """make_prediction (ref :1151-1157): Conv -> ReLU -> BN -> Conv."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, device=device),
            nn.ReLU(),
            BatchNorm(out_channels, device=device),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, device=device))


class ConvLayer(nn.Module):
    """ChangeFormerBaseNetworks ConvLayer: a Conv2d named ``conv2d``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int, device=None):
        super().__init__()
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                                padding, device=device)

    def forward(self, x):
        return self.conv2d(x)


class UpsampleConvLayer(nn.Module):
    """ConvTranspose2d(k=4, s=2, p=1): an exact 2x (ref BaseNetworks :98-105).
    Equal to flax ConvTranspose with padding (2, 2) and transpose_kernel."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.conv2d = nn.ConvTranspose2d(in_channels, out_channels, 4, 2, 1,
                                         device=device)

    def forward(self, x):
        return self.conv2d(x)


class ResidualBlock(nn.Module):
    """x + 0.1 * conv2(relu(conv1(x))) (ref BaseNetworks :108-120)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv1 = ConvLayer(channels, channels, 3, 1, 1, device=device)
        self.conv2 = ConvLayer(channels, channels, 3, 1, 1, device=device)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x))) * 0.1


class MLP(nn.Module):
    """Per-pixel linear projection of an NCHW map (ref :677-688, ``.proj``)."""

    def __init__(self, input_dim: int, embed_dim: int, device=None):
        super().__init__()
        self.proj = nn.Linear(input_dim, embed_dim, device=device)

    def forward(self, x):
        return self.proj(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _up2_bilinear(x):
    return resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2), align_corners=False)


class DecoderTransformerV3(nn.Module):
    """DecoderTransformer_v3 (ref :1475-1631): per-scale projection, conv_diff
    of the concatenated pair plus the 2x-upsampled deeper difference, four
    side predictions, a 4-scale fuse, two 2x transposed-conv ups with
    residual blocks, and the change_probability head. Returns the 5
    multi-scale outputs, the full-resolution one last."""

    def __init__(self, in_channels: Sequence[int] = (64, 128, 320, 512),
                 embedding_dim: int = 64, output_nc: int = 2,
                 decoder_softmax: bool = False, device=None):
        super().__init__()
        e = embedding_dim
        self.decoder_softmax = decoder_softmax
        for s, c in enumerate(in_channels, start=1):
            setattr(self, f"linear_c{s}", MLP(c, e, device=device))
        for s in range(len(in_channels), 0, -1):
            setattr(self, f"diff_c{s}", ConvDiff(2 * e, e, device=device))
        for s in range(len(in_channels), 0, -1):
            setattr(self, f"make_pred_c{s}", MakePrediction(e, output_nc, device=device))
        self.linear_fuse = nn.Sequential(
            nn.Conv2d(len(in_channels) * e, e, 1, device=device),
            BatchNorm(e, device=device))
        self.convd2x = UpsampleConvLayer(e, e, device=device)
        self.dense_2x = nn.Sequential(ResidualBlock(e, device=device))
        self.convd1x = UpsampleConvLayer(e, e, device=device)
        self.dense_1x = nn.Sequential(ResidualBlock(e, device=device))
        self.change_probability = ConvLayer(e, output_nc, 3, 1, 1, device=device)

    def forward(self, f1: Sequence[torch.Tensor], f2: Sequence[torch.Tensor]):
        target_hw = f1[0].shape[2:]
        outs, ups = [], []
        prev = None
        for s in range(len(f1) - 1, -1, -1):
            proj = getattr(self, f"linear_c{s + 1}")
            d = getattr(self, f"diff_c{s + 1}")(torch.cat([proj(f1[s]), proj(f2[s])], 1))
            if prev is not None:
                d = d + _up2_bilinear(prev)
            outs.append(getattr(self, f"make_pred_c{s + 1}")(d))
            ups.append(d if s == 0 else resize_bilinear(d, target_hw))
            prev = d
        x = self.linear_fuse(torch.cat(ups, 1))
        x = self.dense_2x(self.convd2x(x))
        x = self.dense_1x(self.convd1x(x))
        outs.append(self.change_probability(x))
        if self.decoder_softmax:
            outs = [torch.sigmoid(o) for o in outs]
        return outs


class DecoderTransformerX2(nn.Module):
    """DecoderTransformer_x2 (ref :1159-1306) as ChangeFormerV4 calls it: five
    scales, the 2x-upsampled deeper difference concatenated (not added) into
    the next conv_diff, five side predictions, a 1x1 fuse, one 2x transposed-conv
    up with a residual block, and the change_probability head. Returns the 6
    multi-scale outputs, the full-resolution one last."""

    def __init__(self, in_channels: Sequence[int] = (32, 64, 128, 320, 512),
                 embedding_dim: int = 256, output_nc: int = 2,
                 decoder_softmax: bool = False, device=None):
        super().__init__()
        e = embedding_dim
        n = len(in_channels)
        self.decoder_softmax = decoder_softmax
        for s, c in enumerate(in_channels, start=1):
            setattr(self, f"linear_c{s}", MLP(c, e, device=device))
        for s in range(n, 0, -1):  # the deepest scale has no deeper difference
            setattr(self, f"diff_c{s}", ConvDiff((2 if s == n else 3) * e, e, device=device))
        for s in range(n, 0, -1):
            setattr(self, f"make_pred_c{s}", MakePrediction(e, output_nc, device=device))
        self.linear_fuse = nn.Conv2d(n * e, e, 1, device=device)
        self.convd2x = UpsampleConvLayer(e, e, device=device)
        self.dense_2x = nn.Sequential(ResidualBlock(e, device=device))
        self.change_probability = ConvLayer(e, output_nc, 3, 1, 1, device=device)

    def forward(self, f1: Sequence[torch.Tensor], f2: Sequence[torch.Tensor]):
        target_hw = f1[0].shape[2:]
        outs, ups = [], []
        prev = None
        for s in range(len(f1) - 1, -1, -1):
            proj = getattr(self, f"linear_c{s + 1}")
            cat = [proj(f1[s]), proj(f2[s])]
            if prev is not None:
                cat.insert(0, _up2_bilinear(prev))
            d = getattr(self, f"diff_c{s + 1}")(torch.cat(cat, 1))
            outs.append(getattr(self, f"make_pred_c{s + 1}")(d))
            ups.append(d if s == 0 else resize_bilinear(d, target_hw))
            prev = d
        x = self.dense_2x(self.convd2x(self.linear_fuse(torch.cat(ups, 1))))
        outs.append(self.change_probability(x))
        if self.decoder_softmax:
            outs = [torch.sigmoid(o) for o in outs]
        return outs


class TDec(nn.Module):
    """TDec (ref :691-790): the SegFormer fuse head over four (already
    differenced) features: per-scale projection to ``embedding_dim``, bilinear
    up to the finest scale, a 1x1 fuse, two 2x transposed-conv ups with residual
    blocks, the change_probability head; softmax over the classes with
    ``decoder_softmax``."""

    def __init__(self, in_channels: Sequence[int] = (64, 128, 320, 512),
                 embedding_dim: int = 32, output_nc: int = 2,
                 decoder_softmax: bool = False, device=None):
        super().__init__()
        e = embedding_dim
        self.decoder_softmax = decoder_softmax
        for s, c in enumerate(in_channels, start=1):
            setattr(self, f"linear_c{s}", MLP(c, e, device=device))
        self.linear_fuse = nn.Conv2d(len(in_channels) * e, e, 1, device=device)
        self.convd2x = UpsampleConvLayer(e, e, device=device)
        self.dense_2x = nn.Sequential(ResidualBlock(e, device=device))
        self.convd1x = UpsampleConvLayer(e, e, device=device)
        self.dense_1x = nn.Sequential(ResidualBlock(e, device=device))
        self.change_probability = ConvLayer(e, output_nc, 3, 1, 1, device=device)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        target_hw = feats[0].shape[2:]
        ups = []
        for s in range(len(feats) - 1, -1, -1):
            h = getattr(self, f"linear_c{s + 1}")(feats[s])
            ups.append(h if s == 0 else resize_bilinear(h, target_hw))
        x = self.dense_2x(self.convd2x(self.linear_fuse(torch.cat(ups, 1))))
        cp = self.change_probability(self.dense_1x(self.convd1x(x)))
        return torch.softmax(cp, dim=1) if self.decoder_softmax else cp


class TDecV2(nn.Module):
    """TDecV2 (ref :793-871): the absolute difference of the per-scale
    projections of the two images, bilinear up to the finest scale, a 1x1
    fuse, a 3x3 conv to 16 x output_nc channels, ReLU and PixelShuffle(4)."""

    def __init__(self, in_channels: Sequence[int] = (64, 128, 320, 512),
                 embedding_dim: int = 64, output_nc: int = 2,
                 decoder_softmax: bool = False, device=None):
        super().__init__()
        e = embedding_dim
        self.decoder_softmax = decoder_softmax
        for s, c in enumerate(in_channels, start=1):
            setattr(self, f"linear_c{s}", MLP(c, e, device=device))
        self.linear_fuse = nn.Conv2d(len(in_channels) * e, e, 1, device=device)
        self.pix_shuffle_conv = nn.Conv2d(e, 16 * output_nc, 3, padding=1, device=device)

    def forward(self, f1: Sequence[torch.Tensor], f2: Sequence[torch.Tensor]):
        target_hw = f1[0].shape[2:]
        diffs = []
        for s in range(len(f1) - 1, -1, -1):
            proj = getattr(self, f"linear_c{s + 1}")
            a, b = proj(f1[s]), proj(f2[s])
            if s != 0:
                a, b = resize_bilinear(a, target_hw), resize_bilinear(b, target_hw)
            diffs.append(torch.abs(a - b))
        x = F.relu(self.pix_shuffle_conv(self.linear_fuse(torch.cat(diffs, 1))))
        x = F.pixel_shuffle(x, 4)
        return torch.softmax(x, dim=1) if self.decoder_softmax else x


class ConvProjectionBase(nn.Module):
    """convprojection_base (ref :591-643): cascaded 2x transposed-conv ups with
    residual blocks, adding the (difference) pyramid's skips on the way up,
    from 512 channels at /32 to 8 at full resolution."""

    def __init__(self, device=None):
        super().__init__()
        self.convd16x = UpsampleConvLayer(512, 320, device=device)
        self.dense_4 = nn.Sequential(ResidualBlock(320, device=device))
        self.convd8x = UpsampleConvLayer(320, 128, device=device)
        self.dense_3 = nn.Sequential(ResidualBlock(128, device=device))
        self.convd4x = UpsampleConvLayer(128, 64, device=device)
        self.dense_2 = nn.Sequential(ResidualBlock(64, device=device))
        self.convd2x = UpsampleConvLayer(64, 16, device=device)
        self.dense_1 = nn.Sequential(ResidualBlock(16, device=device))
        self.convd1x = UpsampleConvLayer(16, 8, device=device)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x = self.dense_4(self.convd16x(feats[3])) + feats[2]
        x = self.dense_3(self.convd8x(x)) + feats[1]
        x = self.dense_2(self.convd4x(x)) + feats[0]
        x = self.dense_1(self.convd2x(x))
        return self.convd1x(x)


def _tenc(device=None) -> SegFormerEncoder:
    """Tenc (ref :525-531): the MiT-b2 layout with patch-3 embeds after the
    first, DropPath 0.1."""
    return SegFormerEncoder(3, (64, 128, 320, 512), (3, 4, 6, 3), (1, 2, 4, 8),
                            (4, 4, 4, 4), (8, 4, 2, 1), first_patch=7, first_stride=4,
                            patch_size=3, qkv_bias=True, drop_path_rate=0.1,
                            device=device)


class _SiamBase(nn.Module):
    """One encoder pass over the 2N batch A||B (ref _SiamBase, :571-574); the
    encoder is the child ``encoder_name``."""

    encoder_name = "Tenc_x2"

    def encode_pair(self, x1, x2):
        n = x1.shape[0]
        feats = getattr(self, self.encoder_name)(torch.cat([x1, x2], 0))
        return [f[:n] for f in feats], [f[n:] for f in feats]


class ChangeFormerV1(_SiamBase):
    """ChangeFormerV1 (ref :644-675): the absolute difference of the Tenc
    features, the conv projection and a 3x3 head; softmax over the classes with
    ``decoder_softmax``. NCHW in, one full-resolution NCHW map out."""

    encoder_name = "Tenc"

    def __init__(self, input_nc: int = 3, output_nc: int = 2,
                 decoder_softmax: bool = False, device=None):
        super().__init__()
        self.decoder_softmax = decoder_softmax
        self.Tenc = _tenc(device)
        self.convproj = ConvProjectionBase(device)
        self.change_probability = ConvLayer(8, output_nc, 3, 1, 1, device=device)

    def forward(self, x1, x2):
        f1, f2 = self.encode_pair(x1, x2)
        cp = self.change_probability(self.convproj([torch.abs(a - b)
                                                    for a, b in zip(f1, f2)]))
        return torch.softmax(cp, dim=1) if self.decoder_softmax else cp


class ChangeFormerV2(_SiamBase):
    """ChangeFormerV2 (ref :918-949): the absolute difference of the Tenc
    features into TDec. With ``decoder_softmax`` the reference applies the
    softmax twice, once inside TDec (:787-788) and once in its own forward
    (:945-946); the JAX package keeps that and so does the port:
    softmax(softmax(logits))."""

    encoder_name = "Tenc"

    def __init__(self, input_nc: int = 3, output_nc: int = 2,
                 decoder_softmax: bool = False, device=None):
        super().__init__()
        self.decoder_softmax = decoder_softmax
        self.Tenc = _tenc(device)
        self.TDec = TDec((64, 128, 320, 512), 32, output_nc, decoder_softmax, device=device)

    def forward(self, x1, x2):
        f1, f2 = self.encode_pair(x1, x2)
        cp = self.TDec([torch.abs(a - b) for a, b in zip(f1, f2)])
        return torch.softmax(cp, dim=1) if self.decoder_softmax else cp


class ChangeFormerV3(_SiamBase):
    """ChangeFormerV3 (ref :951-973): Tenc and TDecV2, the PixelShuffle head."""

    encoder_name = "Tenc"

    def __init__(self, input_nc: int = 3, output_nc: int = 2,
                 decoder_softmax: bool = False, device=None):
        super().__init__()
        self.Tenc = _tenc(device)
        self.TDec = TDecV2((64, 128, 320, 512), 64, output_nc, decoder_softmax,
                           device=device)

    def forward(self, x1, x2):
        return self.TDec(*self.encode_pair(x1, x2))


class ChangeFormerV4(_SiamBase):
    """ChangeFormerV4 (ref :1309-1338): the 5-stage EncoderTransformer_x2 (first
    stride 2, MLP ratio 2, no q/kv bias, LayerNorm eps 1e-5, no DropPath) and
    DecoderTransformerX2. Returns the list of 6 multi-scale outputs, the
    full-resolution one last. Its attention heads have 16, 32 or 40 columns."""

    def __init__(self, input_nc: int = 3, output_nc: int = 2,
                 decoder_softmax: bool = False, device=None):
        super().__init__()
        dims = (32, 64, 128, 320, 512)
        self.Tenc_x2 = SegFormerEncoder(
            input_nc, dims, (3, 3, 4, 12, 3), (2, 2, 4, 8, 16), (2, 2, 2, 2, 2),
            (8, 4, 2, 1, 1), first_patch=7, first_stride=2, patch_size=3,
            qkv_bias=False, norm_eps=1e-5, device=device)
        self.TDec_x2 = DecoderTransformerX2(dims, 256, output_nc, decoder_softmax,
                                            device=device)

    def forward(self, x1, x2):
        return self.TDec_x2(*self.encode_pair(x1, x2))


class ChangeFormerV5(_SiamBase):
    """ChangeFormerV5 (ref :1634-1667): a (3, 6, 16, 3)-deep MiT encoder with 5
    heads at stage 3 and DecoderTransformerV3. The reference builds its
    encoder with patch_size=4 (:1646), which makes stages 2-4 come out
    (H/2+1)-sized, and its decoder then fails on the shapes at :1582: the
    reference V5 cannot run on any input. The JAX package keeps V5's depths and
    heads with the standard patch-3 embeds so that it runs (its :640-646), and
    the port follows it. Returns the list of 5 multi-scale outputs."""

    def __init__(self, input_nc: int = 3, output_nc: int = 2,
                 decoder_softmax: bool = False, embed_dim: int = 256, device=None):
        super().__init__()
        dims = (64, 128, 320, 512)
        self.Tenc_x2 = SegFormerEncoder(
            input_nc, dims, (3, 6, 16, 3), (1, 2, 5, 8), (4, 4, 4, 4), (8, 4, 2, 1),
            first_patch=7, first_stride=4, patch_size=3, qkv_bias=True,
            drop_path_rate=0.1, device=device)
        self.TDec_x2 = DecoderTransformerV3(dims, embed_dim, output_nc, decoder_softmax,
                                            device=device)

    def forward(self, x1, x2):
        return self.TDec_x2(*self.encode_pair(x1, x2))


class ChangeFormerV6(_SiamBase):
    """ChangeFormerV6 (ref :1669-1701): Siamese MiT encoder ``Tenc_x2`` over
    A||B folded into one 2N batch, then ``TDec_x2``. NCHW in, the list of 5
    multi-scale NCHW logits out (the last at full resolution).

    The defaults are the published V6 widths; the encoder keywords exist so
    that tests can build a narrow copy."""

    def __init__(self, input_nc: int = 3, output_nc: int = 2,
                 decoder_softmax: bool = False, embed_dim: int = 256,
                 embed_dims: Sequence[int] = (64, 128, 320, 512),
                 depths: Sequence[int] = (3, 3, 4, 3),
                 num_heads: Sequence[int] = (1, 2, 4, 8),
                 mlp_ratios: Sequence[int] = (4, 4, 4, 4),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1), patch_size: int = 7,
                 device=None):
        super().__init__()
        self.Tenc_x2 = SegFormerEncoder(
            input_nc, embed_dims, depths, num_heads, mlp_ratios, sr_ratios,
            first_patch=7, first_stride=4, patch_size=patch_size, qkv_bias=True,
            drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1, device=device)
        self.TDec_x2 = DecoderTransformerV3(embed_dims, embed_dim, output_nc,
                                            decoder_softmax, device=device)

    def forward(self, x1, x2):
        f1, f2 = self.encode_pair(x1, x2)
        return self.TDec_x2(f1, f2)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights, the reference's rules (ref :_init_weights):
    Linear trunc_normal(std 0.02) with zero bias; Conv2d and ConvTranspose2d
    normal(0, sqrt(2 / fan_out)) with zero bias; LayerNorm and BatchNorm
    weight 1, bias 0; PReLU 0.25. Drawn on the CPU from one
    ``torch.Generator``, then copied to each parameter's device, so a seed
    gives the same weights on every device."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def put(param, value):
        param.copy_(value.to(param.dtype))

    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            w = torch.empty(mod.weight.shape)
            nn.init.trunc_normal_(w, std=0.02, generator=gen)
            put(mod.weight, w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            kh, kw = mod.kernel_size
            out_ch = (mod.out_channels if isinstance(mod, nn.Conv2d)
                      else mod.weight.shape[1])
            fan_out = kh * kw * out_ch // mod.groups
            put(mod.weight, torch.randn(mod.weight.shape, generator=gen)
                * math.sqrt(2.0 / fan_out))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.PReLU):
            mod.weight.fill_(0.25)
    return model
