"""BIT, the Bitemporal Image Transformer, in PyTorch (counterpart of
stcd_tpu/models/bit.py). NCHW in and out.

The modules keep the original BIT's state_dict names, the names
``stcd_tpu/convert/torch_to_flax.py::convert_bit`` reads: ``resnet.*``
(torchvision's), ``conv_pred``, ``conv_a``, ``pos_embedding``,
``pos_embedding_decoder``, ``transformer.layers.{i}.0.fn.norm``,
``transformer.layers.{i}.0.fn.fn.to_qkv``, ``...to_out.0``,
``transformer.layers.{i}.1.fn.fn.net.0`` / ``.net.3``, the same under
``transformer_decoder`` with ``to_q`` / ``to_k`` / ``to_v``, and
``classifier.0`` / ``.1`` / ``.3``. The backbone holds only the stages it runs
(``resnet_stages_num``), as the JAX model does.

Numerics follow the JAX package: both attentions scale by the model dim
(32) ** -0.5, not the head dim; LayerNorm eps 1e-5; exact GELU; BatchNorm
with the JAX semantics (``layers/norm.py``). The decoder's softmax
cross-attention goes through ``ops.attention.cross_attention`` (the CUDA
kernels on a CUDA tensor, at M = token_len keys); the encoder's
self-attention over the 2 * token_len tokens is plain tensor code, as it is
plain einsum in the JAX package. ``pipeline_decoder`` (None: sequential)
is ``{"n_micro": m}`` to run the decoder's blocks as a GPipe over the grid's
stage axis (``parallel.pipeline.pipelined_decoder_apply``, JAX's
stcd_tpu/models/bit.py:249-251, 328-335); the same weights run either way.
The spatial sharding constraints have no counterpart here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.encoders.resnet import ResNetEncoder
from stcd_tpu_torch.layers.modules import resize_bilinear, upsample_nearest
from stcd_tpu_torch.layers.norm import BatchNorm
from stcd_tpu_torch.layers.stochastic import Dropout
from stcd_tpu_torch.ops.attention import cross_attention

DIM = 32  # the token and feature width of every BIT variant


class TwoLayerConv2d(nn.Sequential):
    """Conv (no bias) -> BN -> ReLU -> Conv; indices .0 .1 (.2) .3."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 device=None):
        p = kernel_size // 2
        super().__init__(
            nn.Conv2d(in_channels, in_channels, kernel_size, padding=p, bias=False,
                      device=device),
            BatchNorm(in_channels, device=device),
            nn.ReLU(),
            nn.Conv2d(in_channels, out_channels, kernel_size, padding=p, device=device))


class FeedForward(nn.Module):
    """Linear -> exact GELU -> dropout -> Linear -> dropout, as ``net``.
    ``columns`` (None: the whole hidden width): a tensor-parallel rank's
    hidden block (parallel/tensor.py), whose mask columns the hidden dropout
    keeps."""

    columns = None

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0, device=None):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(dim, hidden_dim, device=device), nn.GELU(), Dropout(dropout),
            nn.Linear(hidden_dim, dim, device=device), Dropout(dropout))

    def forward(self, x):
        fc1, act, drop1, fc2, drop2 = self.net
        return drop2(fc2(drop1(act(fc1(x)), self.columns)))


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, _ = t.shape
    return t.reshape(b, n, heads, -1).transpose(1, 2)


class Attention(nn.Module):
    """Multi-head self-attention over the tokens, scaled by dim ** -0.5.
    ``heads_split`` (None: all) is a tensor-parallel rank's first head and
    head count (parallel/tensor.py)."""

    heads_split = None

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 device=None):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.scale = dim ** -0.5
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False, device=device)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, device=device), Dropout(dropout))

    def forward(self, x):
        b, n, _ = x.shape
        _, nh = self.heads_split or (0, self.heads)
        q, k, v = (_heads(t, nh) for t in self.to_qkv(x).chunk(3, dim=-1))
        dots = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * self.scale
        attn = torch.softmax(dots, dim=-1).to(v.dtype)
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class CrossAttention(nn.Module):
    """Queries from the pixels x, keys and values from the tokens m. With
    ``softmax=True`` the product is ``cross_attention``; without, the raw
    scaled scores weigh the values. ``heads_split`` as in ``Attention``."""

    heads_split = None

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 softmax: bool = True, device=None):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.scale = dim ** -0.5
        self.softmax = softmax
        self.to_q = nn.Linear(dim, inner, bias=False, device=device)
        self.to_k = nn.Linear(dim, inner, bias=False, device=device)
        self.to_v = nn.Linear(dim, inner, bias=False, device=device)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, device=device), Dropout(dropout))

    def forward(self, x, m):
        b, n, _ = x.shape
        h0, nh = self.heads_split or (0, self.heads)
        q, k, v = (_heads(t, nh).contiguous()
                   for t in (self.to_q(x), self.to_k(m), self.to_v(m)))
        if self.softmax:
            out = cross_attention(q, k, v, scale=self.scale, dropout_heads=(h0, self.heads))
        else:
            dots = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * self.scale
            out = torch.einsum("bhij,bhjd->bhid", dots.to(v.dtype), v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, *args):
        return x + self.fn(x, *args)


class PreNorm(nn.Module):
    """LayerNorm (eps 1e-5) before ``fn``; with a second input, the one
    LayerNorm is applied to both (the reference's PreNorm2)."""

    def __init__(self, dim: int, fn: nn.Module, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.fn = fn

    def forward(self, x, *args):
        return self.fn(self.norm(x), *(self.norm(a) for a in args))


class Transformer(nn.Module):
    """``depth`` blocks of pre-norm self-attention and feed-forward."""

    def __init__(self, dim: int, depth: int, heads: int = 8, dim_head: int = 64,
                 mlp_dim: int = 64, dropout: float = 0.0, device=None):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([
            Residual(PreNorm(dim, Attention(dim, heads, dim_head, dropout, device=device),
                             device=device)),
            Residual(PreNorm(dim, FeedForward(dim, mlp_dim, dropout, device=device),
                             device=device))]) for _ in range(depth)])

    def forward(self, x):
        for attn, ff in self.layers:
            x = ff(attn(x))
        return x


class TransformerDecoder(nn.Module):
    """``depth`` blocks of pre-norm cross-attention (x over the tokens m) and
    feed-forward."""

    def __init__(self, dim: int, depth: int, heads: int = 8, dim_head: int = 64,
                 mlp_dim: int = 64, dropout: float = 0.0, softmax: bool = True,
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([
            Residual(PreNorm(dim, CrossAttention(dim, heads, dim_head, dropout, softmax,
                                                 device=device), device=device)),
            Residual(PreNorm(dim, FeedForward(dim, mlp_dim, dropout, device=device),
                             device=device))]) for _ in range(depth)])

    def forward(self, x, m):
        for attn, ff in self.layers:
            x = ff(attn(x, m))
        return x


class ResNetCD(nn.Module):
    """base_resnet18: dilated ResNet to 1/8 scale (``resnet_stages_num``
    stages), optional nearest 2x, ``conv_pred`` to 32 channels, |f1 - f2|,
    4x bilinear up and the two-conv ``classifier``. The Siamese backbone runs
    once over the 2N batch A||B."""

    def __init__(self, output_nc: int = 2, backbone: str = "resnet18",
                 resnet_stages_num: int = 5, output_sigmoid: bool = False,
                 if_upsample_2x: bool = True, device=None):
        super().__init__()
        if resnet_stages_num not in (3, 4, 5):
            raise NotImplementedError(f"resnet_stages_num {resnet_stages_num}")
        self.resnet = ResNetEncoder(backbone, depth=resnet_stages_num,
                                    replace_stride_with_dilation=(False, True, True),
                                    device=device)
        self.if_upsample_2x = if_upsample_2x
        self.output_sigmoid = output_sigmoid
        self.conv_pred = nn.Conv2d(self.resnet.out_channels[-1], DIM, 3, padding=1,
                                   device=device)
        self.classifier = TwoLayerConv2d(DIM, output_nc, device=device)

    def forward_single(self, x):
        x = self.resnet(x)[-1]
        if self.if_upsample_2x:
            x = upsample_nearest(x, 2)
        return self.conv_pred(x)

    def _head(self, x):
        if not self.if_upsample_2x:
            x = upsample_nearest(x, 2)
        x = resize_bilinear(x, (x.shape[2] * 4, x.shape[3] * 4))
        x = self.classifier(x)
        return torch.sigmoid(x) if self.output_sigmoid else x

    def forward(self, x1, x2):
        n = x1.shape[0]
        f = self.forward_single(torch.cat([x1, x2], 0))
        return self._head(torch.abs(f[:n] - f[n:]))


class BASETransformer(ResNetCD):
    """BIT: semantic tokens from a spatial-attention tokenizer (or pooled
    tokens), one transformer encoder over the two images' tokens, a
    transformer decoder per image that reads them back into the pixels."""

    def __init__(self, output_nc: int = 2, with_pos: Optional[str] = "learned",
                 resnet_stages_num: int = 5, token_len: int = 4, token_trans: bool = True,
                 enc_depth: int = 1, dec_depth: int = 1, dim_head: int = 64,
                 decoder_dim_head: int = 64, tokenizer: bool = True,
                 if_upsample_2x: bool = True, pool_mode: str = "max", pool_size: int = 2,
                 backbone: str = "resnet18", decoder_softmax: bool = True,
                 with_decoder_pos: Optional[str] = None, with_decoder: bool = True,
                 output_sigmoid: bool = False, decoder_pos_size: int = 64, device=None):
        super().__init__(output_nc, backbone, resnet_stages_num, output_sigmoid,
                         if_upsample_2x, device=device)
        self.tokenizer = tokenizer
        self.token_trans = token_trans
        self.with_decoder = with_decoder
        self.pool_mode = pool_mode
        self.pool_size = pool_size
        if tokenizer:
            self.conv_a = nn.Conv2d(DIM, token_len, 1, bias=False, device=device)
        else:
            token_len = pool_size ** 2
        self.token_len = token_len
        if token_trans:
            if with_pos == "learned":
                self.pos_embedding = nn.Parameter(
                    torch.randn(1, token_len * 2, DIM, device=device))
            self.transformer = Transformer(DIM, enc_depth, 8, dim_head, 2 * DIM,
                                           device=device)
        self.with_pos = with_pos if token_trans else None
        if with_decoder:
            self.transformer_decoder = TransformerDecoder(
                DIM, dec_depth, 8, decoder_dim_head, 2 * DIM, softmax=decoder_softmax,
                device=device)
            if with_decoder_pos in ("fix", "learned"):
                self.pos_embedding_decoder = nn.Parameter(
                    torch.randn(1, DIM, decoder_pos_size, decoder_pos_size, device=device))
        self.with_decoder_pos = with_decoder_pos if with_decoder else None

    def _semantic_tokens(self, x):
        """Spatial-attention tokenizer: softmax over the pixels of ``conv_a``'s
        token_len maps, then the weighted sums of the features, (b, L, c)."""
        b, c = x.shape[:2]
        att = torch.softmax(self.conv_a(x).reshape(b, self.token_len, -1), dim=-1)
        return torch.einsum("bln,bcn->blc", att.float(),
                            x.reshape(b, c, -1).float()).to(x.dtype)

    def _pool_tokens(self, x):
        pool = F.adaptive_max_pool2d if self.pool_mode == "max" else F.adaptive_avg_pool2d
        return pool(x, self.pool_size).flatten(2).transpose(1, 2)

    pipeline_decoder = None

    def _decode(self, x, m):
        b, c, h, w = x.shape
        if self.with_decoder_pos in ("fix", "learned"):
            x = x + self.pos_embedding_decoder
        tokens = x.flatten(2).transpose(1, 2)
        if self.pipeline_decoder is not None:
            from stcd_tpu_torch.parallel.pipeline import pipelined_decoder_apply
            out = pipelined_decoder_apply(self.transformer_decoder, tokens, m,
                                          n_micro=self.pipeline_decoder.get("n_micro"))
        else:
            out = self.transformer_decoder(tokens, m)
        return out.transpose(1, 2).reshape(b, c, h, w)

    def forward(self, x1, x2):
        n = x1.shape[0]
        f = self.forward_single(torch.cat([x1, x2], 0))
        f1, f2 = f[:n], f[n:]
        tokens_of = self._semantic_tokens if self.tokenizer else self._pool_tokens
        token1, token2 = tokens_of(f1), tokens_of(f2)
        if self.token_trans:
            tokens = torch.cat([token1, token2], dim=1)
            if self.with_pos == "learned":
                tokens = tokens + self.pos_embedding
            token1, token2 = self.transformer(tokens).chunk(2, dim=1)
        if self.with_decoder:
            f1, f2 = self._decode(f1, token1), self._decode(f2, token2)
        else:
            f1 = f1 + token1.sum(1)[:, :, None, None]
            f2 = f2 + token2.sum(1)[:, :, None, None]
        return self._head(torch.abs(f1 - f2))


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights by flax's default rules, which the JAX model
    initialises with: Conv2d and Linear normal(0, sqrt(1 / fan_in)) with zero
    bias; LayerNorm and BatchNorm weight 1, bias 0; the position embeddings
    normal(0, 1). Drawn on the CPU from one ``torch.Generator``, then copied
    to each parameter's device, so a seed gives the same weights on every
    device."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def put(param, std):
        param.copy_((torch.randn(param.shape, generator=gen) * std).to(param.dtype))

    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            put(mod.weight, math.sqrt(1.0 / fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for name, param in model.named_parameters():
        if name in ("pos_embedding", "pos_embedding_decoder"):
            put(param, 1.0)
    return model

