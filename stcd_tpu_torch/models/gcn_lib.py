"""KNN graph convolution for ViG on NCHW maps (counterpart of
stcd_tpu/models/gcn_lib.py:35-252).

- ``act_layer``: relu, prelu (documented as relu), leakyrelu (0.2), gelu
  (exact), hswish.
- ``relative_pos_bias``: the Grapher's fixed bias, minus the scaled Gram
  matrix of 2-D sin-cos embeddings; where the neighbour set is pooled (r > 1)
  the embedding's node axis is resized as ``jax.image.resize(..., "linear")``
  resizes it, with its anti-aliasing triangle kernel (``linear_resize_matrix``;
  ``F.interpolate`` does not anti-alias). Computed in numpy in float64 once per
  shape and device, and kept there.
- ``knn_graph``: L2-normalised selection, similarity 2 x.y - |x|^2 - |y|^2 plus
  the bias, the top k * d by a stable descending sort (the lower index first
  on ties, as ``jax.lax.top_k``), then every d-th.
- ``MRConv`` / ``EdgeConv`` / ``Grapher`` under the names of the reference's
  call sites (``fc1``, ``graph_conv``, ``fc2``, each a 1x1 Conv2d and a
  BatchNorm). The neighbour gather is ``torch.gather`` on the (B, M, C)
  node table.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.layers.norm import BatchNorm
from stcd_tpu_torch.layers.stochastic import DropPath

_ACTS = {"relu": nn.ReLU, "prelu": nn.ReLU, "leakyrelu": lambda: nn.LeakyReLU(0.2),
         "gelu": nn.GELU, "hswish": nn.Hardswish}


def act_layer(name: str) -> nn.Module:
    """gcn_lib's act_layer. ``prelu`` is relu here, as gcn_lib documents it;
    the JAX function has no ``prelu`` key (it raises KeyError)."""
    return _ACTS[name]()


def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float64 weights of ``jax.image.resize(method="linear")``
    along one axis (jax/_src/image/scale.py compute_weight_mat with the
    triangle kernel, antialias on): out = w.T @ in. The kernel widens by
    n_in / n_out when it downsizes."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def _sincos_pos_embed(embed_dim: int, gh: int, gw: int) -> np.ndarray:
    """MAE-style 2-D sin-cos embedding, (gh * gw, embed_dim), float64."""
    dim_half = embed_dim // 2
    omega = 1.0 / 10000 ** (np.arange(dim_half // 2, dtype=np.float64) / (dim_half / 2.0))
    gy, gx = np.meshgrid(np.arange(gh, dtype=np.float64), np.arange(gw, dtype=np.float64),
                         indexing="ij")

    def embed(pos):
        out = np.einsum("n,d->nd", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([embed(gx), embed(gy)], axis=1)


@functools.lru_cache(maxsize=None)
def relative_pos_bias_np(channels: int, n: int, m: int,
                         grid_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """(1, n, m) float32: -2 / d * pe @ resize(pe).T over the (h, w) node
    grid (square when ``grid_hw`` is None); zeros where ``channels`` < 4
    leaves no frequencies."""
    if grid_hw is None:
        side = int(round(n ** 0.5))
        grid_hw = (side, side)
    pe = _sincos_pos_embed(channels, *grid_hw)
    if pe.shape[0] != n:
        raise ValueError(f"relative_pos_bias: node grid {pe.shape[0]} != n={n}; pass "
                         "grid_hw=(h, w) for non-square node counts")
    if pe.shape[1] == 0:
        return np.zeros((1, n, m), np.float32)
    pe_m = pe if n == m else linear_resize_matrix(n, m).T @ pe
    return ((-2.0 / pe.shape[1]) * (pe @ pe_m.T))[None].astype(np.float32)


_BIAS_CACHE: Dict[tuple, torch.Tensor] = {}


def relative_pos_bias(channels: int, n: int, m: int, grid_hw=None,
                      device=None) -> torch.Tensor:
    """``relative_pos_bias_np`` as a tensor on ``device``, made once per
    shape and device (a constant: no copy per forward)."""
    grid = None if grid_hw is None else tuple(int(v) for v in grid_hw)
    key = (channels, n, m, grid, str(torch.device(device or "cpu")))
    t = _BIAS_CACHE.get(key)
    if t is None:
        t = torch.from_numpy(relative_pos_bias_np(channels, n, m, grid)).to(device)
        _BIAS_CACHE[key] = t
    return t


def knn_graph(x: torch.Tensor, y: torch.Tensor, k: int, dilation: int = 1,
              rel_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, k) indices of each x-node's neighbours among the y-nodes:
    x (B, N, C), y (B, M, C). Only the selection is normalised."""
    xf = F.normalize(x.float(), dim=-1)
    yf = F.normalize(y.float(), dim=-1)
    x2 = (xf * xf).sum(-1, keepdim=True)
    y2 = (yf * yf).sum(-1)[:, None, :]
    sim = 2.0 * torch.bmm(xf, yf.transpose(1, 2)) - x2 - y2
    if rel_pos is not None:
        sim = sim + rel_pos
    kk = min(k * dilation, y.shape[1])
    idx = torch.sort(sim, dim=-1, descending=True, stable=True).indices[..., :kk]
    return idx[:, :, ::dilation][:, :, :k]


def gather_neighbors(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, M, C) table, (B, N, k) indices -> (B, N, k, C)."""
    b, _, c = table.shape
    _, n, k = idx.shape
    flat = idx.reshape(b, n * k, 1).expand(b, n * k, c)
    return torch.gather(table, 1, flat).reshape(b, n, k, c)


class BasicConv(nn.Sequential):
    """1x1 conv + BatchNorm (``.0``, ``.1``); the activation is applied by
    the caller, as in the reference's call sites."""

    def __init__(self, cin: int, cout: int, bias: bool = True, device=None):
        super().__init__(nn.Conv2d(cin, cout, 1, bias=bias, device=device),
                         BatchNorm(cout, device=device))


class MRConv(BasicConv):
    """Max-relative graph conv (``conv="mr"``): [x, max_j (x_j - x_i)]
    interleaved channel by channel, then its 1x1 conv + BN (``.0``, ``.1``)
    and ``act``. ``forward(x, neighbors, idx, hw)`` -> (B, cout, H, W)."""

    def __init__(self, cin: int, cout: int, act: str = "gelu", bias: bool = True,
                 device=None):
        super().__init__(2 * cin, cout, bias, device=device)
        self.act = act_layer(act)

    def _nn(self, h: torch.Tensor) -> torch.Tensor:
        return self.act(self[1](self[0](h)))

    def forward(self, x, neighbors, idx, hw):
        b, n, c = x.shape
        x_j = (gather_neighbors(neighbors, idx) - x[:, :, None, :]).amax(dim=2)
        h = torch.stack([x, x_j], dim=-1).reshape(b, n, 2 * c)
        return self._nn(h.transpose(1, 2).reshape(b, 2 * c, *hw))


class EdgeConv(MRConv):
    """EdgeConv (``conv="edge"``): max_j act(BN(conv1x1([x_i, x_j - x_i])))."""

    def forward(self, x, neighbors, idx, hw):
        gathered = gather_neighbors(neighbors, idx)
        xi = x[:, :, None, :].expand_as(gathered)
        h = torch.cat([xi, gathered - xi], dim=-1).permute(0, 3, 1, 2)  # (B, 2C, N, k)
        return self._nn(h).amax(dim=-1).reshape(x.shape[0], -1, *hw)


class Grapher(nn.Module):
    """fc1 (1x1 conv + BN) -> KNN against the r-pooled node set with the
    relative-position bias -> graph conv to 2C -> fc2 (1x1 conv + BN) ->
    DropPath, plus the input (stcd_tpu/models/gcn_lib.py:207-252).
    ``graph_conv`` is the MRConv or EdgeConv (``.0`` conv, ``.1`` BN)."""

    def __init__(self, in_channels: int, kernel_size: int = 9, dilation: int = 1,
                 conv: str = "mr", act: str = "gelu", r: int = 1, drop_path: float = 0.0,
                 relative_pos: bool = True, device=None):
        super().__init__()
        c = in_channels
        if conv not in ("mr", "edge"):
            raise ValueError(f"graph conv {conv!r}: 'mr' or 'edge'")
        self.k, self.dilation, self.r, self.relative_pos = kernel_size, dilation, r, relative_pos
        self.fc1 = BasicConv(c, c, device=device)
        self.graph_conv = (MRConv if conv == "mr" else EdgeConv)(c, 2 * c, act, device=device)
        self.fc2 = BasicConv(2 * c, c, device=device)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        feat = self.fc1(x)
        nodes = feat.flatten(2).transpose(1, 2)
        if self.r > 1:
            nbrs = F.avg_pool2d(feat, self.r, self.r).flatten(2).transpose(1, 2)
        else:
            nbrs = nodes
        rel = (relative_pos_bias(c, h * w, nbrs.shape[1], (h, w), x.device)
               if self.relative_pos else None)
        idx = knn_graph(nodes.detach(), nbrs.detach(), self.k, self.dilation, rel)
        out = self.graph_conv(nodes, nbrs, idx, (h, w))
        return self.drop_path(self.fc2(out)) + x
