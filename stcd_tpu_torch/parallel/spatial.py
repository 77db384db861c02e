"""Spatial partitioning over the ``space`` axis (counterpart of
stcd_tpu/parallel/spatial.py).

The S ranks of a space group (``mesh.create_mesh``) hold the same images,
rank s of the group the rows ``[s H / S, (s + 1) H / S)`` of each: a strip.
Inside ``spatial_context(S)``, a ``TorchFunctionMode``, the ops that read
rows of a neighbouring strip take them from the neighbour first:

- ``F.conv2d`` (every ``nn.Conv2d``) pulls ``ht`` rows from the rank above
  and ``hb`` from the rank below (``halo_geometry``), zeros at the image's
  edges, and runs the conv on the padded strip;
- ``F.max_pool2d`` does the same with -inf at the edges;
- ``F.interpolate`` passes nearest upsampling by an integer factor as it is
  (it reads no other strip) and runs bilinear upsampling by an integer
  factor (``align_corners=False``) on the strip with one row of each
  neighbour, the edge row repeated at the image's edges;
- a mean over the rows (``torch.mean`` over dim 2 and maybe others, as the
  channel squeeze of ``layers/se.py`` takes) is the strip's sum, summed over
  the space group and divided by the whole image's size.

Every other op on the surface (BatchNorm, ReLU, the residual adds, concat,
abs, min, sigmoid) reads its own row only. ``F.conv_transpose2d`` raises, as
in the JAX package, and so do the ops that would mix rows with no rule here
(pools to a size, average pools, padding of the rows, unfold, attention):
the surface is SegCD, UnetSeg and FFCTLCD over the resnet and resnext
encoders. A mean of a whole tensor, as a loss takes, runs on the strip.
BatchNorm's moments and the ratio losses already sum over the data group
(``parallel/distributed.py``: every rank, or the D x S ranks of one model
index), which under a space axis covers every strip of every image once.

The exchange follows the backend: ``batch_isend_irecv`` under NCCL; under
gloo, whose sends and receives take host tensors only, one ``all_gather``
over the space group of each rank's edge rows, on the host and on a card
alike (two ranks on one card run gloo: NCCL refuses them). Another backend
raises. A halo wider than a strip (a deep map of one row a strip) takes the
gather path: the whole map all-gathered. The backward is the transpose: each
halo row's gradient goes back to the rank that owns the row and is added
there.

Gradients: every rank holds the parameters (or its model shard of them)
and takes the gradient of its own strip's share; the steps' flat all-reduce
averages them over all D x S ranks that hold each, which gives the gradient
of the global loss, as for data parallel. The exchange's backward carries the halo gradients across the
strips, so nothing is summed twice (the JAX package measured exactly 2x
where an explicit psum was added to shard_map's).

With a model axis beside the space axis (``mesh.create_mesh(model=T,
space=S)``, JAX's ``param_sharding(manual_space=True)``) a split conv of
``parallel/tensor.py`` runs on the strip too: ``OutConv2d`` takes its
group's input channels first (a grouped conv's ``narrow``), then
``F.conv2d`` here takes the halo rows over the space group and the conv
gives the rank's output channels, which ``gather_channels`` collects over
the model group. Its backward runs the other way on every rank: the gather
keeps the rank's channels, the conv's input gradient, the halo rows'
gradients back over the space group, then ``copy_in``'s sum over the model
group. The sums over rows then run over the data group, the D x S ranks of
one model index; every rank of a model group holds the same strip.

``make_spatial_seg_steps``, ``make_spatial_cd_steps`` and
``make_spatial_semi_cd_steps`` are the three stages' steps with the rows
split: the augmentation (kernel #3 on a card) runs on the data shard's full
rows with the global batch's draws, then each rank cuts its strip. They run
on a state that ``mesh.place_train_state`` placed (split over a model axis).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from stcd_tpu_torch.parallel import distributed

_ACTIVE = []  # the exchange of the entered spatial_context (one at most)


def active_space_size() -> int:
    """S inside ``spatial_context(S)``; 0 elsewhere."""
    return _ACTIVE[0].size if _ACTIVE else 0


def halo_geometry(H: int, kh: int, sh: int, pt: int, pb: int,
                  dh: int = 1, L: int = 1, *, what: str = "conv",
                  size: Optional[int] = None):
    """Static halo math for one H-dim stencil op on ``S`` shards (``size``,
    default the entered context's).

    Returns (Hl, Hol, ht, hb, pt_local, pb_local): local rows in, local
    rows out, top/bottom halo rows, and the local padding for a
    correctness-equivalent local op. Output row o taps dilated coords
    [o*sh - pt, o*sh - pt + (kh-1)*dh]; with Hol*sh divisible by L the halo
    widths are shard-invariant. ``L`` (lhs dilation) is JAX's; ``F.conv2d``
    has none, so the port's ops use L = 1."""
    S = active_space_size() if size is None else size
    ext = (kh - 1) * dh
    V = (H - 1) * L + 1
    Ho = (V + pt + pb - ext - 1) // sh + 1
    if H % S or Ho % S:
        raise ValueError(
            f"manual 'space' partitioning: {what} with H={H} -> Ho={Ho} "
            f"does not divide over {S} space shards — choose an input "
            "size whose every stage height is a multiple of the space "
            "axis (docs/SCALING.md 'Spatial partitioning')")
    Hl, Hol = H // S, Ho // S
    if (Hol * sh) % L:
        raise ValueError(
            f"manual 'space' partitioning: {what} with lhs_dilation={L}, "
            f"stride={sh}, per-shard output rows {Hol}: shard boundaries "
            "fall between dilated taps; adjust the space axis or size")
    ht = pt // L
    hb = max(0, (ext - sh - pt) // L + 1)
    pt_local = pt - ht * L
    need = (Hol - 1) * sh + ext + 1
    have = (ht + Hl + hb - 1) * L + 1 + pt_local
    pb_local = max(0, need - have)
    return Hl, Hol, ht, hb, pt_local, pb_local


class _Exchange:
    """The neighbours of this rank in its space group, and the two moves."""

    def __init__(self, size: int, group):
        backend = dist.get_backend(group)
        if backend not in ("nccl", "gloo"):
            raise NotImplementedError(f"halo exchange under the {backend} backend")
        self.size, self.group, self.p2p = size, group, backend == "nccl"
        self.index = dist.get_rank(group)
        self.above = dist.get_global_rank(group, self.index - 1) if self.index > 0 else None
        self.below = (dist.get_global_rank(group, self.index + 1)
                      if self.index < size - 1 else None)

    def swap(self, up: torch.Tensor, down: torch.Tensor):
        """Send ``up`` to the rank above and ``down`` to the rank below;
        returns (what the rank above sent down, what the rank below sent up),
        None at the image's edges. The ranks of a group hold equal shapes."""
        up, down = up.contiguous(), down.contiguous()
        if not self.p2p:  # gloo: one all_gather, as bytes, which it gathers in any dtype
            pack = torch.cat([up.reshape(-1), down.reshape(-1)]).view(torch.uint8)
            parts = [torch.empty_like(pack) for _ in range(self.size)]
            dist.all_gather(parts, pack, group=self.group)
            n = up.numel()
            from_above = (parts[self.index - 1].view(up.dtype)[n:].view(down.shape)
                          if self.above is not None else None)
            from_below = (parts[self.index + 1].view(up.dtype)[:n].view(up.shape)
                          if self.below is not None else None)
            return from_above, from_below
        ops, from_above, from_below = [], None, None
        if self.above is not None:
            from_above = torch.empty_like(down)
            if up.numel():
                ops.append(dist.P2POp(dist.isend, up, self.above, self.group))
            if down.numel():
                ops.append(dist.P2POp(dist.irecv, from_above, self.above, self.group))
        if self.below is not None:
            from_below = torch.empty_like(up)
            if down.numel():
                ops.append(dist.P2POp(dist.isend, down, self.below, self.group))
            if up.numel():
                ops.append(dist.P2POp(dist.irecv, from_below, self.below, self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return from_above, from_below

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole map: every strip of the group, stacked along H (moved as
        bytes)."""
        x = x.contiguous()
        parts = [torch.empty_like(x.view(-1).view(torch.uint8)) for _ in range(self.size)]
        dist.all_gather(parts, x.view(-1).view(torch.uint8), group=self.group)
        return torch.cat([p.view(x.dtype).view(x.shape) for p in parts], dim=2)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group, in float32 at the least."""
        acc = x.to(torch.promote_types(x.dtype, torch.float32)).contiguous()
        dist.all_reduce(acc, group=self.group)
        return acc.to(x.dtype)


def _padded(x: torch.Tensor, top, bottom, ht: int, hb: int, fill: float) -> torch.Tensor:
    """``x`` with ``ht`` rows ``top`` above and ``hb`` rows ``bottom`` below
    (``fill`` where they are None), in ``x``'s memory format."""
    n, c, hl, w = x.shape
    fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
           and not x.is_contiguous() else torch.contiguous_format)
    out = torch.empty((n, c, ht + hl + hb, w), dtype=x.dtype, device=x.device,
                      memory_format=fmt)
    out[:, :, ht:ht + hl] = x
    for rows, sl, h in ((top, slice(0, ht), ht), (bottom, slice(ht + hl, None), hb)):
        if h:
            if rows is None:
                out[:, :, sl] = fill
            else:
                out[:, :, sl] = rows
    return out


class _HaloRows(torch.autograd.Function):
    """The strip with its halo rows; the backward returns each halo row's
    gradient to its owner and adds it there."""

    @staticmethod
    def forward(ctx, x, ht: int, hb: int, fill: float, ex: _Exchange):
        hl = x.shape[2]
        ctx.ht, ctx.hb, ctx.ex, ctx.hl = ht, hb, ex, hl
        ctx.gathered = ht > hl or hb > hl
        if ctx.gathered:  # the halo is wider than a strip: the whole map
            full = ex.gather(x)
            full = F.pad(full, (0, 0, ht, hb), value=fill)
            return full[:, :, ex.index * hl:ex.index * hl + ht + hl + hb].contiguous()
        top, bottom = ex.swap(x[:, :, :hb], x[:, :, hl - ht:])
        return _padded(x, top, bottom, ht, hb, fill)

    @staticmethod
    def backward(ctx, g):
        ht, hb, hl, ex = ctx.ht, ctx.hb, ctx.hl, ctx.ex
        if ctx.gathered:
            n, c, _, w = g.shape
            buf = g.new_zeros((n, c, ht + ex.size * hl + hb, w))
            buf[:, :, ex.index * hl:ex.index * hl + ht + hl + hb] = g
            buf = ex.sum(buf)
            return buf[:, :, ht + ex.index * hl:ht + (ex.index + 1) * hl], None, None, None, None
        grad = g[:, :, ht:ht + hl].clone()
        from_above, from_below = ex.swap(g[:, :, :ht], g[:, :, ht + hl:])
        if from_above is not None and hb:
            grad[:, :, :hb] += from_above
        if from_below is not None and ht:
            grad[:, :, hl - ht:] += from_below
        return grad, None, None, None, None


def halo_rows(x: torch.Tensor, ht: int, hb: int, *, fill: float = 0.0) -> torch.Tensor:
    """Concatenate ``ht`` rows from the strip above and ``hb`` rows from the
    strip below onto this NCHW strip (dim 2) inside ``spatial_context``. The
    image's edges get ``fill`` (0 reproduces a conv's zero padding, -inf a max
    pool's). Differentiable; every rank of the space group must call it."""
    if ht == 0 and hb == 0:
        return x
    return _HaloRows.apply(x, ht, hb, fill, _ACTIVE[0])


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _conv2d(input, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    (sh, sw), (dh, dw) = _pair(stride), _pair(dilation)
    kh, kw = weight.shape[2:]
    if isinstance(padding, str):
        if padding == "valid":
            (pt, pb), (pl, pr) = (0, 0), (0, 0)
        else:  # "same" (stride 1): the extra row goes to the bottom, as torch pads
            eh, ew = dh * (kh - 1), dw * (kw - 1)
            (pt, pb), (pl, pr) = (eh // 2, eh - eh // 2), (ew // 2, ew - ew // 2)
    else:
        ph, pw = _pair(padding)
        (pt, pb), (pl, pr) = (ph, ph), (pw, pw)
    S = active_space_size()
    _, Hol, ht, hb, pt_loc, pb_loc = halo_geometry(
        input.shape[2] * S, kh, sh, pt, pb, dh, what=f"conv k{kh}s{sh}")
    x = halo_rows(input, ht, hb, fill=0.0)
    if pl != pr:
        x, pl, pr = F.pad(x, (pl, pr)), 0, 0
    if pt_loc or pb_loc:
        x = F.pad(x, (0, 0, pt_loc, pb_loc))
    out = F.conv2d(x, weight, bias, (sh, sw), (0, pl), (dh, dw), groups)
    return out[:, :, :Hol] if out.shape[2] != Hol else out


def _max_pool2d(input, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False,
                return_indices=False):
    if _pair(dilation) != (1, 1) or ceil_mode or return_indices:
        raise ValueError("max_pool2d under spatial partitioning takes dilation 1, "
                         "ceil_mode False and no indices")
    (kh, kw), (ph, pw) = _pair(kernel_size), _pair(padding)
    sh, sw = _pair(kernel_size if stride is None or stride == [] else stride)
    S = active_space_size()
    _, Hol, ht, hb, pt_loc, pb_loc = halo_geometry(
        input.shape[2] * S, kh, sh, ph, ph, what=f"max_pool k{kh}")
    neg = (float("-inf") if input.is_floating_point() else torch.iinfo(input.dtype).min)
    x = halo_rows(input, ht, hb, fill=neg)
    if pt_loc or pb_loc:
        x = F.pad(x, (0, 0, pt_loc, pb_loc), value=neg)
    out = F.max_pool2d(x, (kh, kw), (sh, sw), (0, pw))
    return out[:, :, :Hol] if out.shape[2] != Hol else out


def _interpolate(input, size=None, scale_factor=None, mode="nearest", align_corners=None,
                 recompute_scale_factor=None, antialias=False):
    args = dict(size=size, scale_factor=scale_factor, mode=mode, align_corners=align_corners,
                recompute_scale_factor=recompute_scale_factor, antialias=antialias)
    h, w = input.shape[2:]
    if size is not None:
        out_h, out_w = _pair(size)
    else:
        fh, fw = _pair(scale_factor)
        out_h, out_w = int(h * fh), int(w * fw)
    f = out_h // h
    if out_h != f * h or f < 1:
        _refuse(f"F.interpolate from {h} to {out_h} rows a strip")
    if mode == "nearest" or f == 1 and mode == "bilinear":
        return F.interpolate(input, **args)
    if mode != "bilinear" or align_corners or antialias:
        _refuse(f"F.interpolate(mode={mode!r}, align_corners={align_corners})")
    # one row of each neighbour, the edge row itself at the image's edges
    ex = _ACTIVE[0]
    x = halo_rows(input, 1, 1, fill=0.0)
    if ex.above is None:
        x = torch.cat([input[:, :, :1], x[:, :, 1:]], dim=2)
    if ex.below is None:
        x = torch.cat([x[:, :, :-1], input[:, :, -1:]], dim=2)
    out = F.interpolate(x, size=((h + 2) * f, out_w), mode="bilinear", align_corners=False)
    return out[:, :, f:f + out_h]


def _refuse(what: str):
    raise ValueError(
        f"{what} on a strip of rows: under spatial partitioning this op mixes rows across "
        "the strips and has no halo rule (the surface is SegCD, UnetSeg and FFCTLCD over "
        "the resnet and resnext encoders; ROADMAP.md Queue 3 known issue 12)")


def _conv_transpose(*args, **kwargs):
    raise NotImplementedError(
        "manual 'space' partitioning: F.conv_transpose2d is not routed through the halo "
        "machinery (the supported SP surface — SegCD/UnetSeg/FFCTLCD with resnet-family "
        "encoders — has no transposed conv). Models using nn.ConvTranspose2d need a halo "
        "rule first; see parallel/spatial.py.")


def _pad(input, pad, mode="constant", value=None):
    if len(pad) >= 4 and (pad[2] or pad[3]):
        _refuse(f"F.pad of the rows by {tuple(pad[2:4])}")
    return F.pad(input, pad, mode=mode, value=value)


_HANDLERS = {torch.conv2d: _conv2d, F.max_pool2d: _max_pool2d,
             torch.max_pool2d: _max_pool2d, F.interpolate: _interpolate,
             torch.conv_transpose2d: _conv_transpose, F.pad: _pad}
_REFUSED = {F.avg_pool2d: "F.avg_pool2d", F.adaptive_avg_pool2d: "F.adaptive_avg_pool2d",
            F.adaptive_max_pool2d: "F.adaptive_max_pool2d", F.lp_pool2d: "F.lp_pool2d",
            F.max_pool2d_with_indices: "F.max_pool2d_with_indices",
            F.fractional_max_pool2d: "F.fractional_max_pool2d", F.unfold: "F.unfold",
            F.fold: "F.fold", F.grid_sample: "F.grid_sample",
            F.scaled_dot_product_attention: "F.scaled_dot_product_attention"}


def _mean(input, dim=None, keepdim=False, *, dtype=None):
    """``torch.mean`` of an NCHW strip: over dims that take in the rows (an
    SE block's squeeze), the strip's sum summed over the space group,
    differentiably, over the whole image's count; else the strip's own mean
    (a loss's mean of equal strips)."""
    dims = () if dim is None else (dim,) if isinstance(dim, int) else tuple(dim)
    if 2 not in {d % 4 for d in dims}:
        return (torch.mean(input, dtype=dtype) if dim is None
                else torch.mean(input, dim, keepdim, dtype=dtype))
    ex = _ACTIVE[0]
    acc = dtype or torch.promote_types(input.dtype, torch.float32)
    total = distributed.all_reduce_sum(input.sum(dims, keepdim=keepdim, dtype=acc),
                                       group=ex.group)
    count = ex.size
    for d in {d % 4 for d in dims}:
        count *= input.shape[d]
    return (total / count).to(dtype or input.dtype)


class _SpatialMode(TorchFunctionMode):
    """Routes the 4-D (NCHW) ops of the module docstring through the halo."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        x = args[0] if args else kwargs.get("input")
        if torch.is_tensor(x) and x.dim() == 4:
            if func in _HANDLERS:
                return _HANDLERS[func](*args, **kwargs)
            if func in _REFUSED:
                _refuse(_REFUSED[func])
            if func in (torch.mean, torch.Tensor.mean):
                return _mean(*args, **kwargs)
        return func(*args, **kwargs)


@contextlib.contextmanager
def spatial_context(size: int):
    """Run the ops inside on this rank's strip over its space group of
    ``size`` ranks (``mesh.create_mesh(space=size)``). Entered again with
    the same size it is the context already entered; with another it raises.
    The mode is gone after the block, whether it ends or raises."""
    if _ACTIVE:
        if _ACTIVE[0].size != size:
            raise RuntimeError(f"spatial_context({size}) inside spatial_context"
                               f"({_ACTIVE[0].size})")
        yield
        return
    if size != distributed.space_size() or size < 2:
        raise ValueError(f"spatial_context({size}) on a space axis of "
                         f"{distributed.space_size()} (mesh.create_mesh(space=...))")
    _ACTIVE.append(_Exchange(size, distributed.space_group()))
    try:
        with _SpatialMode():
            yield
    finally:
        _ACTIVE.clear()


# ----------------------------------------------------- strips of a batch


def strip(t: torch.Tensor) -> torch.Tensor:
    """This rank's strip of the rows of an NCHW tensor; its H must divide
    over the space axis (JAX's ValueError)."""
    S = distributed.space_size()
    Hl = halo_geometry(t.shape[2], 1, 1, 0, 0, size=S, what="input")[0]
    s = distributed.space_rank()
    return t[:, :, s * Hl:(s + 1) * Hl]


def gather_strips(t: torch.Tensor) -> torch.Tensor:
    """The whole rows of an NCHW tensor from its strips on the space group
    (no gradient)."""
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for _ in range(distributed.space_size())]
    dist.all_gather(parts, t.contiguous(), group=distributed.space_group())
    return torch.cat(parts, dim=2)


def _space_of(mesh) -> int:
    space = getattr(mesh, "space", 1)
    if space < 2 or space != distributed.space_size():
        raise ValueError(f"the spatial steps need a mesh with a space axis > 1 "
                         f"(mesh.create_mesh(space=...)); got {mesh}")
    return space


# JAX's names and arguments for ``make_*_steps(space=mesh.space)`` (``model`` is unused:
# the train state carries it); the stage CLIs call the builders themselves


def make_spatial_seg_steps(model, mesh, augment: bool = True, remat: bool = False,
                           accum_steps: int = 1):
    """Stage-1 supervised segmentation steps with the rows over the mesh's
    space axis."""
    from stcd_tpu_torch.train.steps import make_seg_steps
    return make_seg_steps(augment=augment, remat=remat, accum_steps=accum_steps,
                          space=_space_of(mesh))


def make_spatial_cd_steps(model, mesh, augment: bool = True, remat: bool = False,
                          accum_steps: int = 1):
    """Stage-2 CD steps with the rows over the mesh's space axis: the
    augmentation on the data shard's full rows, then this rank's strip; the
    eval step returns whole images."""
    from stcd_tpu_torch.train.steps import make_cd_steps
    return make_cd_steps(augment=augment, remat=remat, accum_steps=accum_steps,
                         space=_space_of(mesh))


def make_spatial_semi_cd_steps(model, mesh, augment: bool = True, remat: bool = False,
                               accum_steps: int = 1):
    """Stage-3 STCD fine-tune steps with the rows over the mesh's space axis."""
    from stcd_tpu_torch.train.steps import make_semi_cd_steps
    return make_semi_cd_steps(augment=augment, remat=remat, accum_steps=accum_steps,
                              space=_space_of(mesh))
