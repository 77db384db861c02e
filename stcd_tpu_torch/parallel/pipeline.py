"""Pipeline parallelism (GPipe) over the ``stage`` axis (counterpart of
stcd_tpu/parallel/pipeline.py).

The S ranks of a stage group (``mesh.create_mesh(stage=S)``; rank r runs
stage ``r % S`` of data shard ``r // S``) hold the same rows and the whole
model. ``gpipe_hetero(stage_fns, act, n_micro=m)`` splits the batch into m
microbatches, rows ``[i B / m, (i + 1) B / m)``, and runs them through the
stages in GPipe order: rank s runs ``stage_fns[s]`` on each microbatch and
sends the activations to rank s + 1. The last stage's output and, with
``collect_aux``, each stage's ``aux`` output are then broadcast from the rank
that made them to the whole stage group (JAX's ``psum`` of the output and its
stage-sharded aux), so the code after the pipeline runs alike on every rank.

Backward: one ``torch.autograd.Function`` holds the forward's per-microbatch
graphs and drives the mirrored schedule in a fixed order, microbatches last
to first: the last stage takes its own output gradient, each stage runs
``torch.autograd.backward`` on its microbatch, sends the input gradient to
the stage before and receives the next one; stage 0's input gradient is
broadcast to the group. Every rank meets every send and receive in one
order, so the schedule runs under NCCL (no tags) and gloo alike. The
gradients of a stage's parameters land only on the rank that runs it (the
other ranks' stay None); the trainer makes them whole (``sync_gradients``).
As with ``torch.utils.checkpoint``'s reentrant variant, the parameters'
gradients are accumulated by that inner backward: ``loss.backward()``
reaches them, ``torch.autograd.grad(loss, params)`` does not.

Boundaries: every rank derives each stage's output shapes and dtypes from
one pass of the stage functions over a fake microbatch
(``FakeTensorMode``, the stages' modules in eval mode), cached by input
signature, so nothing but activations crosses the ring. Boundary leaves
must be floating point, as in JAX.

Semantics are JAX's: ``B % m == 0``; ``len(stage_fns) == S``; S == 1 is the
stages applied in sequence. The three model routes are
``bit_pipeline_forward`` (the BIT ``_dd8`` transformer decoder,
``gpipe`` over its blocks), ``changeformer_pipeline_forward`` (the V4-V6 MiT
encoder stages) and ``changevig_pipeline_forward`` (the ViG [2, 2, 6, 2]
stages). In training a stage's stochastic layers draw from a generator of
their own, seeded once a step from the model's and reseeded for each
microbatch: a stage's masks repeat across its microbatches, as JAX folds one
key a stage (models/changeformer.py:248-285), and every rank draws every
stage's seed so that the generators stay in step.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch
from torch import nn
from torch._subclasses.fake_tensor import is_fake

from stcd_tpu_torch.layers.stochastic import RowMap, Stochastic
from stcd_tpu_torch.parallel import distributed


class _Grid(NamedTuple):
    size: int
    index: int
    ranks: list
    group: Any


def _grid() -> Optional[_Grid]:
    s = distributed.stage_size()
    if s == 1:
        return None
    return _Grid(s, distributed.stage_rank(), distributed.stage_ranks(),
                 distributed.stage_group())


def _leaves(x) -> list:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _pack(is_tuple: bool, leaves: list):
    """``leaves`` as a tuple, or as the one tensor of a bare activation."""
    return tuple(leaves) if is_tuple else leaves[0]


def _microbatches(leaves: list, n_micro: int) -> list:
    """The m microbatches of the leaves, each a list: rows [i B / m, (i + 1) B / m)."""
    b = leaves[0].shape[0]
    if n_micro < 1 or b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    rows = b // n_micro
    return [[t[i * rows:(i + 1) * rows] for t in leaves] for i in range(n_micro)]


class _Meta(NamedTuple):
    """Per stage, for one microbatch: the (shape, dtype) of its output leaves
    and of its aux leaves, and whether each is a tuple."""

    outs: list
    auxes: list
    out_tuple: list
    aux_tuple: list


_META_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _signature(mb: list, is_tuple: bool, collect_aux: bool) -> tuple:
    dev = mb[0].device.type
    cast = torch.is_autocast_enabled(dev)
    return (tuple((tuple(t.shape), t.dtype, str(t.device)) for t in mb), is_tuple,
            cast, torch.get_autocast_dtype(dev) if cast else None, collect_aux)


def _boundaries(stage_fns, mb: list, is_tuple: bool, collect_aux: bool,
                modules: Optional[Sequence[nn.Module]]) -> _Meta:
    """Each stage's output shapes and dtypes, from the stage functions run on
    a fake microbatch (no data, no launches, no draws: the stages' modules
    in eval mode, no grad). Cached by the first module and the signature."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    key = _signature(mb, is_tuple, collect_aux)
    cache = _META_CACHE.setdefault(modules[0], {}) if modules else {}
    if key in cache:
        return cache[key]
    meta = _Meta([], [], [], [])
    with eval_mode(modules or ()), FakeTensorMode(allow_non_fake_inputs=True) as mode, \
            torch.no_grad():
        act = _pack(is_tuple, [mode.from_tensor(t) for t in mb])
        for fn in stage_fns:
            y = fn(act)
            aux = None
            if collect_aux:
                y, aux = y
            for leaf in _leaves(y) + (_leaves(aux) if collect_aux else []):
                if not leaf.is_floating_point():
                    raise TypeError(
                        "gpipe_hetero stage boundaries must be float tensors (the ring "
                        f"transports floats); got {leaf.dtype}: cast integer and bool "
                        "features before the boundary")
            meta.outs.append([(tuple(t.shape), t.dtype) for t in _leaves(y)])
            meta.out_tuple.append(isinstance(y, (tuple, list)))
            meta.auxes.append([(tuple(t.shape), t.dtype) for t in _leaves(aux)]
                              if collect_aux else [])
            meta.aux_tuple.append(isinstance(aux, (tuple, list)))
            act = y
    cache[key] = meta
    return meta


@contextlib.contextmanager
def eval_mode(modules: Sequence[nn.Module]):
    """Every submodule of ``modules`` in eval mode inside the block, each put
    back to its own mode after (a container's flag says nothing of its
    children's: the stage containers are not the model's registered
    children)."""
    kept = [(x, x.training) for m in modules for x in m.modules()]
    try:
        for x, _ in kept:
            x.training = False
        yield
    finally:
        for x, training in kept:
            x.training = training


def _empty(meta_leaf, n_micro: int, device) -> torch.Tensor:
    """A buffer for ``n_micro`` microbatches of a leaf."""
    shape, dtype = meta_leaf
    return torch.empty((n_micro * shape[0],) + shape[1:], dtype=dtype, device=device)


class _Run:
    """One pipelined call on this rank: the forward schedule, the graphs it
    keeps for the backward, and the backward schedule."""

    def __init__(self, grid: _Grid, stage_fns, n_micro: int, collect_aux: bool,
                 meta: _Meta, in_meta: list, in_tuple: bool, device):
        self.grid, self.fns, self.m = grid, list(stage_fns), n_micro
        self.collect_aux, self.meta, self.device = collect_aux, meta, device
        self.in_meta, self.in_tuple = in_meta, in_tuple
        self.saved: list = []

    def forward(self, inputs: list, grad: bool) -> list:
        g, m, meta = self.grid, self.m, self.meta
        s = g.index
        xs = _microbatches(inputs, m) if s == 0 else None
        finals, mine_aux = [], []
        for i in range(m):
            if s == 0:
                inp = xs[i]
            else:
                inp = [distributed.recv(shape, dtype, self.device, g.ranks[s - 1])
                       for shape, dtype in meta.outs[s - 1]]
            if grad:
                inp = [t.detach().requires_grad_() for t in inp]
            is_tuple = self.in_tuple if s == 0 else meta.out_tuple[s - 1]
            with torch.enable_grad() if grad else contextlib.nullcontext():
                y = self.fns[s](_pack(is_tuple, inp))
            aux = None
            if self.collect_aux:
                y, aux = y
            y_leaves = _leaves(y)
            aux_leaves = _leaves(aux) if self.collect_aux else []
            if any(is_fake(t) for t in y_leaves + aux_leaves):
                raise RuntimeError(
                    f"stage {s} returned a fake tensor: a module kept a tensor that the "
                    "shape pass made (cache constants only when not is_fake)")
            if s < g.size - 1:
                for t in y_leaves:
                    distributed.send(t, g.ranks[s + 1])
            else:
                finals.append([t.detach() for t in y_leaves])
            mine_aux.append([t.detach() for t in aux_leaves])
            if grad:
                self.saved.append((inp, y_leaves, aux_leaves))
        # the last stage's output, then each stage's aux, to the whole group
        out = []
        for j, leaf_meta in enumerate(meta.outs[-1]):
            t = (torch.cat([f[j] for f in finals]) if s == g.size - 1
                 else _empty(leaf_meta, m, self.device))
            out.append(distributed.broadcast_in(t, g.ranks[-1], g.group))
        if self.collect_aux:
            for k in range(g.size):
                for j, leaf_meta in enumerate(meta.auxes[k]):
                    t = (torch.cat([a[j] for a in mine_aux]) if s == k
                         else _empty(leaf_meta, m, self.device))
                    out.append(distributed.broadcast_in(t, g.ranks[k], g.group))
        return out

    def backward(self, grads: list, want_input: bool) -> list:
        """The mirrored schedule, microbatches last to first. ``grads`` are
        this rank's gradients of the forward's outputs (None: zero); the last
        stage reads the final output's, stage k its aux's. Returns the input
        gradients, stage 0's broadcast to the group (or Nones)."""
        g, m, meta = self.grid, self.m, self.meta
        s = g.index
        n_final = len(meta.outs[-1])
        at = n_final + sum(len(meta.auxes[k]) for k in range(s)) if self.collect_aux else 0
        g_aux = grads[at:at + len(meta.auxes[s])] if self.collect_aux else []

        def piece(t, meta_leaf, i):
            if t is None:
                return torch.zeros(meta_leaf[0], dtype=meta_leaf[1], device=self.device)
            rows = t.shape[0] // m
            return t[i * rows:(i + 1) * rows]

        input_grads = [None] * m
        for i in reversed(range(m)):
            inp, y_leaves, aux_leaves = self.saved[i]
            if s == g.size - 1:
                g_y = [piece(t, ml, i) for t, ml in zip(grads[:n_final], meta.outs[-1])]
            else:
                g_y = [distributed.recv(shape, dtype, self.device, g.ranks[s + 1])
                       for shape, dtype in meta.outs[s]]
            roots, root_grads = [], []
            for t, gt in zip(y_leaves, g_y):
                if t.requires_grad:
                    roots.append(t)
                    root_grads.append(gt.to(t.dtype))
            for t, gt, ml in zip(aux_leaves, g_aux, meta.auxes[s]):
                if t.requires_grad:
                    roots.append(t)
                    root_grads.append(piece(gt, ml, i).to(t.dtype))
            if roots:
                torch.autograd.backward(roots, root_grads)
            g_in = [t.grad if t.grad is not None else torch.zeros_like(t) for t in inp]
            if s > 0:
                for t in g_in:
                    distributed.send(t, g.ranks[s - 1])
            else:
                input_grads[i] = g_in
        self.saved = []
        if not want_input:
            return [None] * len(self.in_meta)
        out = []
        for j, leaf_meta in enumerate(self.in_meta):
            t = (torch.cat([x[j] for x in input_grads]) if s == 0
                 else _empty(leaf_meta, m, self.device))
            out.append(distributed.broadcast_in(t, g.ranks[0], g.group))
        return out


class _Pipeline(torch.autograd.Function):
    """The pipelined call as one node of the outer graph, whose backward runs
    the mirrored schedule (``_Run.backward``). The last input is an empty
    anchor that requires grad, so that the backward runs for the stages'
    parameters when no activation input requires grad."""

    @staticmethod
    def forward(ctx, run: _Run, *inputs):
        ctx.run = run
        return tuple(run.forward(list(inputs[:-1]), grad=True))

    @staticmethod
    def backward(ctx, *grads):
        n_in = len(ctx.needs_input_grad) - 2
        g_in = ctx.run.backward(list(grads), any(ctx.needs_input_grad[1:1 + n_in]))
        ctx.run = None
        return (None, *g_in, None)


def gpipe_hetero(stage_fns: Sequence[Callable], act, *, n_micro: Optional[int] = None,
                 collect_aux: bool = False,
                 stage_modules: Optional[Sequence[nn.Module]] = None):
    """An S-stage GPipe over per-stage distinct functions (JAX's
    ``gpipe_hetero``, stcd_tpu/parallel/pipeline.py:190).

    ``stage_fns[s](act_s) -> act_{s+1}`` (with ``collect_aux``:
    ``-> (act_{s+1}, aux_s)``), where an activation or aux is a tensor or a
    tuple of tensors whose first axis is the batch; shapes and dtypes may
    change at every boundary. The parameters are the stage functions' own
    (their modules, whole on every rank). ``stage_modules``: the modules the
    stages run, put in eval mode for the shape pass and keying its cache.
    Returns the final activation, or ``(final, [aux_0 .. aux_{S-1}])``, on
    every rank of the stage group. S is the grid's stage axis
    (``distributed.stage_size()``) and must equal ``len(stage_fns)``;
    ``n_micro`` defaults to S and must divide the batch. S == 1 applies the
    stages in sequence."""
    grid = _grid()
    if grid is None:  # no stage axis: the stages in sequence
        auxes = []
        for fn in stage_fns:
            act = fn(act)
            if collect_aux:
                act, aux = act
                auxes.append(aux)
        return (act, auxes) if collect_aux else act
    if len(stage_fns) != grid.size:
        raise ValueError(f"{len(stage_fns)} stages != {grid.size} ranks on the 'stage' axis")
    n_micro = n_micro or grid.size
    inputs = _leaves(act)
    in_tuple = isinstance(act, (tuple, list))
    mb = _microbatches(inputs, n_micro)[0]
    meta = _boundaries(stage_fns, mb, in_tuple, collect_aux, stage_modules)
    run = _Run(grid, stage_fns, n_micro, collect_aux, meta,
               [(tuple(t.shape), t.dtype) for t in mb], in_tuple, inputs[0].device)
    if torch.is_grad_enabled():
        anchor = torch.empty(0, device=inputs[0].device, requires_grad=True)
        flat = _Pipeline.apply(run, *inputs, anchor)
    else:
        flat = run.forward(inputs, grad=False)
    n_final = len(meta.outs[-1])
    final = _pack(meta.out_tuple[-1], list(flat[:n_final]))
    if not collect_aux:
        return final
    auxes, at = [], n_final
    for k in range(grid.size):
        n = len(meta.auxes[k])
        auxes.append(_pack(meta.aux_tuple[k], list(flat[at:at + n])))
        at += n
    return final, auxes


def gpipe(blocks: Sequence[Callable], act, *, n_micro: Optional[int] = None,
          stage_modules: Optional[Sequence[nn.Module]] = None):
    """A depth-D stack of blocks ``act -> act`` (same structure and shapes)
    as an S-stage GPipe: stage s runs blocks ``[s D / S, (s + 1) D / S)``
    (JAX's ``gpipe``, stcd_tpu/parallel/pipeline.py:64, whose stacked
    parameters are the blocks here). Requires ``D % S == 0``; S == 1 runs
    the blocks in sequence."""
    s = distributed.stage_size()
    depth = len(blocks)
    if depth % s:
        raise ValueError(f"depth {depth} not divisible by {s} stages")
    per = depth // s

    def stage(chunk):
        def run(a):
            for block in chunk:
                a = block(a)
            return a
        return run

    return gpipe_hetero([stage(blocks[k * per:(k + 1) * per]) for k in range(s)], act,
                        n_micro=n_micro, stage_modules=stage_modules)


# ---------------------------------------------------------------------------
# Train-mode draws of a pipelined stage
# ---------------------------------------------------------------------------

def stage_draws(modules: Sequence[nn.Module], n_rows: int, device) -> Optional[list]:
    """In training, one generator a stage for its stochastic layers, seeded
    from the generator the model's layers hold (``set_generator``; None:
    the device's default one): S seeds drawn at once, on every rank, so
    that all end the step in the same state. Also the ``RowMap`` of a
    microbatch of ``n_rows`` local rows within the global microbatch (None
    in one data shard). Returns ``[(generator, seed, rows)] * S``, or None
    when no stage module is in training."""
    if not any(m.training for m in modules):
        return None
    layers = [x for m in modules for x in m.modules() if isinstance(x, Stochastic)]
    source = layers[0].generator if layers else None
    dev = source.device if source is not None else torch.device(device)
    seeds = torch.randint(0, 2 ** 62, (len(modules),), generator=source, device=dev).tolist()
    rows = None
    if distributed.data_size() > 1:
        d, n_data = distributed.data_rank(), distributed.data_size()
        rows = RowMap(n_rows, n_rows * n_data,
                      torch.arange(d, n_rows * n_data, n_data, device=device), d, n_data)
    return [(torch.Generator(device=dev), seed, rows) for seed in seeds]


def with_draws(fn: Callable, module: nn.Module, draw) -> Callable:
    """``fn`` with ``module``'s stochastic layers pointed at the stage's own
    generator, reseeded for every call (so every microbatch draws the same
    masks) and at the microbatch's rows; put back after the call."""
    if draw is None:
        return fn
    generator, seed, rows = draw
    layers = [x for x in module.modules() if isinstance(x, Stochastic)]

    def run(act):
        kept = [(x.generator, x.rows) for x in layers]
        generator.manual_seed(seed)
        for x in layers:
            x.generator, x.rows = generator, rows
        try:
            return fn(act)
        finally:
            for x, (gen, r) in zip(layers, kept):
                x.generator, x.rows = gen, r

    return run


# ---------------------------------------------------------------------------
# The three model routes (JAX's stcd_tpu/parallel/pipeline.py:340-470)
# ---------------------------------------------------------------------------

def decoder_blocks(dec: nn.Module) -> List[Callable]:
    """The blocks of a BIT ``TransformerDecoder`` as functions of ``(x, m)``
    (the counterpart of JAX's ``stack_decoder_params``: the port's blocks are
    modules already, so nothing is restacked and any checkpoint runs)."""
    return [lambda act, attn=attn, ff=ff: (ff(attn(act[0], act[1])), act[1])
            for attn, ff in dec.layers]


def pipelined_decoder_apply(dec: nn.Module, x: torch.Tensor, m: torch.Tensor, *,
                            n_micro: Optional[int] = None) -> torch.Tensor:
    """``dec(x, m)`` with its blocks as a GPipe over the stage axis (JAX's
    ``pipelined_decoder_apply``). The decoder's dropout must be 0, as JAX
    asserts (BIT never uses decoder dropout, ref networks.py:307-441)."""
    from stcd_tpu_torch.layers.stochastic import Dropout

    if any(isinstance(x_, Dropout) and x_.p != 0.0 for x_ in dec.modules()):
        raise ValueError("pipelined decoder requires dropout=0")
    out, _ = gpipe(decoder_blocks(dec), (x, m), n_micro=n_micro,
                   stage_modules=list(dec.layers))
    return out


def _routes():
    from stcd_tpu_torch.models.bit import BASETransformer
    from stcd_tpu_torch.models.changeformer import (ChangeFormerV4, ChangeFormerV5,
                                                    ChangeFormerV6)
    from stcd_tpu_torch.models.changevig import _VIGSiam

    return ((BASETransformer, "bit"), ((ChangeFormerV4, ChangeFormerV5, ChangeFormerV6),
                                       "changeformer"), (_VIGSiam, "changevig"))


def pipeline_route(model: nn.Module, net_G: Optional[str] = None) -> str:
    """Which of the three routes pipelines ``model``: "bit", "changeformer"
    or "changevig"; any other model raises JAX's NotImplementedError
    (stcd_tpu/train/trainer.py:264-270). ChangeFormer V1-V3 build their
    encoder without the pipeline hook and fall through to it, as in JAX."""
    for kinds, name in _routes():
        if isinstance(model, kinds):
            return name
    raise NotImplementedError(
        "pp_stages > 1 pipelines the BIT transformer-decoder stack, the ChangeFormer "
        "V4-V6 MiT encoder stages, or the ChangeVIG [2,2,6,2] DeepGCN stages; "
        f"net_G={net_G or type(model).__name__!r} has none (use the 'data'/'space' axes)")


def pipelined_part(model: nn.Module) -> nn.Module:
    """The module whose stages the route pipelines: BIT's decoder, the MiT
    or ViG encoder."""
    route = pipeline_route(model)
    if route == "bit":
        return model.transformer_decoder
    if route == "changeformer":
        return model.Tenc_x2
    return getattr(model, model.encoder_name)


def check_stages(model: nn.Module, stages: int) -> None:
    """Raise where ``stages`` cannot pipeline ``model``: not the encoder's
    stage count (V4: 5; V5, V6 and the ViG family: 4), or not a divisor of
    BIT's decoder depth."""
    part = pipelined_part(model)
    if pipeline_route(model) == "bit":
        n = len(part.layers)
        if n % stages:
            raise ValueError(f"pp_stages {stages}: BIT's decoder depth {n} does not divide "
                             "over the stages")
    elif stages != (n := len(part.stage_modules())):
        raise ValueError(f"pp_stages {stages}: {type(model).__name__}'s encoder has {n} "
                         "stages, and the pipeline takes one a rank")


def set_pipeline(model: nn.Module, n_micro: Optional[int]) -> nn.Module:
    """Switch ``model``'s route on (``{"n_micro": n_micro}``; None: S) or,
    with ``n_micro=False``, off. Returns the pipelined part."""
    part = pipelined_part(model)
    cfg = None if n_micro is False else {"n_micro": n_micro}
    if pipeline_route(model) == "bit":
        model.pipeline_decoder = cfg
    else:
        part.pipeline = cfg
    return part


@contextlib.contextmanager
def pipelined(model: nn.Module, n_micro: Optional[int] = None):
    """``model`` with its route on inside the block (the JAX wrappers'
    ``model.clone(pipeline_...=...)``)."""
    set_pipeline(model, n_micro)
    try:
        yield model
    finally:
        set_pipeline(model, False)


def _route_forward(route: str, model, x1, x2, n_micro):
    if pipeline_route(model) != route:
        raise TypeError(f"the {route} route does not take {type(model).__name__}")
    with pipelined(model, n_micro):
        return model(x1, x2)


def bit_pipeline_forward(model, x1, x2, *, n_micro: Optional[int] = None):
    """``BASETransformer(x1, x2)`` with the token decoder's blocks run as a
    GPipe over the stage axis (JAX's ``bit_pipeline_forward``). Train or
    eval as the model is set; returns the model's output."""
    return _route_forward("bit", model, x1, x2, n_micro)


def changeformer_pipeline_forward(model, x1, x2, *, n_micro: Optional[int] = None):
    """ChangeFormer V4/V5/V6 with the MiT encoder's stages run as a
    heterogeneous GPipe (JAX's ``changeformer_pipeline_forward``); the
    stage axis must be the encoder's stage count."""
    return _route_forward("changeformer", model, x1, x2, n_micro)


def changevig_pipeline_forward(model, x1, x2, *, n_micro: Optional[int] = None):
    """A ChangeVIG-family model with the ViG encoder's [2, 2, 6, 2] stages run
    as a heterogeneous GPipe (JAX's ``changevig_pipeline_forward``); inside
    it the stages run frozen-BN, no DropPath (``VIGBackbone``)."""
    return _route_forward("changevig", model, x1, x2, n_micro)


def sync_gradients(model: nn.Module, stage_params) -> None:
    """Make every rank's gradients those of the global batch, after a
    pipelined backward. A stage's parameters have their gradient on the
    rank that runs the stage only (zeros are put in elsewhere); the others
    (the BIT backbone, the decoders) have the same gradient on every rank of
    a stage group, from the same rows. ``distributed.average_gradients``
    then sums each over every rank (a tensor-parallel shard over the ranks
    of its model index) and divides by its copies: a stage's parameter by
    D (its owners, one a data shard), any other by D x S, each times T
    unless it is split: the mean over the data shards. A parameter keeps
    None where no rank has a gradient (one flag all-reduce), so the
    optimizer skips it as one process does."""
    import torch.distributed as dist

    if not distributed.data_parallel():
        return
    params = [p for p in model.parameters() if p.requires_grad]
    has = torch.tensor([p.grad is not None for p in params], dtype=torch.uint8,
                       device=distributed._comm_device())
    dist.all_reduce(has, op=dist.ReduceOp.MAX)
    for p, flag in zip(params, has.tolist()):
        if flag and p.grad is None:
            p.grad = torch.zeros_like(p)
    distributed.average_gradients(params, staged=stage_params)


def stage_parameters(model: nn.Module) -> list:
    """The parameters that the pipelined stages run (their gradient is on
    the owning rank only); the stem and ``pos_embed`` of ViG, BIT's backbone
    and every decoder are outside."""
    part = pipelined_part(model)
    mods = list(part.layers) if pipeline_route(model) == "bit" else part.stage_modules()
    return [p for m in mods for p in m.parameters()]
