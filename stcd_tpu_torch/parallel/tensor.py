"""Tensor parallelism over the ``model`` axis (counterpart of
stcd_tpu/parallel/mesh.py:285-370, ``param_sharding``, and of the GSPMD
placement that ``place_train_state`` gives it).

The JAX package places the parameters of a model group's T devices by three
rule families and lets GSPMD partition the step. The port splits the same
parameters explicitly, Megatron-style, matching modules by class:

1. attention: the query, key and value projections column-parallel (each
   rank computes its own heads: ``q`` and ``kv`` of ChangeFormer's
   ``SRAttention``, ``to_qkv`` of BIT's ``Attention``, ``to_q`` / ``to_k`` /
   ``to_v`` of its ``CrossAttention``) and the output projection
   row-parallel (``proj``, ``to_out``), so the attention runs on whole
   local heads and the block output is one all-reduce;
2. the MLP: ``MixFFN``'s ``fc1`` column-parallel with its depthwise conv
   split by channel, ``fc2`` row-parallel; BIT ``FeedForward``'s two
   Linears the same way;
3. every other ``nn.Conv2d`` kernel of at least ``min_size_to_shard``
   elements (JAX's argument, 2^20 by default) over its output channels
   (gathered after the conv) and every such ``nn.ConvTranspose2d`` over the
   axis JAX splits, which is its input channels (flax keeps a
   ``transpose_kernel`` kernel as (kh, kw, out, in) and splits the last
   axis), reduced after. The 1x1 convs of a ViG ``Grapher`` (``fc1``,
   ``graph_conv.0``, ``fc2``) stay whole: JAX runs them as ``nn.Dense``
   (stcd_tpu/models/gcn_lib.py), whose 2-D kernel this rule never takes.

A split keeps whole heads: ``kv`` holds all heads' keys, then all heads'
values, and ``to_qkv`` the queries, keys and values, so a rank's rows are
its heads' rows of each part. Where T does not divide a block's heads JAX
splits inside a head and GSPMD sums partial scores; the port keeps that
block's attention replicated, because the attention kernels take whole heads
(ROADMAP.md Queue 3 known issue 13). Modules of other classes than these
(subclasses with a forward of their own, grouped convs whose groups T does
not divide) stay replicated too.

A split parameter carries ``tp_split`` (``Split``: the axis and each rank's
indices along it). ``split_model`` applies the plan to a built model in
place (the modules keep their names, so ``state_dict`` keys stay the
reference's) and slices an optimizer's moments of them.
Checkpoints hold the one-process layout: ``full_state_dict`` and
``full_optimizer_state_dict`` gather the shards (a collective of the model
group), ``split_state_dict`` and ``split_optimizer_state_dict`` slice a full
one for this rank.

The layers meet through ``distributed.copy_in`` before a column-parallel
layer (its input gradient summed over the group), ``distributed.reduce_out``
after a row-parallel one (its bias added once after the sum) and
``distributed.gather_channels`` after an output-split conv (its backward
keeps the rank's channels). Everything between the split layers (the
LayerNorms, the BatchNorms after a gathered conv, the decoders) is
replicated and sees the same input on every rank of the group. A dropout on
a column-split activation draws the full width's mask and keeps its
columns (``layers/stochastic.py``), and the attention kernels hash a rank's
heads as heads ``h0 ..`` of the block's H (``dropout_heads``), so a step
equals one process with dropout on.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.parallel import distributed

MIN_SIZE_TO_SPLIT = 2 ** 20  # JAX's min_size_to_shard of the wide-conv rule


class Split(NamedTuple):
    """A parameter split over the model axis: along ``dim``, rank r holds the
    global indices ``parts[r]`` (int64, in its local order)."""

    dim: int
    parts: Tuple[torch.Tensor, ...]

    @property
    def size(self) -> int:
        return sum(len(p) for p in self.parts)


def _blocks(n: int, t: int, chunks: int = 1) -> Tuple[torch.Tensor, ...]:
    """Rank r's indices of ``chunks`` consecutive parts of ``n`` each (q, k,
    v of a fused projection): block r of every part, in part order."""
    per = n // t
    return tuple(torch.cat([c * n + torch.arange(r * per, (r + 1) * per)
                            for c in range(chunks)]) for r in range(t))


class _Entry(NamedTuple):
    """One module of the plan: its kind and the splits of its parameters (by
    attribute name)."""

    module: nn.Module
    kind: str
    splits: Dict[str, Split]


# ---------------------------------------------------------------------------
# The split layers
# ---------------------------------------------------------------------------

def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor], channel_dim: bool):
    if bias is None:
        return y
    bias = bias.to(y.dtype)
    return y + (bias.view(1, -1, *([1] * (y.dim() - 2))) if channel_dim else bias)


class ColumnLinear(nn.Linear):
    """A Linear whose output features are this rank's shard; its replicated
    input's gradient is summed over the model group."""

    def forward(self, x):
        return F.linear(distributed.copy_in(x), self.weight, self.bias)


class RowLinear(nn.Linear):
    """A Linear whose input features are this rank's shard: the partial
    products summed over the model group, then the bias."""

    def forward(self, x):
        return _add_bias(distributed.reduce_out(F.linear(x, self.weight)), self.bias, False)


class OutConv2d(nn.Conv2d):
    """A Conv2d whose output channels are this rank's block (for a grouped
    conv, its groups' block of the input channels too), gathered over the
    model group, then the bias."""

    in_offset = 0

    def forward(self, x):
        x = distributed.copy_in(x)
        if self.groups > 1:
            x = x.narrow(1, self.in_offset, self.in_channels)
        y = F.conv2d(x, self.weight, None, self.stride, self.padding, self.dilation,
                     self.groups)
        return _add_bias(distributed.gather_channels(y, 1), self.bias, True)


class InConvTranspose2d(nn.ConvTranspose2d):
    """A ConvTranspose2d whose input channels are this rank's block: the
    partial outputs summed over the model group, then the bias."""

    in_offset = 0

    def forward(self, x, output_size=None):
        x = distributed.copy_in(x).narrow(1, self.in_offset, self.in_channels)
        y = F.conv_transpose2d(x, self.weight, None, self.stride, self.padding,
                               self.output_padding, self.groups, self.dilation)
        return _add_bias(distributed.reduce_out(y), self.bias, True)


_CLASSES = {"column": ColumnLinear, "row": RowLinear, "out_conv": OutConv2d,
            "in_conv_t": InConvTranspose2d}


# ---------------------------------------------------------------------------
# The plan (JAX's three rule families, by module class)
# ---------------------------------------------------------------------------

def _linear(module: nn.Module, kind: str, parts, with_bias: bool = True) -> _Entry:
    """A Linear split column-wise (weight rows and bias) or row-wise (weight
    columns; the bias stays whole)."""
    splits = {"weight": Split(0 if kind == "column" else 1, parts)}
    if kind == "column" and with_bias and module.bias is not None:
        splits["bias"] = Split(0, parts)
    return _Entry(module, kind, splits)


def _attention_entries(attn: nn.Module, t: int) -> List[_Entry]:
    from stcd_tpu_torch.models.bit import Attention, CrossAttention
    from stcd_tpu_torch.models.changeformer import SRAttention

    heads = attn.num_heads if isinstance(attn, SRAttention) else attn.heads
    if heads % t:
        return []  # the kernels take whole heads (ROADMAP.md Queue 3 known issue 13)
    if isinstance(attn, SRAttention):
        c = attn.q.out_features
        col = [(attn.q, _blocks(c, t)), (attn.kv, _blocks(c, t, 2))]
        row = attn.proj
    elif isinstance(attn, Attention):
        inner = attn.to_qkv.out_features // 3
        col = [(attn.to_qkv, _blocks(inner, t, 3))]
        row = attn.to_out[0]
    else:
        assert isinstance(attn, CrossAttention)
        col = [(getattr(attn, k), _blocks(attn.to_q.out_features, t))
               for k in ("to_q", "to_k", "to_v")]
        row = attn.to_out[0]
    if any(type(m) is not nn.Linear for m, _ in col) or type(row) is not nn.Linear:
        return []
    return ([_linear(m, "column", parts) for m, parts in col]
            + [_linear(row, "row", _blocks(row.in_features, t))])


def _mlp_entries(mlp: nn.Module, t: int) -> List[_Entry]:
    from stcd_tpu_torch.models.changeformer import MixFFN

    if isinstance(mlp, MixFFN):
        fc1, fc2 = mlp.fc1, mlp.fc2
        extra = [mlp.dwconv.dwconv]
    else:  # BIT FeedForward: net = Linear, GELU, Dropout, Linear, Dropout
        fc1, fc2 = mlp.net[0], mlp.net[3]
        extra = []
    hidden = fc1.out_features
    if hidden % t or type(fc1) is not nn.Linear or type(fc2) is not nn.Linear or any(
            type(m) is not nn.Conv2d for m in extra):
        return []
    parts = _blocks(hidden, t)
    out = [_linear(fc1, "column", parts), _linear(fc2, "row", parts)]
    for dw in extra:
        splits = {"weight": Split(0, parts)}
        if dw.bias is not None:
            splits["bias"] = Split(0, parts)
        out.append(_Entry(dw, "channel", splits))
    return out


def _wide_conv_entry(conv: nn.Module, t: int, min_size: int) -> Optional[_Entry]:
    """JAX's wide-conv rule: a kernel of at least ``min_size`` elements whose
    split axis (a Conv2d's output channels, a ConvTranspose2d's input
    channels) T divides."""
    w = conv.weight
    if w.numel() < min_size or w.shape[0] % t or conv.padding_mode != "zeros":
        return None
    if type(conv) is nn.Conv2d and (conv.groups == 1 or conv.groups % t == 0):
        return _Entry(conv, "out_conv", {"weight": Split(0, _blocks(w.shape[0], t))})
    if type(conv) is nn.ConvTranspose2d and conv.groups == 1:
        return _Entry(conv, "in_conv_t", {"weight": Split(0, _blocks(w.shape[0], t))})
    return None


def _entries(model: nn.Module, t: int, min_size: int) -> List[_Entry]:
    from stcd_tpu_torch.models.bit import Attention, CrossAttention, FeedForward
    from stcd_tpu_torch.models.changeformer import MixFFN, SRAttention
    from stcd_tpu_torch.models.gcn_lib import Grapher

    out: List[_Entry] = []
    for mod in model.modules():
        if isinstance(mod, (SRAttention, Attention, CrossAttention)):
            out += _attention_entries(mod, t)
        elif isinstance(mod, (MixFFN, FeedForward)):
            out += _mlp_entries(mod, t)
    # a Grapher's convs are JAX's Dense layers, which the wide-conv rule leaves whole
    taken = {id(e.module) for e in out} | {id(m) for g in model.modules()
                                           if isinstance(g, Grapher) for m in g.modules()}
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)) and id(mod) not in taken:
            entry = _wide_conv_entry(mod, t, min_size)
            if entry is not None:
                out.append(entry)
    return out


def plan(model: nn.Module, t: int, min_size_to_shard: int = MIN_SIZE_TO_SPLIT
         ) -> Dict[str, Split]:
    """The split parameters of ``model`` over a model axis of ``t``, by
    ``state_dict`` name, from the shapes alone (the model is not changed; a
    model on the meta device will do). ``min_size_to_shard`` is JAX's
    ``param_sharding`` argument: the wide-conv rule's least kernel size."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(getattr(e.module, attr))]: split
            for e in _entries(model, t, min_size_to_shard)
            for attr, split in e.splits.items()}


# ---------------------------------------------------------------------------
# Applying and undoing the plan
# ---------------------------------------------------------------------------

def _owners(model: nn.Module, t: int, rank: int) -> None:
    """Point the modules whose forward reads the split at this rank's heads
    (``heads_split``: h0 and the local count) or columns (``columns``: the
    full width and this rank's indices)."""
    from stcd_tpu_torch.models.bit import Attention, CrossAttention, FeedForward
    from stcd_tpu_torch.models.changeformer import MixFFN, SRAttention

    split = {id(p) for p in model.parameters() if hasattr(p, "tp_split")}
    for mod in model.modules():
        if isinstance(mod, (SRAttention, Attention, CrossAttention)):
            first = mod.q if isinstance(mod, SRAttention) else (
                mod.to_qkv if isinstance(mod, Attention) else mod.to_q)
            heads = mod.num_heads if isinstance(mod, SRAttention) else mod.heads
            if id(first.weight) in split:
                mod.heads_split = (rank * heads // t, heads // t)
        elif isinstance(mod, (MixFFN, FeedForward)):
            fc1 = mod.fc1 if isinstance(mod, MixFFN) else mod.net[0]
            if id(fc1.weight) in split:
                mod.columns = (fc1.weight.tp_split.size,
                               fc1.weight.tp_split.parts[rank].to(fc1.weight.device))


_SHAPE_ATTRS = ("in_features", "out_features", "in_channels", "out_channels", "groups")


def _narrow_attrs(entry: _Entry, t: int, rank: int) -> None:
    m = entry.module
    m._tp_saved = {k: getattr(m, k) for k in _SHAPE_ATTRS if hasattr(m, k)}
    m._tp_saved["__class__"] = type(m)
    if entry.kind == "column":
        m.out_features //= t
    elif entry.kind == "row":
        m.in_features //= t
    elif entry.kind == "channel":
        m.in_channels //= t
        m.out_channels //= t
        m.groups //= t
    elif entry.kind == "out_conv":
        m.out_channels //= t
        if m.groups > 1:
            m.in_channels //= t
            m.groups //= t
            m.in_offset = rank * m.in_channels
    elif entry.kind == "in_conv_t":
        m.in_channels //= t
        m.in_offset = rank * m.in_channels
    if entry.kind in _CLASSES:
        m.__class__ = _CLASSES[entry.kind]


def _take(x: torch.Tensor, split: Split, rank: int) -> torch.Tensor:
    """Rank ``rank``'s shard of a full tensor, in ``x``'s memory layout."""
    out = x.index_select(split.dim, split.parts[rank].to(x.device))
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


def is_split(model: nn.Module) -> bool:
    """Whether ``split_model`` has split ``model``."""
    return any(hasattr(p, "tp_split") for p in model.parameters())


@torch.no_grad()
def split_model(model: nn.Module, t: int, rank: int, optimizer=None,
                min_size_to_shard: int = MIN_SIZE_TO_SPLIT) -> nn.Module:
    """Apply the plan (``plan(model, t, min_size_to_shard)``) to ``model`` in
    place: each split parameter keeps rank ``rank``'s shard (the same
    Parameter object, so an optimizer built over the model still holds it;
    ``optimizer``'s moments of it are sliced too), the split modules take
    their classes above, and the attention and MLP modules read their local
    heads and columns. Returns ``model``."""
    if is_split(model):
        raise ValueError("the model is split already")
    for entry in _entries(model, t, min_size_to_shard):
        for attr, split in entry.splits.items():
            p = getattr(entry.module, attr)
            full_shape = p.shape
            p.data = _take(p.data, split, rank)
            p.tp_split = split
            if optimizer is not None:
                state = optimizer.state.get(p, {})
                for k, v in state.items():
                    if torch.is_tensor(v) and v.shape == full_shape:
                        state[k] = _take(v, split, rank)
        _narrow_attrs(entry, t, rank)
    _owners(model, t, rank)
    return model


def _gather(x: torch.Tensor, split: Split) -> torch.Tensor:
    """The full tensor from the model group's shards (every rank of the
    group calls it together): each rank writes its shard into zeros, and
    the group sums them."""
    shape = list(x.shape)
    shape[split.dim] = split.size
    full = x.new_zeros(shape)
    full.index_copy_(split.dim, split.parts[distributed.model_rank()].to(x.device),
                     x.contiguous())
    dist.all_reduce(full, group=distributed.model_group())
    return full


@torch.no_grad()
def unsplit_model(model: nn.Module) -> nn.Module:
    """Undo ``split_model``: the full parameters gathered over the model
    group (every rank of it calls this together), the modules' classes and
    sizes back. Returns ``model``."""
    for p in model.parameters():
        if hasattr(p, "tp_split"):
            p.data = _gather(p.data, p.tp_split)
            del p.tp_split
    for m in model.modules():
        saved = m.__dict__.pop("_tp_saved", None)
        if saved is not None:
            m.__class__ = saved.pop("__class__")
            for k, v in saved.items():
                setattr(m, k, v)
            m.__dict__.pop("in_offset", None)
        m.__dict__.pop("heads_split", None)
        m.__dict__.pop("columns", None)
    return model


# ---------------------------------------------------------------------------
# Checkpoints: the one-process layout
# ---------------------------------------------------------------------------

def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with every shard gathered into the full
    tensor: the one-process layout (every rank of the model group calls it
    together). A model that is not split: its state_dict as it is."""
    sd = model.state_dict()
    if not is_split(model):
        return sd
    for name, p in model.named_parameters():
        if hasattr(p, "tp_split"):
            sd[name] = _gather(p.detach(), p.tp_split)
    return sd


def split_state_dict(model: nn.Module, sd: dict) -> dict:
    """A full (one-process) state_dict with this rank's shard of each
    parameter that ``model`` holds split; ``sd`` itself for a model that is
    not split."""
    if not is_split(model):
        return sd
    sd = dict(sd)
    rank = distributed.model_rank()
    for name, p in model.named_parameters():
        if hasattr(p, "tp_split") and name in sd:
            sd[name] = _take(sd[name], p.tp_split, rank)
    return sd


def _optimizer_params(optimizer) -> list:
    return [p for group in optimizer.param_groups for p in group["params"]]


def _map_optimizer_state(optimizer, sd: dict, fn) -> dict:
    """``sd`` (an optimizer state_dict) with ``fn(tensor, split)`` applied to
    every moment of a split parameter (a tensor of the parameter's local or
    full shape); the rest as it is."""
    params = _optimizer_params(optimizer)
    state = {}
    for i, per_param in sd["state"].items():
        p = params[i]
        split = getattr(p, "tp_split", None)
        state[i] = {k: fn(v, split) if split is not None and torch.is_tensor(v)
                    and v.dim() == p.dim() else v for k, v in per_param.items()}
    return {**sd, "state": state}


def full_optimizer_state_dict(optimizer, model: nn.Module) -> dict:
    """``optimizer.state_dict()`` with the moments of every split parameter
    gathered (every rank of the model group calls it together)."""
    sd = optimizer.state_dict()
    if not is_split(model):
        return sd
    return _map_optimizer_state(optimizer, sd, _gather)


def split_optimizer_state_dict(optimizer, model: nn.Module, sd: dict) -> dict:
    """A full optimizer state_dict with this rank's shard of each split
    parameter's moments."""
    if not is_split(model):
        return sd
    rank = distributed.model_rank()
    return _map_optimizer_state(optimizer, sd, lambda v, split: _take(v, split, rank))


def state_bytes(model: nn.Module, optimizer) -> int:
    """The bytes of ``model``'s parameters and of ``optimizer``'s state on
    this rank."""
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    for per_param in optimizer.state.values():
        n += sum(v.numel() * v.element_size() for v in per_param.values()
                 if torch.is_tensor(v))
    return n
