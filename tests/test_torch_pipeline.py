"""Pipeline parallelism of stcd_tpu_torch (parallel/pipeline.py, the stage axis
of parallel/mesh.py, CDTrainer(pp_stages), cli.train_cd --pp_stages) against
sequential application, one process and the JAX package.

The ranks are processes that run this file as a script (``--worker``) over
gloo with a ``file://`` rendezvous under the test's tmp_path, one torch
thread each, and import no JAX: the jobs of JOBS (2 ranks at stage 2, 4 at
stage 4, 4 at data 2 x stage 2, and one process for the one-process
references) run at once, while the parent computes the JAX references; the
tests then read what each wrote. The weights are the port's seeded ones,
converted to JAX's trees with stcd_tpu.convert.torch_to_flax.

1. gpipe and gpipe_hetero (with and without collect_aux) on toy stages, at
   S = 2 and 4 and m = 2 and 4, and at data 2 x stage 2: the output, the
   input gradients and each stage's parameter gradients (on the rank that
   owns the stage; None on the others) equal sequential application within
   TOY_SHARE of each tensor's largest magnitude, and equal JAX's gpipe / gpipe_hetero on the 8-device CPU mesh
   from the same numpy draws (at S = 2, m = 2 and S = 4, m = 4).
2. The three routes against the JAX wrappers on one set of weights: BIT
   ``_dd8`` at S = 2 (64x64), ChangeFormerV6 and ChangeGNNV2 at S = 4, eval logits
   within JAX's own bound (ROUTE_TOL, tests/test_pipeline_parallel.py:421);
   BIT's train-mode gradients within 1e-2 of each tensor's largest entry
   against JAX and within 2e-3 against a float64 run of the port
   (tests/test_torch_bit.py, ROADMAP.md Queue 3 known issue 3).
3. CDTrainer(pp_stages=2) at data 2 (BIT, augmentation on) and
   pp_stages=4 (V6, dropout off) equal the one-process trainer: the loss
   within 1e-5 relative, the counts exactly, every state tensor after one
   SGD step within STATE_SHARE of max(1, its largest magnitude), the same on
   every rank. ChangeGNNV2 at pp_stages=4 equals one process with the route
   on and no stage axis (its pipelined stages run frozen-BN, JAX's documented
   deviation, so the plain one-process step is not its reference).
4. The dropout rows: attention_plain with dropout_rows (o, t) equals the
   rows of JAX's _einsum_attention on the global array, for a data shard
   and for a microbatch of one; on the data 2 x stage 2 grid a stage's
   microbatch row p holds global row i B / m + d + D p, which its RowMap
   (off d, stride D) names; a pipelined V6 with only attention dropout on
   gives its two microbatches the same seeds and rows (so the same masks),
   every stage another seed, and leaves every rank's generator in one state.
5. cli.train_cd --pp_stages 2 on 2 ranks trains what one process trains.
6. Refusals: a CNN net_G, ChangeFormer V1-V3, V4 at S = 4, a stage count
   that does not divide BIT's depth, space x stage, B % m != 0, and
   tp_axis 2 or pp_stages 2 in one process (which say how to launch).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 32
WORKER_TIMEOUT = 300
# job: ranks (stage 2, stage 4, data 2 x stage 2; "one" is one process, no group)
JOBS = {"s2": 2, "s4": 4, "d2s2": 4, "one": 1}
STAGES = {"s2": 2, "s4": 4, "d2s2": 2}
TOY_CASES = {"s2": (2, 4), "s4": (2, 4), "d2s2": (2,)}  # job: microbatch counts
JAX_TOY_CASES = ((2, 2), (4, 4))  # (S, m) held against JAX's gpipe
# Microbatching splits rows only, so the pipelined sums are the sequential ones but
# for the blocking of the matmuls over fewer rows and the order of the per-microbatch
# gradient sums; against JAX, XLA's float32 products (at the highest precision) stand
# for MKL's. Both within 1e-5 of each tensor's largest magnitude (measured on a CPU
# host: 9.8e-6 absolute on a parameter gradient of 0.65 in a tensor reaching 150; 3.1e-6
# on an output of 0.16 in a tensor reaching 9).
TOY_SHARE = 1e-5
ROUTE_TOL = 2e-4  # tests/test_pipeline_parallel.py:421
# One SGD step (lr 0.01, momentum 0.99, weight decay 5e-4) of the pipelined trainer
# against one process: the sums of BatchNorm, the loss and the gradients run in
# another order, the encoder's matmuls over microbatches (measured on a CPU host:
# 7.6e-7 of max(1, |w|) for BIT at data 2 x stage 2, 2.1e-6 for V6 at stage 4 with 4
# pairs). V6 takes 4 pairs: its decoder's deepest train-mode BatchNorm sees batch x 1
# x 1 values a channel at 32x32, and at 2 pairs it turns the encoder's float32 noise
# into 4.7e-6 (measured).
STATE_SHARE = 3.2e-6
# cli.train_cd: two SGD steps; measured as STATE_SHARE above
CLI_SHARE = 1e-5
N_ROUTE = {"bit": 2, "v6": 2, "vig": 2}  # pairs a batch of the route checks
# BIT at tests/test_torch_bit.py's size: there JAX's float32 gradients are within 3.7e-3
# of a float64 run (measured; the port's within 8e-6); at 32x32 with 4 pairs JAX's are
# 3.5e-2 off it at resnet.layer2.1.conv2 (the port's 3.4e-6), past the 1e-2 bound.
ROUTE_HW = {"bit": 64, "v6": HW, "vig": HW}


# --------------------------------------------------------------------------
# shared by the ranks and the parent (no JAX)
# --------------------------------------------------------------------------

def _toy_inputs(seed=0, depth=8, batch=8, dim=16):
    """The homogeneous toy of tests/test_pipeline_parallel.py:23-34, drawn with numpy."""
    rng = np.random.default_rng(seed)
    blocks = [{"w": (rng.standard_normal((dim, dim)) * 0.3).astype(np.float32),
               "b": (rng.standard_normal(dim) * 0.1).astype(np.float32)}
              for _ in range(depth)]
    x = rng.standard_normal((batch, dim)).astype(np.float32)
    skip = (rng.standard_normal((batch, dim)) * 0.1).astype(np.float32)
    return blocks, x, skip


def _hetero_inputs(seed=1, batch=8):
    """The heterogeneous toy of tests/test_pipeline_parallel.py:244-279."""
    rng = np.random.default_rng(seed)
    params = [{"w": (rng.standard_normal((4, 8)) * 0.4).astype(np.float32)},
              {"w": (rng.standard_normal((8, 16)) * 0.4).astype(np.float32),
               "b": np.full(16, 0.1, np.float32)},
              {"w": (rng.standard_normal((16, 16)) * 0.4).astype(np.float32)},
              {"w": (rng.standard_normal((16, 8)) * 0.4).astype(np.float32)}]
    x0 = rng.standard_normal((batch, 8, 8, 4)).astype(np.float32)
    return params, x0


def _pool2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))


def _hetero_fns(n_stages, aux):
    """The toy's stages as torch functions of (params, act): (B,8,8,4) ->
    (B,4,4,8) -> (B,2,2,16) -> (x, pooled) -> (B,8); with 2 stages the first
    two. With ``aux`` each also returns a per-row sum of its output."""
    def s0(p, x):
        return torch.tanh(_pool2(x) @ p["w"])

    def s1(p, x):
        return torch.tanh(_pool2(x) @ p["w"] + p["b"])

    def s2(p, x):
        y = torch.tanh(x @ p["w"]) + x
        return y, y.mean(dim=(1, 2))

    def s3(p, d):
        return d[1] @ p["w"] + d[0].sum(dim=(1, 2, 3))[:, None]

    fns = [s0, s1, s2, s3][:n_stages]
    if not aux:
        return fns

    def with_aux(f):
        def g(p, a):
            y = f(p, a)
            leaf = y[1] if isinstance(y, tuple) else y
            return y, leaf.reshape(leaf.shape[0], -1).sum(-1)
        return g
    return [with_aux(f) for f in fns]


def _leaf_params(tree):
    return [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()} for p in tree]


def _toy_run(kind, n_stages, n_micro, rows=slice(None), sequential=False):
    """One toy case through gpipe / gpipe_hetero (``sequential``: the stages
    in sequence in this process, the reference): the loss sum(out^2) (+ the
    aux sums of squares), the output, the aux outputs, the gradients of the
    input leaves and of each stage's parameters (None where this rank holds
    no gradient). ``rows``: this rank's rows of the batch (a data shard)."""
    from stcd_tpu_torch.parallel.pipeline import gpipe, gpipe_hetero

    if kind == "homo":
        blocks, x, skip = _toy_inputs()
        params = _leaf_params(blocks)
        act = tuple(torch.tensor(t[rows], requires_grad=True) for t in (x, skip))
        fns = [lambda a, p=p: (torch.tanh(a[0] @ p["w"] + p["b"]) + a[1], a[1])
               for p in params]
        if sequential:
            out = act
            for f in fns:
                out = f(out)
        else:
            out = gpipe(fns, act, n_micro=n_micro)
        auxes = []
        out = out[0]
    else:
        tree, x0 = _hetero_inputs()
        params = _leaf_params(tree[:n_stages])
        aux = kind == "hetero_aux"
        fns = [lambda a, f=f, p=p: f(p, a) for f, p in zip(_hetero_fns(n_stages, aux), params)]
        act = (torch.tensor(x0[rows], requires_grad=True),)
        if sequential:
            out, auxes = act[0], []
            for f in fns:
                out = f(out)
                if aux:
                    out, a = out
                    auxes.append(a)
        else:
            got = gpipe_hetero(fns, act[0], n_micro=n_micro, collect_aux=aux)
            out, auxes = got if aux else (got, [])
    loss = (out ** 2).sum() + sum((a ** 2).sum() for a in auxes)
    loss.backward()
    grad = lambda t: None if t.grad is None else t.grad.clone()  # noqa: E731
    return {"loss": loss.item(), "out": out.detach().clone(),
            "aux": [a.detach().clone() for a in auxes],
            "g_in": [grad(t) for t in act],
            "g_params": [{k: grad(t) for k, t in p.items()} for p in params]}


def _batch(n, seed):
    """(a, b, label): uint8 NHWC pairs and a (n, HW, HW, 1) float label."""
    rng = np.random.default_rng(seed)
    a, b = (torch.from_numpy(rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8))
            for _ in range(2))
    label = torch.from_numpy((rng.uniform(size=(n, HW, HW, 1)) > 0.7).astype(np.float32))
    return a, b, label


def _trainer_step(net_G, pp, n, seed, rows=slice(None), route=False, augment=False, tmp="."):
    """One CDTrainer train_step and eval_step of ``net_G`` with dropout off, on
    this rank's ``rows`` of a global batch of ``n``: (loss, train counts, eval
    counts, state_dict). ``route``: the pipeline route on in one process."""
    from stcd_tpu_torch.parallel import pipeline as pp_mod
    from stcd_tpu_torch.tools.check_pipeline import no_dropout
    from stcd_tpu_torch.train.trainer import CDTrainer, TrainerConfig

    cfg = TrainerConfig(net_G=net_G, img_size=HW, batch_size=n, device="cpu",
                        pp_stages=pp, augment=augment, checkpoint_dir=tmp)
    trainer = CDTrainer(cfg, steps_per_epoch=2)
    if route:
        pp_mod.set_pipeline(trainer.model, None)
    state = trainer.init_state("cpu", init_seed=seed)
    no_dropout(state.model)
    a, b, label = (t[rows] for t in _batch(n, seed + 1))
    loss, cm = trainer.train_step(state, a, b, label)
    _, cm_eval = trainer.eval_step(state, a, b, label)
    return {"loss": loss.item(), "cm": cm.clone(), "cm_eval": cm_eval.clone(),
            "state": {k: v.clone() for k, v in state.model.state_dict().items()}}


def _route_model(kind, sd):
    from stcd_tpu_torch.models.factory import define_G

    model = define_G(ROUTE_NETS[kind], img_size=ROUTE_HW[kind])
    model.load_state_dict(sd)
    return model


ROUTE_NETS = {"bit": "base_transformer_pos_s4_dd8", "v6": "ChangeFormerV6",
              "vig": "ChangeGNNV2"}


def _route_eval(kind, sd, x1, x2, n_micro):
    """The route's eval logits (the last output of a list), NHWC numpy."""
    from stcd_tpu_torch.parallel import pipeline as pp_mod

    model = _route_model(kind, sd).eval()
    fwd = {"bit": pp_mod.bit_pipeline_forward, "v6": pp_mod.changeformer_pipeline_forward,
           "vig": pp_mod.changevig_pipeline_forward}[kind]
    with torch.no_grad():
        out = fwd(model, x1, x2, n_micro=n_micro)
    out = out[-1] if isinstance(out, (list, tuple)) else out
    return out.permute(0, 2, 3, 1).numpy()


def _bit_train_grads(sd, x1, x2, label, n_micro):
    """BIT through bit_pipeline_forward in train mode: the CE loss and this
    rank's parameter gradients (None where it holds none)."""
    from stcd_tpu_torch.losses.functional import cross_entropy
    from stcd_tpu_torch.parallel import pipeline as pp_mod

    model = _route_model("bit", sd).train()
    loss = cross_entropy(pp_mod.bit_pipeline_forward(model, x1, x2, n_micro=n_micro), label)
    loss.backward()
    return {"loss": loss.item(),
            "grads": {k: None if p.grad is None else p.grad.clone()
                      for k, p in model.named_parameters()}}


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _layout_probe(n_global, n_micro, stages):
    """The data x stage layout: a global batch whose row values are their
    indices through gpipe_hetero with identity stages that record, per
    microbatch, the rows they got and their stochastic layers' RowMap."""
    from stcd_tpu_torch.layers.stochastic import Stochastic
    from stcd_tpu_torch.parallel import distributed
    from stcd_tpu_torch.parallel.pipeline import gpipe_hetero, stage_draws, with_draws

    class Probe(Stochastic):
        def __init__(self):
            super().__init__()
            self.seen = []

        def forward(self, x):
            if not isinstance(x, torch.Tensor) or type(x) is not torch.Tensor:
                return x + 0.0  # the shape pass
            r = self.rows
            self.seen.append({"ids": x[:, 0].long().tolist(), "off": r.off,
                              "stride": r.stride, "rows": r.rows.tolist()})
            return x + 0.0

    probes = [Probe() for _ in range(stages)]
    ids = torch.arange(n_global, dtype=torch.float32)[:, None].repeat(1, 2)
    local = ids[distributed.global_batch_sharding()]
    draws = stage_draws(probes, local.shape[0] // n_micro, "cpu")
    fns = [with_draws(p, p, d) for p, d in zip(probes, draws)]
    with torch.no_grad():
        gpipe_hetero(fns, local, n_micro=n_micro, stage_modules=probes)
    return probes[distributed.stage_rank()].seen


def _attention_masks(n_micro):
    """A pipelined V6 train step with only the attention dropout on (the
    encoder's stages at S = 4, ``n_micro`` microbatches of 2 rows): this
    rank's attention calls (seed, rows, shape) and its generator's state."""
    from stcd_tpu_torch.models import changeformer
    from stcd_tpu_torch.tools.check_pipeline import ATTN_DROPOUT, no_dropout
    from stcd_tpu_torch.train.trainer import CDTrainer, TrainerConfig

    calls = []
    plain = changeformer.cross_attention

    def record(q, k, v, scale=None, dropout_rate=0.0, dropout_seed=None, impl=None,
               dropout_rows=(0, 1), dropout_heads=None):
        if dropout_rate > 0.0:
            calls.append({"seed": int(dropout_seed), "rows": tuple(dropout_rows),
                          "shape": (tuple(q.shape), k.shape[2])})
        return plain(q, k, v, scale, dropout_rate, dropout_seed, impl, dropout_rows,
                     dropout_heads)

    changeformer.cross_attention = record
    try:
        trainer = CDTrainer(TrainerConfig(net_G="ChangeFormerV6", img_size=HW, device="cpu",
                                          pp_stages=4, pp_microbatches=n_micro),
                            steps_per_epoch=2)
        state = trainer.init_state("cpu", init_seed=5)
        no_dropout(state.model, attention=ATTN_DROPOUT)
        trainer.train_step(state, *_batch(n_micro, 6))
    finally:
        changeformer.cross_attention = plain
    return {"calls": calls, "generator": state.generator.get_state()}


def _worker(job: str, rank: int, tmp: str) -> int:
    """Rank ``rank`` of ``job`` (JOBS): writes what it computed to
    ``{job}_rank{rank}.pt``."""
    sys.modules["tensorflow"] = None  # tensorboard's import of TF may import JAX
    torch.set_num_threads(1)
    from stcd_tpu_torch.parallel import distributed
    from stcd_tpu_torch.parallel.mesh import create_mesh

    if job == "one":
        out = _one_process(tmp)
        torch.save(out, os.path.join(tmp, "one_rank0.pt"))
        return 0
    world, stages = JOBS[job], STAGES[job]
    distributed.initialize("cpu", init_method="file://" + os.path.join(tmp, f"rdv_{job}"),
                           world_size=world, rank=rank)
    create_mesh(stage=stages)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    rows = distributed.global_batch_sharding()
    out = {"toys": {(kind, m): _toy_run(kind, stages, m, rows)
                    for kind in ("homo", "hetero", "hetero_aux") for m in TOY_CASES[job]}}
    if job == "s2":
        r = inputs["routes"]["bit"]
        out["bit_eval"] = _route_eval("bit", r["sd"], r["x1"], r["x2"], 2)
        out["bit_train"] = _bit_train_grads(r["sd"], r["x1"], r["x2"], r["label"], 2)
        try:
            _toy_run("hetero", 2, 2, slice(0, 3))
            out["indivisible"] = None
        except ValueError as e:
            out["indivisible"] = str(e)
        from stcd_tpu_torch.cli import train_cd
        got = train_cd.main(CLI_ARGS + ["--checkpoint_dir", os.path.join(tmp, "cli_pp"),
                                        "--pp_stages", "2"])
        out["cli"] = {"state": got["state"].model.state_dict(), "scores": got["scores"]}
    elif job == "s4":
        for kind in ("v6", "vig"):
            r = inputs["routes"][kind]
            out[f"{kind}_eval"] = _route_eval(kind, r["sd"], r["x1"], r["x2"], 4)
        out["v6_trainer"] = _trainer_step("ChangeFormerV6", 4, 4, seed=3, tmp=tmp)
        out["vig_trainer"] = _trainer_step("ChangeGNNV2", 4, 2, seed=4, tmp=tmp)
        out["masks"] = _attention_masks(2)
    else:
        out["bit_trainer"] = _trainer_step("base_transformer_pos_s4_dd8", 2, 4, seed=2,
                                           rows=rows, augment=True, tmp=tmp)
        out["layout"] = _layout_probe(8, 2, stages)
    out["jax_imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "stcd_tpu"))
    torch.save(out, os.path.join(tmp, f"{job}_rank{rank}.pt"))
    distributed.barrier("done")
    return 0


CLI_ARGS = ["--device", "cpu", "--dataset_name", "synthetic", "--img_size", str(HW),
            "--batch_size", "2", "--synthetic_length", "4", "--max_epochs", "1",
            "--n_cpu", "1"]


# --------------------------------------------------------------------------
# the parent: references, spawn, checks
# --------------------------------------------------------------------------

def _routes_inputs():
    """Per route: the port's seeded state_dict, the NCHW inputs and BIT's
    label (for the ranks), and JAX's model with the same weights and the
    NHWC inputs (for the parent)."""
    from stcd_tpu_torch.models.factory import define_G, init_weights

    out = {}
    for seed, kind in enumerate(ROUTE_NETS, start=1):
        sd = init_weights(define_G(ROUTE_NETS[kind], img_size=ROUTE_HW[kind]),
                          seed).state_dict()
        rng = np.random.default_rng(10 + seed)
        for name, v in sd.items():  # norm scales, biases and statistics off their init
            if name.endswith(("running_var", "norm.weight", "bn.weight")) or (
                    name.endswith(".weight") and v.dim() == 1):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
            elif name.endswith(("running_mean", ".bias")):
                v.copy_(torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32)))
        n, hw = N_ROUTE[kind], ROUTE_HW[kind]
        a, b = (rng.standard_normal((n, hw, hw, 3)).astype(np.float32) for _ in range(2))
        label = rng.integers(0, 2, (n, hw, hw)).astype(np.int64)
        out[kind] = {"sd": sd, "x1": torch.from_numpy(a.transpose(0, 3, 1, 2).copy()),
                     "x2": torch.from_numpy(b.transpose(0, 3, 1, 2).copy()),
                     "label": torch.from_numpy(label), "a": a, "b": b}
    return out


def _jax_model(kind, sd):
    """JAX's model of the route and its variables from the port's state_dict."""
    from stcd_tpu.convert import torch_to_flax as t2f
    from stcd_tpu.models.factory import define_G as jax_define_G

    sd = {k: v.numpy() for k, v in sd.items()}
    if kind == "bit":
        params, stats = t2f.convert_bit(sd, dec_depth=8, resnet_stages_num=4)
    elif kind == "v6":
        params, stats = t2f.convert_changeformer_v6(sd, depths=(3, 3, 4, 3))
    else:
        params, stats = t2f.convert_changevig(sd, "gnn_v2")
    return jax_define_G(ROUTE_NETS[kind], img_size=ROUTE_HW[kind]), {"params": params,
                                                         "batch_stats": stats}


def _jax_routes(routes):
    """JAX's wrappers: eval logits of the three routes, BIT's train loss and
    gradients (as port state_dict names)."""
    import jax
    import jax.numpy as jnp
    from stcd_tpu.losses.functional import cross_entropy
    from stcd_tpu.parallel.mesh import create_mesh
    from stcd_tpu.parallel.pipeline import (bit_pipeline_forward,
                                            changeformer_pipeline_forward,
                                            changevig_pipeline_forward)
    from stcd_tpu_torch.convert.from_flax import bit_from_flax

    out = {}
    for kind, fwd, stages, m in (("bit", bit_pipeline_forward, 2, 2),
                                 ("v6", changeformer_pipeline_forward, 4, 4),
                                 ("vig", changevig_pipeline_forward, 4, 4)):
        jmodel, variables = _jax_model(kind, routes[kind]["sd"])
        mesh = create_mesh(stage=stages)
        pred = jax.jit(lambda v, x1, x2: fwd(jmodel, v, x1, x2, mesh=mesh, n_micro=m))(
            variables, jnp.asarray(routes[kind]["a"]), jnp.asarray(routes[kind]["b"]))
        out[kind] = np.asarray(pred[-1] if isinstance(pred, (list, tuple)) else pred)
    jmodel, variables = _jax_model("bit", routes["bit"]["sd"])
    a, b, label = (routes["bit"][k] for k in ("a", "b", "label"))
    label = label.numpy()
    mesh = create_mesh(stage=2)

    def loss_fn(params):
        logits, stats = bit_pipeline_forward(
            jmodel, {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(a), jnp.asarray(b), mesh=mesh, n_micro=2, train=True)
        return cross_entropy(logits, jnp.asarray(label.astype(np.int32))), stats

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    out["bit_loss"] = float(loss)
    out["bit_grads"] = bit_from_flax(grads, stats)
    return out


def _jax_toys():
    """JAX's gpipe / gpipe_hetero on the 8-device mesh: per (S, kind, m) the
    output, the aux outputs and the gradients of the loss of _toy_run."""
    import jax
    import jax.numpy as jnp
    from stcd_tpu.parallel.mesh import create_mesh
    from stcd_tpu.parallel.pipeline import gpipe, gpipe_hetero, stack_params

    def pool2(x):
        b, h, w, c = x.shape
        return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))

    stages = [lambda p, x: jnp.tanh(pool2(x) @ p["w"]),
              lambda p, x: jnp.tanh(pool2(x) @ p["w"] + p["b"]),
              lambda p, x: (lambda y: (y, y.mean(axis=(1, 2))))(jnp.tanh(x @ p["w"]) + x),
              lambda p, d: d[1] @ p["w"] + d[0].sum(axis=(1, 2, 3))[:, None]]

    def with_aux(f):
        def g(p, a):
            y = f(p, a)
            leaf = y[1] if isinstance(y, tuple) else y
            return y, leaf.reshape(leaf.shape[0], -1).sum(-1)
        return g

    blocks, x, skip = _toy_inputs()
    tree, x0 = _hetero_inputs()
    out = {}
    for s, m in JAX_TOY_CASES:
        mesh = create_mesh(stage=s)

        def homo(p, act):
            y, _ = gpipe(lambda q, a: (jnp.tanh(a[0] @ q["w"] + q["b"]) + a[1], a[1]),
                         p, act, mesh=mesh, n_micro=m)
            return jnp.sum(y ** 2), (y, [])

        (loss, (y, _)), (gp, ga) = jax.jit(jax.value_and_grad(homo, (0, 1), has_aux=True))(
            stack_params([{k: jnp.asarray(v) for k, v in blk.items()} for blk in blocks]),
            (jnp.asarray(x), jnp.asarray(skip)))
        out[(s, "homo", m)] = {"out": np.asarray(y), "aux": [],
                               "g_in": [np.asarray(g) for g in ga],
                               "g_params": [{k: np.asarray(v[i]) for k, v in gp.items()}
                                            for i in range(len(blocks))]}
        for aux in (False, True):
            fns = [with_aux(f) if aux else f for f in stages[:s]]

            def hetero(ps, a):
                got = gpipe_hetero(fns, ps, a, mesh=mesh, n_micro=m, collect_aux=aux)
                y, auxes = got if aux else (got, [])
                return jnp.sum(y ** 2) + sum(jnp.sum(t ** 2) for t in auxes), (y, auxes)

            ps = [{k: jnp.asarray(v) for k, v in p.items()} for p in tree[:s]]
            (loss, (y, auxes)), (gp, ga) = jax.jit(
                jax.value_and_grad(hetero, (0, 1), has_aux=True))(ps, jnp.asarray(x0))
            out[(s, "hetero_aux" if aux else "hetero", m)] = {
                "out": np.asarray(y), "aux": [np.asarray(t) for t in auxes],
                "g_in": [np.asarray(ga)],
                "g_params": [{k: np.asarray(v) for k, v in p.items()} for p in gp]}
    return out


def _one_process(tmp):
    """The one-process references (the "one" job): the toys in sequence, the
    trainer steps, the routes' eval logits without a stage axis, BIT's
    float64 gradients, cli.train_cd without --pp_stages."""
    from stcd_tpu_torch.cli import train_cd

    routes = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)["routes"]
    out = {"toys": {(s, kind, m): _toy_run(kind, s, m, sequential=True)
                    for s in (2, 4) for kind in ("homo", "hetero", "hetero_aux")
                    for m in (2, 4)},
           "bit_trainer": _trainer_step("base_transformer_pos_s4_dd8", 1, 4, seed=2,
                                        augment=True, tmp=tmp),
           "v6_trainer": _trainer_step("ChangeFormerV6", 1, 4, seed=3, tmp=tmp),
           "vig_trainer": _trainer_step("ChangeGNNV2", 1, 2, seed=4, route=True, tmp=tmp),
           "bit_train64": _bit_float64_grads(routes["bit"])}
    for kind in ROUTE_NETS:
        r = routes[kind]
        out[f"{kind}_eval"] = _route_eval(kind, r["sd"], r["x1"], r["x2"], None)
    got = train_cd.main(CLI_ARGS + ["--checkpoint_dir", os.path.join(tmp, "cli_one")])
    out["cli"] = {"state": got["state"].model.state_dict(), "scores": got["scores"]}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Prepare the inputs, spawn the ranks, compute the one-process and JAX
    references while they run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    routes = _routes_inputs()
    torch.save({"routes": routes}, os.path.join(tmp, "inputs.pt"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [(job, subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", job, str(r), tmp],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for job, world in JOBS.items() for r in range(world)]
    try:
        jax_ref = {"jax_routes": _jax_routes(routes), "jax_toys": _jax_toys()}
        logs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for _, p in procs]
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
        torch.set_num_threads(threads)
    for (job, p), log in zip(procs, logs):
        assert p.returncode == 0, f"a rank of {job}:\n{log[-4000:]}"
    ranks = {job: [torch.load(os.path.join(tmp, f"{job}_rank{r}.pt"), weights_only=False)
                   for r in range(world)] for job, world in JOBS.items()}
    ref = {**ranks.pop("one")[0], **jax_ref}
    yield {"ranks": ranks, "ref": ref, "routes": routes}


def _bit_float64_grads(r):
    from stcd_tpu_torch.models.factory import define_G

    model = define_G(ROUTE_NETS["bit"]).double().train()
    model.load_state_dict(r["sd"])
    loss = torch.nn.functional.cross_entropy(model(r["x1"].double(), r["x2"].double()),
                                             r["label"])
    loss.backward()
    return {k: p.grad for k, p in model.named_parameters()}


def _share(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


# --- 1. gpipe / gpipe_hetero on toy stages ---

def _toy_cases():
    return [(job, kind, m) for job in TOY_CASES for kind in ("homo", "hetero", "hetero_aux")
            for m in TOY_CASES[job]]


def _stage_of(kind, stages, i):
    """The stage that runs parameter set i of the toy."""
    return i // (8 // stages) if kind == "homo" else i


@pytest.mark.parametrize("job,kind,m", _toy_cases(),
                         ids=[f"{j}-{k}-m{m}" for j, k, m in _toy_cases()])
def test_toy_pipeline_equals_sequential_and_jax(run, job, kind, m):
    stages = STAGES[job]
    ranks = run["ranks"][job]
    want = run["ref"]["toys"][(stages, kind, m)]
    jax_want = run["ref"]["jax_toys"].get((stages, kind, m))
    n_data = len(ranks) // stages

    def check(got, ref, rows, what):
        assert _share(got, ref[rows]) <= TOY_SHARE, what

    def check_jax(got, ref, rows, what):
        if jax_want is not None:
            check(got, ref, rows, what + " against JAX")

    for r, got in enumerate(ranks):
        rows = slice(r // stages, None, n_data)
        got = got["toys"][(kind, m)]
        for fn, ref in ((check, want), (check_jax, jax_want)):
            if ref is None:
                continue
            fn(got["out"], ref["out"], rows, "output")
            for k, (g, w) in enumerate(zip(got["aux"], ref["aux"])):
                fn(g, w, rows, f"aux {k}")
            for k, (g, w) in enumerate(zip(got["g_in"], ref["g_in"])):
                fn(g, w, rows, f"input gradient {k}")
    # a stage's parameter gradients: on its owner only; over the data shards they sum to
    # the gradient of the whole batch
    for i, w in enumerate(want["g_params"]):
        owner = _stage_of(kind, stages, i)
        total = None
        for r, got in enumerate(ranks):
            g = got["toys"][(kind, m)]["g_params"][i]
            if r % stages != owner:
                assert all(v is None for v in g.values()), (r, i)
                continue
            total = g if total is None else {k: total[k] + g[k] for k in g}
        for k in w:
            check(total[k], w[k], slice(None), f"params {i} {k}")
            check_jax(total[k], jax_want["g_params"][i][k] if jax_want else None,
                      slice(None), f"params {i} {k}")


# --- 2. the three routes against the JAX wrappers ---

@pytest.mark.parametrize("kind,job", [("bit", "s2"), ("v6", "s4"), ("vig", "s4")])
def test_route_eval_logits_equal_jax_wrapper(run, kind, job):
    want = run["ref"]["jax_routes"][kind]
    for rank in run["ranks"][job]:
        got = rank[f"{kind}_eval"]
        np.testing.assert_allclose(got, want, rtol=ROUTE_TOL, atol=ROUTE_TOL)
        np.testing.assert_allclose(got, run["ref"][f"{kind}_eval"], rtol=ROUTE_TOL,
                                   atol=ROUTE_TOL)


def test_bit_route_train_gradients_equal_jax_and_float64(run):
    """Each parameter's gradient from the rank that holds it (the decoder's
    blocks: its stage's; the rest: every rank, the same) within 1e-2 of its
    largest entry against JAX and 2e-3 against a float64 run of the port;
    the loss within 1e-5 of JAX's."""
    from test_torch_changeformer_train import _assert_close

    ranks = run["ranks"]["s2"]
    jax_grads, exact = run["ref"]["jax_routes"]["bit_grads"], run["ref"]["bit_train64"]
    for rank in ranks:
        np.testing.assert_allclose(rank["bit_train"]["loss"],
                                   run["ref"]["jax_routes"]["bit_loss"], rtol=1e-5)
    for name in exact:
        held = [r["bit_train"]["grads"][name] for r in ranks
                if r["bit_train"]["grads"][name] is not None]
        if name.startswith("transformer_decoder."):
            block = int(name.split(".")[2])
            assert len(held) == 1 and ranks[block // 4]["bit_train"]["grads"][name] is not None
        else:
            assert len(held) == len(ranks) and all(torch.equal(h, held[0]) for h in held)
        _assert_close(held[0].numpy(), jax_grads[name].numpy(), 1e-2, f"grad of {name}")
        _assert_close(held[0].numpy(), exact[name].numpy(), 2e-3,
                      f"grad of {name} against float64")


# --- 3. CDTrainer(pp_stages) against one process ---

@pytest.mark.parametrize("name,job", [("bit_trainer", "d2s2"), ("v6_trainer", "s4"),
                                      ("vig_trainer", "s4")])
def test_cdtrainer_pipeline_equals_one_process(run, name, job):
    want = run["ref"][name]
    ranks = [r[name] for r in run["ranks"][job]]
    for got in ranks:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert torch.equal(got["cm"], want["cm"])
        assert torch.equal(got["cm_eval"], want["cm_eval"])
        for k, w in want["state"].items():
            if w.is_floating_point():
                assert _share(got["state"][k], w) <= STATE_SHARE, k
            else:
                assert torch.equal(got["state"][k], w), k
    for got in ranks[1:]:  # every rank ends the step with one state
        for k, w in ranks[0]["state"].items():
            assert torch.equal(got["state"][k], w), k


# --- 4. the dropout rows ---

@pytest.mark.parametrize("n_data,n_micro", [(2, 1), (2, 2), (4, 2)])
def test_attention_plain_rows_equal_jax_global_mask(n_data, n_micro):
    """A data shard's rows d::D (and a microbatch of them), hashed at
    dropout_rows (d, D), keep the attention weights that JAX's
    _einsum_attention keeps on the global array (the global microbatch)."""
    import jax.numpy as jnp
    from stcd_tpu.ops.attention import _einsum_attention
    from stcd_tpu_torch.ops.attention import attention_plain

    rng = np.random.default_rng(n_data * 10 + n_micro)
    b, h, n, m, d = 8, 2, 6, 5, 4
    q, k, v = (rng.standard_normal((b, h, x, d)).astype(np.float32) for x in (n, m, m))
    seed, rate = 1234567, 0.3
    rows_g = b // n_micro
    for i in range(n_micro):
        glob = slice(i * rows_g, (i + 1) * rows_g)
        want = np.asarray(_einsum_attention(*(jnp.asarray(t[glob]) for t in (q, k, v)),
                                            0.5, rate, seed))
        for shard in range(n_data):
            local = [t[shard::n_data] for t in (q, k, v)]  # the shard's rows
            per = local[0].shape[0] // n_micro
            mb = [torch.from_numpy(t[i * per:(i + 1) * per]) for t in local]
            got = attention_plain(*mb, 0.5, rate, seed, dropout_rows=(shard, n_data))
            np.testing.assert_allclose(got.numpy(), want[shard::n_data], rtol=1e-6, atol=1e-6)
    base = [torch.from_numpy(t) for t in (q, k, v)]
    assert torch.equal(attention_plain(*base, 0.5, rate, seed),
                       attention_plain(*base, 0.5, rate, seed, dropout_rows=(0, 1)))


def test_microbatch_rows_on_the_data_stage_grid(run):
    """Stage s of data shard d, microbatch i, row p holds global row
    i B / m + d + D p, and the RowMap its layers draw with says so."""
    n_global, n_micro, n_data = 8, 2, 2
    for r, rank in enumerate(run["ranks"]["d2s2"]):
        d = r // STAGES["d2s2"]
        seen = rank["layout"]
        assert len(seen) == n_micro
        for i, rec in enumerate(seen):
            assert (rec["off"], rec["stride"]) == (d, n_data)
            want = [i * n_global // n_micro + d + n_data * p for p in range(len(rec["ids"]))]
            assert rec["ids"] == want
            assert rec["rows"] == [d + n_data * p for p in range(len(rec["ids"]))]


def test_stage_masks_repeat_across_microbatches_and_generators_agree(run):
    ranks = [r["masks"] for r in run["ranks"]["s4"]]
    seeds = []
    for rank in ranks:
        calls = rank["calls"]
        assert calls and len(calls) % 2 == 0
        half = len(calls) // 2  # the two microbatches, in order
        assert calls[:half] == calls[half:]
        assert all(c["rows"] == (0, 1) for c in calls)
        seeds.append({c["seed"] for c in calls})
    for a in range(len(seeds)):  # each stage draws its own
        for b in range(a + 1, len(seeds)):
            assert not seeds[a] & seeds[b]
    for rank in ranks[1:]:
        assert torch.equal(rank["generator"], ranks[0]["generator"])


# --- 5. the CLI ---

def test_cli_train_cd_pp_stages_trains_what_one_process_trains(run):
    want = run["ref"]["cli"]
    for rank in run["ranks"]["s2"]:
        got = rank["cli"]
        for k, w in want["state"].items():
            if w.is_floating_point():
                assert _share(got["state"][k], w) <= CLI_SHARE, k
        assert got["scores"] == pytest.approx(want["scores"], rel=1e-6, abs=1e-9)
    for rank in run["ranks"].values():
        assert all(r["jax_imported"] == [] for r in rank)


# --- 6. refusals ---

@pytest.mark.parametrize("net_G", ["SiamUnet_abs", "ChangeFormerV1", "ChangeFormerV2",
                                   "ChangeFormerV3"])
def test_pp_stages_refuses_a_model_without_a_route(net_G):
    from stcd_tpu_torch.train.trainer import CDTrainer, TrainerConfig

    with pytest.raises(NotImplementedError, match="pipelines the BIT transformer-decoder"):
        CDTrainer(TrainerConfig(net_G=net_G, img_size=HW, pp_stages=4, device="cpu"),
                  steps_per_epoch=1)


@pytest.mark.parametrize("net_G,stages,match", [
    ("ChangeFormerV4", 4, "has 5 stages"), ("ChangeFormerV6", 2, "has 4 stages"),
    ("base_transformer_pos_s4_dd8", 3, "depth 8 does not divide"),
    ("base_transformer_pos_s4_dd8", 2, "torchrun --nproc_per_node 2")])
def test_pp_stages_refuses_a_count_the_model_or_launch_does_not_take(net_G, stages, match):
    from stcd_tpu_torch.train.trainer import CDTrainer, TrainerConfig

    with pytest.raises(ValueError, match=match):
        CDTrainer(TrainerConfig(net_G=net_G, img_size=HW, pp_stages=stages, device="cpu"),
                  steps_per_epoch=1)


def test_tensor_parallel_and_space_by_stage_refused():
    from stcd_tpu_torch.parallel.mesh import create_mesh
    from stcd_tpu_torch.train.trainer import CDTrainer, TrainerConfig

    with pytest.raises(ValueError, match="'model' axis of 2 .* torchrun --nproc_per_node 2"):
        CDTrainer(TrainerConfig(tp_axis=2, device="cpu"), steps_per_epoch=1)
    with pytest.raises(NotImplementedError, match="No counterpart"):
        create_mesh(space=2, stage=2)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        create_mesh(model=2)


def test_microbatches_must_divide_the_batch(run):
    for rank in run["ranks"]["s2"]:
        assert rank["indivisible"] == "batch 3 not divisible by n_micro 2"


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.exit(_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
