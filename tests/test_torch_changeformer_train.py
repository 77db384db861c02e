"""stcd_tpu_torch ChangeFormerV6 in train mode and the ported trainer step
against the JAX package, float32 on the CPU, on one set of weights.

Bernoulli streams cannot match across frameworks, so the comparison is held
in layers:

(a) SRAttention with attn_drop 0.1: the attention mask is a stateless hash of
    a uint32 seed, so both sides get the same seed (a test-local patch of
    ``jax.random.bits`` and of the port's ``draw_seed``) and forward and
    gradients are compared;
(b) the narrow V6 of test_torch_changeformer.py in train mode (BatchNorm on
    batch statistics, running statistics updated, attention dropout live with
    the shared seed), with every Bernoulli dropout and DropPath neutralised on
    both sides inside the test: loss, the gradient of every parameter, the
    running statistics;
(c) three steps of the ported ``CDTrainer.train_step`` against the JAX
    ``CDTrainer.train_step`` for sgd and adamw, the same neutralisation;
(d) with all dropout live: train mode runs, differs from eval, and is
    reproducible from the generator's seed.

Tolerances are stated where they are used; they are relative to each
tensor's largest entry, since gradients span orders of magnitude."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from stcd_tpu.models.changeformer import DecoderTransformerV3, SegFormerEncoder
from stcd_tpu.models.changeformer import SRAttention as JaxSRAttention
from stcd_tpu.train import trainer as jtrainer
from stcd_tpu.train.state import TrainState as JaxTrainState
from stcd_tpu_torch.convert.from_flax import changeformer_v6_from_flax
from stcd_tpu_torch.layers.stochastic import Dropout, DropPath, set_generator
from stcd_tpu_torch.models import changeformer as tcf
from stcd_tpu_torch.train import trainer as ttrainer

from test_torch_changeformer import NARROW, NARROW_EMBED, _inputs, _nchw, _perturb


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread for this file's tests, as tests/test_torch_cli.py
    has: the suite runs several files at once, and at these sizes more threads
    cost CPU time and buy little."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

SEED = 0x5EED1234
N, HW = 2, 64


class JaxNarrowV6Train(nn.Module):
    """JAX ChangeFormerV6.__call__ with the narrow encoder config, the
    encoder's Bernoulli rates at 0 and its attention dropout at V6's 0.1. It
    shares V6's parameter tree (Tenc_x2, TDec_x2)."""

    @nn.compact
    def __call__(self, x1, x2, train=False):
        enc = SegFormerEncoder(first_patch=7, first_stride=4, patch_size=7,
                               qkv_bias=True, drop_rate=0.0, attn_drop_rate=0.1,
                               drop_path_rate=0.0, name="Tenc_x2", **NARROW)
        n = x1.shape[0]
        feats = enc(jnp.concatenate([x1, x2], axis=0), train)
        return DecoderTransformerV3(NARROW_EMBED, 2, False, name="TDec_x2")(
            [f[:n] for f in feats], [f[n:] for f in feats], train)


@pytest.fixture
def shared_seed(monkeypatch):
    """Both frameworks' attention blocks draw SEED; flax's Dropout (ConvDiff's
    hard-coded 0.6) is the identity."""
    monkeypatch.setattr(jax.random, "bits", lambda key, *a, **kw: jnp.uint32(SEED))
    monkeypatch.setattr(tcf, "draw_seed",
                        lambda generator, device: torch.tensor([SEED], device=device))
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)


def _neutralise(model):
    """The port's Bernoulli layers off; SRAttention.attn_drop stays."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
        elif isinstance(mod, DropPath):
            mod.rate = 0.0
    return model


def _label(seed):
    return (np.random.default_rng(seed).uniform(size=(N, HW, HW, 1)) > 0.8).astype(np.float32)


@pytest.fixture(scope="module")
def narrow_init():
    a, b = _inputs(N, HW, seed=0)
    model = JaxNarrowV6Train()
    variables = _perturb(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(a),
                                             jnp.asarray(b)), seed=1)
    return model, variables


def _port_from(variables):
    port = tcf.ChangeFormerV6(embed_dim=NARROW_EMBED, **NARROW)
    port.load_state_dict(changeformer_v6_from_flax(variables["params"],
                                                   variables["batch_stats"]))
    return port


def _assert_close(got, want, tol, what):
    """|got - want| <= tol * max|want| + 1e-7 elementwise. The floor is for
    tensors that are zero analytically, such as the gradient of a conv bias
    ahead of a train-mode BatchNorm, where both sides hold float32 noise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    bound = tol * float(np.abs(want).max()) + 1e-7
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max|err| {err:.3e} > {bound:.3e}"


def test_sra_attention_with_dropout_matches_jax(shared_seed):
    """Forward and the gradients of the input and of every parameter, with
    the attention mask of one seed on both sides; 1e-5 of each tensor's
    largest entry (float32 summation order)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    cot = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    att = JaxSRAttention(num_heads=2, sr_ratio=2, attn_drop=0.1, proj_drop=0.0)
    variables = _perturb(att.init({"params": jax.random.PRNGKey(1),
                                   "dropout": jax.random.PRNGKey(2)}, jnp.asarray(x), True),
                         seed=4)

    def loss(params, x):
        out = att.apply({"params": params}, x, True, rngs={"dropout": jax.random.PRNGKey(5)})
        return jnp.sum(out * cot), out

    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    eval_out = att.apply(variables, jnp.asarray(x), False)
    assert np.abs(np.asarray(want) - np.asarray(eval_out)).max() > 1e-4  # it drops

    port = tcf.SRAttention(32, 2, sr_ratio=2, attn_drop=0.1, proj_drop=0.0).train()
    sd = {}
    for name in ("q", "kv", "proj"):
        sd[f"{name}.weight"] = torch.from_numpy(np.asarray(variables["params"][name]["kernel"]).T.copy())
        sd[f"{name}.bias"] = torch.from_numpy(np.array(variables["params"][name]["bias"]))
    sd["sr.weight"] = torch.from_numpy(
        np.asarray(variables["params"]["sr"]["kernel"]).transpose(3, 2, 0, 1).copy())
    sd["sr.bias"] = torch.from_numpy(np.array(variables["params"]["sr"]["bias"]))
    sd["norm.weight"] = torch.from_numpy(np.array(variables["params"]["norm"]["scale"]))
    sd["norm.bias"] = torch.from_numpy(np.array(variables["params"]["norm"]["bias"]))
    port.load_state_dict(sd)
    tx = torch.from_numpy(x.reshape(2, 64, 32)).requires_grad_()
    got = port(tx, 8, 8)
    (got * torch.from_numpy(cot.reshape(2, 64, 32))).sum().backward()
    _assert_close(got.detach().numpy().reshape(x.shape), want, 1e-5, "output")
    _assert_close(tx.grad.numpy().reshape(x.shape), gx, 1e-5, "dx")
    for name in ("q", "kv", "proj"):
        _assert_close(getattr(port, name).weight.grad.numpy().T, gp[name]["kernel"], 1e-5,
                      f"d{name}.weight")
        _assert_close(getattr(port, name).bias.grad.numpy(), gp[name]["bias"], 1e-5,
                      f"d{name}.bias")
    _assert_close(port.sr.weight.grad.numpy().transpose(2, 3, 1, 0), gp["sr"]["kernel"],
                  1e-5, "dsr.weight")
    _assert_close(port.norm.weight.grad.numpy(), gp["norm"]["scale"], 1e-5, "dnorm.weight")


def _jax_pxl_loss(cfg):
    return lambda preds, label: jtrainer.CDTrainer._pxl_loss(
        types.SimpleNamespace(cfg=cfg, alpha=None), preds, label)


def test_narrow_v6_train_mode_gradients_match_jax(shared_seed, narrow_init):
    """Loss within 1e-5 relative; running statistics within 1e-5 of their
    largest entry; every parameter's gradient within 2e-3 of its largest
    entry: train-mode BatchNorm over as few as 8 values per channel (stage 4
    is 2x2 at batch 2) and the chain of 9 encoder blocks amplify float32
    summation noise, as in the ResNet train-mode tests."""
    model, variables = narrow_init
    a, b = _inputs(N, HW, seed=5)
    label = _label(6)
    jcfg = jtrainer.TrainerConfig(net_G="ChangeFormerV6", multi_scale_train=True)

    def loss_fn(params):
        preds, mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(a),
            jnp.asarray(b), True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return _jax_pxl_loss(jcfg)(preds, jnp.asarray(label)), mutated["batch_stats"]

    (want_loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    want = changeformer_v6_from_flax(grads, new_stats)  # gradients under the port's names

    port = _neutralise(_port_from(variables)).train()
    tr = ttrainer.CDTrainer.__new__(ttrainer.CDTrainer)
    tr.cfg = ttrainer.TrainerConfig(net_G="ChangeFormerV6", multi_scale_train=True)
    preds = port(_nchw(a), _nchw(b))
    loss = tr._pxl_loss(preds, _nchw(label))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    n_params = 0
    for name, p in port.named_parameters():
        _assert_close(p.grad.numpy(), want[name].numpy(), 2e-3, f"grad of {name}")
        n_params += 1
    assert n_params > 100
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _assert_close(buf.numpy(), want[name].numpy(), 1e-5, name)
            assert not np.allclose(
                buf.numpy(), changeformer_v6_from_flax(
                    variables["params"], variables["batch_stats"])[name].numpy())


@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.01), ("adamw", 1e-4)])
def test_three_trainer_steps_match_jax(shared_seed, narrow_init, optimizer, lr, tmp_path,
                                       monkeypatch):
    """The ported CDTrainer.train_step against the JAX one from one init on
    three seeded batches. The first loss within 1e-5 relative, the later ones
    within 2e-3 (an update moves every weight, and AdamW moves a weight with a
    near-zero gradient by lr whatever the gradient's size); confusion counts
    within 1 % of the pixels. The parameters are compared by how far three
    steps moved them from the init, against the largest move in each tensor: a
    step that was not taken shows as 1 and one of the wrong sign as 2. sgd:
    2e-3. adamw: 0.15, because its step is lr m / (sqrt(v) + eps), whose size
    does not shrink with the gradient, so float32 noise in a near-zero
    gradient shows at up to 0.11 of the largest move. Two gradients are zero
    analytically and all noise, so adamw moves them by +-lr at random on
    either side: the key half of every kv bias (softmax ignores a shift of
    the scores along the keys) and the conv bias ahead of linear_fuse's
    train-mode BatchNorm; they are left out. What the two optimizers do with
    one given gradient is pinned at 3e-6 in test_torch_train_steps.py."""
    model, variables = narrow_init
    kw = dict(net_G="ChangeFormerV6", embed_dim=NARROW_EMBED, img_size=HW, lr=lr,
              optimizer=optimizer, multi_scale_train=True, max_epochs=2)
    monkeypatch.setattr(jtrainer, "define_G", lambda *a, **k: model)
    jt = jtrainer.CDTrainer(jtrainer.TrainerConfig(checkpoint_dir=str(tmp_path), **kw),
                            {"train": [None] * 2})
    jstate = JaxTrainState.create_with_stats(
        apply_fn=model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=jt.tx)

    tt = ttrainer.CDTrainer(ttrainer.TrainerConfig(**kw), steps_per_epoch=2)
    tt.model = _neutralise(_port_from(variables))
    tstate = tt.init_state("cpu")

    rng = np.random.default_rng(7)
    for step in range(3):
        a, b = (rng.uniform(0, 1, (N, HW, HW, 3)).astype(np.float32) for _ in range(2))
        label = (rng.uniform(size=(N, HW, HW, 1)) > 0.8).astype(np.float32)
        jstate, want_loss, want_cm = jt.train_step(
            jstate, jnp.asarray(a), jnp.asarray(b), jnp.asarray(label),
            jax.random.PRNGKey(step))
        loss, cm = tt.train_step(tstate, *(torch.from_numpy(t) for t in (a, b, label)))
        np.testing.assert_allclose(loss.item(), float(want_loss),
                                   rtol=1e-5 if step == 0 else 2e-3, err_msg=f"step {step}")
        assert int(cm.sum()) == N * HW * HW
        assert np.abs(cm.numpy() - np.asarray(want_cm)).sum() <= 0.01 * N * HW * HW
    assert tstate.step == 3 == int(jstate.step)
    want = changeformer_v6_from_flax(jstate.params, jstate.batch_stats)
    init = changeformer_v6_from_flax(variables["params"], variables["batch_stats"])
    tol = 0.15 if optimizer == "adamw" else 2e-3
    n_params = 0
    for name, p in tstate.model.named_parameters():
        moved = p.detach().numpy() - init[name].numpy()
        want_moved = want[name].numpy() - init[name].numpy()
        if optimizer == "adamw" and name.endswith("attn.kv.bias"):
            half = moved.shape[0] // 2  # the value half; the key half's gradient is zero
            moved, want_moved = moved[half:], want_moved[half:]
        elif optimizer == "adamw" and name == "TDec_x2.linear_fuse.0.bias":
            continue
        assert np.abs(want_moved).max() > 0, f"{name} did not move"
        _assert_close(moved, want_moved, tol, f"change of {name}")
        n_params += 1
    assert n_params > 100


def _live_run(seed, steps=2):
    torch.manual_seed(0)
    tt = ttrainer.CDTrainer(ttrainer.TrainerConfig(
        net_G="ChangeFormerV6", embed_dim=NARROW_EMBED, optimizer="adamw", lr=1e-4,
        multi_scale_train=True, seed=seed))
    tt.model = tcf.init_weights(tcf.ChangeFormerV6(embed_dim=NARROW_EMBED, **NARROW), 0)
    state = tt.init_state("cpu")
    a, b = (torch.from_numpy(x) for x in _inputs(N, HW, seed=8))
    label = torch.from_numpy(_label(9))
    losses = [tt.train_step(state, a, b, label)[0].item() for _ in range(steps)]
    return tt, state, losses, (a, b, label)


def test_live_dropout_is_reproducible_from_the_generator_seed():
    """Two runs of two steps from one seed agree exactly, whatever the global
    generator holds; another seed differs: every draw (dropout, DropPath, the
    attention seeds) comes from the state's generator."""
    _, state1, losses1, _ = _live_run(seed=11)
    torch.manual_seed(12345)  # the global generator is not what the step draws from
    _, state2, losses2, _ = _live_run(seed=11)
    _, _, losses3, _ = _live_run(seed=12)
    assert losses1 == losses2
    assert losses1 != losses3
    for p1, p2 in zip(state1.model.parameters(), state2.model.parameters()):
        assert torch.equal(p1, p2)
    assert all(np.isfinite(losses1))


def test_train_mode_differs_from_eval_and_eval_is_deterministic():
    port = tcf.init_weights(tcf.ChangeFormerV6(embed_dim=NARROW_EMBED, **NARROW), 0)
    a, b = (_nchw(x) for x in _inputs(N, HW, seed=10))
    gen = torch.Generator().manual_seed(3)
    set_generator(port, gen)
    with torch.no_grad():
        ev1, ev2 = port.eval()(a, b)[-1], port.eval()(a, b)[-1]
        tr1 = port.train()(a, b)[-1]
        gen.manual_seed(3)
        tr2 = port.train()(a, b)[-1]
        tr3 = port.train()(a, b)[-1]
    assert torch.equal(ev1, ev2)
    assert torch.equal(tr1, tr2)
    assert (tr1 - ev1).abs().max() > 1e-4
    assert (tr1 - tr3).abs().max() > 1e-6
