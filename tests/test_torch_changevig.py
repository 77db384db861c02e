"""stcd_tpu_torch's gcn_lib and ChangeVIG models against the JAX package,
float32 on the CPU.

(a) gcn_lib: act_layer; the 1-D ``jax.image.resize(..., "linear")`` weights
    (anti-aliased when they downsize) to 1e-6; ``relative_pos_bias`` square at
    r = 1, 2 and 4 and on a non-square grid to 1e-6 (JAX takes float32 with
    HIGHEST precision, the port float64); ``knn_graph`` indices equal to JAX's
    at random inputs and at inputs with exact ties (the lower index first, as
    ``jax.lax.top_k``), dilation 1 to 3; the Grapher with MRConv and EdgeConv
    at r = 1 and 2, eval and train mode.
(b) the six ViG keys (ChangeGNNV1, ChangeGNNV2, ChangeGNNV2_sub/_abs/_conc,
    GNN) at the encoder's fixed widths 80/160/400/640, embed_dim 32,
    img_size 64, batch 2, on the JAX model's variables drawn with numpy
    (tests/test_torch_zoo_siam.py::jax_variables): every output within
    VIG_TOL of the largest |JAX output|, the same bound against a float64 run
    of the port; the converter round trip exact.
(c) ChangeGNNV2's train-mode gradients and running statistics; img_size
    sizing pos_embed, and pos_embed resized (anti-aliased) for another input
    size, to 1e-6; CDTrainer and cli.predict passing it on.

The eval outputs of these models reach 10 to 100 at these weights (every
BatchNorm's running statistics are random, so activations grow through the
12 residual blocks), and float32 rounding grows with them: the port and JAX
each differ from a float64 run of the port by up to 3e-4 of the largest
output (measured on ChangeGNNV2_abs), while their KNN indices agree exactly
(checked at every Grapher when this test was written), so VIG_TOL is 2e-3 of
the largest output.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.convert import torch_to_flax as t2f
from stcd_tpu.models import gcn_lib as jg
from stcd_tpu.models.factory import define_G as jax_define_G
from stcd_tpu_torch.convert import from_flax
from stcd_tpu_torch.models import gcn_lib as tg
from stcd_tpu_torch.models.factory import define_G

from test_torch_changeformer import _inputs, _nchw
from test_torch_zoo_siam import flat, jax_variables

VIG_KEYS = ("ChangeGNNV1", "ChangeGNNV2", "ChangeGNNV2_sub", "ChangeGNNV2_abs",
            "ChangeGNNV2_conc", "GNN")
HW, N, EMBED = 64, 2, 32
VIG_TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["relu", "leakyrelu", "gelu", "hswish"])
def test_act_layer_matches_jax(name):
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jg.act_layer(name)(jnp.asarray(x)))
    got = tg.act_layer(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_act_layer_prelu_is_the_documented_relu():
    """gcn_lib documents prelu as relu; the JAX function has no such key
    (ROADMAP.md known issue 2)."""
    x = torch.linspace(-2, 2, 9)
    assert torch.equal(tg.act_layer("prelu")(x), torch.relu(x))
    with pytest.raises(KeyError):
        jg.act_layer("prelu")


@pytest.mark.parametrize("n_in,n_out", [(256, 16), (64, 16), (16, 64), (7, 3), (5, 5),
                                        (3, 8)])
def test_linear_resize_matrix_matches_jax_image_resize(n_in, n_out):
    x = np.random.default_rng(0).standard_normal((n_in, 5))
    want = np.asarray(jax.image.resize(jnp.asarray(x, jnp.float32), (n_out, 5), "linear"))
    got = tg.linear_resize_matrix(n_in, n_out).T @ x
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("channels,grid,r", [(80, (8, 8), 1), (80, (16, 16), 2),
                                             (160, (16, 16), 4), (48, (4, 8), 2),
                                             (2, (4, 4), 2)],
                         ids=["square_r1", "square_r2", "square_r4", "nonsquare_r2",
                              "no_frequencies"])
def test_relative_pos_bias_matches_jax(channels, grid, r):
    n = grid[0] * grid[1]
    m = (grid[0] // r) * (grid[1] // r)
    want = np.asarray(jg.relative_pos_bias(channels, n, m, grid_hw=grid))
    got = tg.relative_pos_bias_np(channels, n, m, grid)
    assert got.shape == want.shape == (1, n, m)
    np.testing.assert_allclose(got, want, atol=1e-6)
    t = tg.relative_pos_bias(channels, n, m, grid)
    assert t is tg.relative_pos_bias(channels, n, m, grid)  # made once a shape and device


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("dilation", [1, 2, 3])
def test_knn_graph_matches_jax(kind, dilation):
    """Random nodes with the relative-position bias, and nodes whose scores
    tie exactly: unit basis vectors (each neighbour twice, at scales 1 and 4,
    whose normalisation is exact) and zero nodes on both sides, so every score
    is 0, -1 or -2 exactly. The lower index comes first among equal scores."""
    rng = np.random.default_rng(dilation)
    if kind == "random":
        x = rng.standard_normal((2, 64, 16)).astype(np.float32)
        y = rng.standard_normal((2, 16, 16)).astype(np.float32)
        rel = np.array(jg.relative_pos_bias(16, 64, 16, grid_hw=(8, 8)))
    else:
        eye = np.eye(16, dtype=np.float32)
        y = np.stack([np.concatenate([eye[:8], 4 * eye[:8]]),
                      np.concatenate([4 * eye[8:], eye[8:]])])
        y[:, 3] = y[:, 11] = 0.0
        x = eye[rng.integers(0, 16, (2, 64))]
        x[:, :5] = 0.0
        rel = None
    want = np.asarray(jg.knn_graph(jnp.asarray(x), jnp.asarray(y), 5, dilation,
                                   None if rel is None else jnp.asarray(rel)))
    got = tg.knn_graph(torch.from_numpy(x), torch.from_numpy(y), 5, dilation,
                       None if rel is None else torch.from_numpy(rel)).numpy()
    assert got.shape == want.shape == (2, 64, min(5, -(-min(5 * dilation, 16) // dilation)))
    np.testing.assert_array_equal(got, want)


def _grapher_sd(variables):
    sd = {}
    from_flax._grapher(sd, "g", variables["params"], variables["batch_stats"])
    return {k[2:]: v for k, v in sd.items()}


@pytest.mark.parametrize("conv", ["mr", "edge"])
@pytest.mark.parametrize("r", [1, 2])
def test_grapher_mr_and_edge_conv_match_jax(conv, r):
    """fc1, the KNN against the r-pooled nodes with the relative-position
    bias, MRConv or EdgeConv, fc2, plus the input: eval output, and the
    train-mode output and running statistics, to 1e-5 of the largest entry;
    the neighbour indices equal."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    jmodel = jg.Grapher(kernel_size=5, dilation=2, conv=conv, r=r)
    variables = jax_variables(jmodel, 8, 5, args=(jnp.asarray(x),))
    port = tg.Grapher(16, 5, 2, conv, r=r)
    port.load_state_dict(_grapher_sd(variables))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port.eval()(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    want_t, mutated = jmodel.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    with torch.no_grad():
        got_t = port.train()(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got_t, np.asarray(want_t), atol=1e-5 * np.abs(want_t).max())
    stats = _grapher_sd({"params": variables["params"], "batch_stats": mutated["batch_stats"]})
    for name, buf in port.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), rtol=1e-5, atol=1e-6)


_CACHE = {}


def _vig(net_G):
    """(JAX model, its variables, the port with them), made once a key."""
    if net_G not in _CACHE:
        jmodel = jax_define_G(net_G, n_class=2, embed_dim=EMBED, img_size=HW)
        variables = jax_variables(jmodel, HW, seed=VIG_KEYS.index(net_G) + 1)
        port = define_G(net_G, n_class=2, embed_dim=EMBED, img_size=HW)
        port.load_state_dict(from_flax.changevig_from_flax(
            variables["params"], variables["batch_stats"],
            from_flax.CHANGEVIG_MODELS[net_G]))
        _CACHE[net_G] = jmodel, variables, port
    return _CACHE[net_G]


@pytest.fixture
def jax_neighbours(monkeypatch):
    """Record the neighbour indices of every JAX Grapher call, in order (a
    debug callback inside the jitted function); ``feed(runs)`` then makes the
    port's Graphers take those in the same order, ``runs`` forwards over, and
    records how many of its own indices equal them. The KNN selection alone
    is held by test_knn_graph_matches_jax; in a model, two scores closer than
    float32 rounding may rank either way on either side, and one other
    neighbour early in the encoder moves the outputs downstream of it (found
    at seed-drawn weights: ChangeGNNV2's output moved by 28 where it reaches
    40). So the model comparisons hold everything else on JAX's choices, and
    state the share of equal indices."""
    recorded, counts = [], []
    knn = jg.knn_graph

    def record(*args, **kwargs):
        idx = knn(*args, **kwargs)
        jax.debug.callback(lambda i: recorded.append(np.array(i)), idx, ordered=True)
        return idx

    monkeypatch.setattr(jg, "knn_graph", record)
    own_knn = tg.knn_graph

    def feed(runs=1):
        assert len(recorded) == 12  # the 12 Graphers of the 2N-batched encoder
        queue = list(recorded) * runs
        recorded.clear()

        def take(x, y, k, dilation=1, rel_pos=None):
            own = own_knn(x, y, k, dilation, rel_pos)
            theirs = torch.from_numpy(queue.pop(0))
            assert theirs.shape == own.shape
            counts.append((int((own == theirs).sum()), own.numel()))
            return theirs

        monkeypatch.setattr(tg, "knn_graph", take)
        return queue

    return feed, counts


def equal_share(counts):
    return sum(e for e, _ in counts) / sum(n for _, n in counts)


# the share of the port's own neighbour indices equal to JAX's, at least
NEIGHBOUR_SHARE = 0.99


def _compare_eval(net_G, jax_neighbours):
    """On JAX's neighbours (jax_neighbours): every output within VIG_TOL of
    the largest JAX output, against JAX and against a float64 run of the
    port; the port's own indices equal JAX's at NEIGHBOUR_SHARE or more."""
    feed, counts = jax_neighbours
    jmodel, variables, port = _vig(net_G)
    a, b = _inputs(N, HW, seed=7)
    wants = [np.asarray(w) for w in jax.jit(jmodel.apply)(variables, jnp.asarray(a),
                                                          jnp.asarray(b))]
    queue = feed(runs=2)
    port64 = define_G(net_G, n_class=2, embed_dim=EMBED, img_size=HW).double()
    port64.load_state_dict(port.state_dict())
    with torch.no_grad():
        gots = [g.numpy().transpose(0, 2, 3, 1) for g in port.eval()(_nchw(a), _nchw(b))]
        exact = [e.numpy().transpose(0, 2, 3, 1)
                 for e in port64.eval()(_nchw(a).double(), _nchw(b).double())]
    assert not queue and equal_share(counts) >= NEIGHBOUR_SHARE, equal_share(counts)
    assert len(gots) == len(wants) == (5 if net_G == "ChangeGNNV1" else 1)
    assert gots[-1].shape == (N, HW, HW, 2)
    for i, (got, want, ref) in enumerate(zip(gots, wants, exact)):
        bound = VIG_TOL * np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=bound, err_msg=f"output {i}")
        np.testing.assert_allclose(got, ref, atol=bound, err_msg=f"output {i}, float64")


@pytest.mark.parametrize("net_G", VIG_KEYS)
def test_define_g_eval_forward_matches_jax(net_G, jax_neighbours):
    _compare_eval(net_G, jax_neighbours)


@pytest.mark.parametrize("net_G", VIG_KEYS)
def test_converter_round_trip_is_exact(net_G):
    _, variables, port = _vig(net_G)  # the load is strict
    params, stats = t2f.convert_changevig({k: v.numpy() for k, v in port.state_dict().items()},
                                          from_flax.CHANGEVIG_MODELS[net_G])
    for want_tree, got_tree in ((variables["params"], params),
                                (variables["batch_stats"], stats)):
        want, got = flat(want_tree), flat(got_tree)
        assert set(want) == set(got), net_G
        for key, v in want.items():
            assert np.array_equal(got[key], v), key


def test_state_dict_names():
    names = set(define_G("ChangeGNNV2").state_dict())
    for key in ("encoder.stem.convs.7.running_var", "encoder.pos_embed",
                "encoder.backbone.2.conv.0.weight", "encoder.backbone.14.0.graph_conv.0.weight",
                "encoder.backbone.14.1.fc2.1.bias", "decoder.hffm1.cross_conc.diff.0.weight",
                "decoder.hffm4.global_local.local_conv5.bias", "decoder.vffm3.up.up.weight",
                "decoder.vffm1.global_max.5.running_mean", "decoder.dense_1x.0.conv2.conv2d.bias",
                "decoder.change_probability.conv2d.weight"):
        assert key in names, key
    assert "TDec_x2.csam4.batch_normal1.weight" in set(define_G("GNN").state_dict())
    assert "VIG_x2.pos_embed" in set(define_G("GNN").state_dict())
    assert "decoder.hffm2.diff.diff.0.weight" in set(define_G("ChangeGNNV2_conc").state_dict())
    assert "decoder.decoder_heads_c4.proj.weight" in set(define_G("ChangeGNNV1").state_dict())


def test_changegnnv2_train_mode_gradients_match_jax(jax_neighbours):
    """Cross-entropy of the full-resolution output in train mode (DropPath 0,
    as the factory builds it; no dropout in V2), on JAX's neighbours
    (jax_neighbours): the loss within 1e-4 relative, the running statistics
    within 1e-4 of each tensor's largest entry, every gradient within 5e-2 of
    the largest gradient entry against JAX and within 5e-3 against a float64
    run of the port. The first bound is for JAX's own float32 rounding: against
    the float64 run JAX's gradients are off by up to 2.5e-2 of the largest
    entry (at encoder.stem.convs.0.weight, whose gradient comes back through
    the 12 Grapher blocks and the train-mode BatchNorms), the port's by
    2.7e-3 (measured on a CPU host)."""
    from stcd_tpu.losses.functional import cross_entropy as jax_ce
    from stcd_tpu_torch.losses.functional import cross_entropy
    from test_torch_changeformer_train import _assert_close
    from test_torch_train_steps import _float64_through_the_losses
    jmodel, variables, port = _vig("ChangeGNNV2")
    a, b = _inputs(N, HW, seed=8)
    label = np.random.default_rng(9).integers(0, 2, (N, HW, HW)).astype(np.int32)

    def loss_fn(params):
        preds, mutated = jmodel.apply({"params": params,
                                       "batch_stats": variables["batch_stats"]},
                                      jnp.asarray(a), jnp.asarray(b), True,
                                      mutable=["batch_stats"])
        return jax_ce(preds[-1], jnp.asarray(label)), mutated["batch_stats"]

    (want_loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    want = from_flax.changevig_from_flax(grads, new_stats, "gnn_v2")
    feed, counts = jax_neighbours
    queue = feed(runs=2)
    port = define_G("ChangeGNNV2", embed_dim=EMBED, img_size=HW)
    port.load_state_dict(_vig("ChangeGNNV2")[2].state_dict())
    port64 = define_G("ChangeGNNV2", embed_dim=EMBED, img_size=HW).double()
    port64.load_state_dict(port.state_dict())
    loss = cross_entropy(port.train()(_nchw(a), _nchw(b))[-1], torch.from_numpy(label))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    with _float64_through_the_losses():
        cross_entropy(port64.train()(_nchw(a).double(), _nchw(b).double())[-1],
                      torch.from_numpy(label)).backward()
    assert not queue and equal_share(counts) >= NEIGHBOUR_SHARE, equal_share(counts)
    exact = {k: p.grad.numpy() for k, p in port64.named_parameters()}
    scale = max(float(np.abs(g).max()) for g in exact.values())
    for name, p in port.named_parameters():
        got = p.grad.double().numpy()
        assert np.abs(got - want[name].numpy()).max() <= 5e-2 * scale, (name, "JAX")
        assert np.abs(got - exact[name]).max() <= 5e-3 * scale, (name, "float64")
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _assert_close(buf.numpy(), want[name].numpy(), 1e-4, name)


def test_img_size_sizes_pos_embed_and_other_sizes_resize_it():
    """ChangeGNNV2 at img_size 128: pos_embed is JAX's (1, 32, 32, 80) as
    (1, 80, 32, 32) with the same values after conversion; a 64x64 input
    resizes it to 16x16 as jax.image.resize does (anti-aliased), to 1e-6;
    ChangeGNNV1 and GNN keep 256, as the JAX factory builds them; CDTrainer
    and cli.predict pass their size on."""
    import argparse

    from stcd_tpu_torch.cli import predict as cli_predict
    from stcd_tpu_torch.models.changevig import resize_linear_2d
    from stcd_tpu_torch.train.trainer import CDTrainer, TrainerConfig
    jmodel = jax_define_G("ChangeGNNV2", n_class=2, embed_dim=EMBED, img_size=128)
    variables = jax_variables(jmodel, 128, seed=11)
    port = define_G("ChangeGNNV2", n_class=2, embed_dim=EMBED, img_size=128)
    port.load_state_dict(from_flax.changevig_from_flax(
        variables["params"], variables["batch_stats"], "gnn_v2"))
    want = np.asarray(variables["params"]["encoder"]["pos_embed"])
    assert want.shape == (1, 32, 32, 80)
    assert tuple(port.encoder.pos_embed.shape) == (1, 80, 32, 32)
    pos = port.encoder.pos_embed.detach()
    np.testing.assert_array_equal(pos.numpy().transpose(0, 2, 3, 1), want)
    resized = np.asarray(jax.image.resize(jnp.asarray(want), (1, 16, 16, 80), "linear"))
    np.testing.assert_allclose(resize_linear_2d(pos, (16, 16)).numpy().transpose(0, 2, 3, 1),
                               resized, atol=1e-6)
    with torch.no_grad():
        out = port.eval()(*(torch.zeros(1, 3, 64, 64) for _ in range(2)))
    assert out[-1].shape == (1, 2, 64, 64)
    assert tuple(define_G("ChangeGNNV1", img_size=128).encoder.pos_embed.shape[2:]) == (64, 64)
    assert tuple(define_G("GNN", img_size=128).VIG_x2.pos_embed.shape[2:]) == (64, 64)
    trainer = CDTrainer(TrainerConfig(net_G="ChangeGNNV2_abs", img_size=96), steps_per_epoch=1)
    assert tuple(trainer.model.encoder.pos_embed.shape) == (1, 80, 24, 24)
    p = argparse.ArgumentParser()
    cli_predict.add_model_args(p)
    args = p.parse_args(["--net_G", "ChangeGNNV2", "--tile", "128", "--init_seed", "0",
                         "--device", "cpu"])
    assert tuple(cli_predict.build_model(args).encoder.pos_embed.shape) == (1, 80, 32, 32)


def test_vig_backbones_and_the_pipeline_option():
    from stcd_tpu_torch.models import changevig
    for fn, blocks, chans in ((changevig.pvig_ti, 12, 384), (changevig.pvig_s, 12, 640),
                              (changevig.pvig_m, 22, 768), (changevig.pvig_b, 24, 1024)):
        enc = fn()
        assert sum(isinstance(m, tg.Grapher) for m in enc.modules()) == blocks
        assert enc.backbone[-1][0].fc1[0].in_channels == chans
        assert tuple(enc.pos_embed.shape[2:]) == (56, 56)
    with torch.no_grad():
        feats = changevig.pvig_ti(img_size=64)(torch.zeros(1, 3, 64, 64))
    assert [tuple(f.shape[1:]) for f in feats] == [(48, 16, 16), (96, 8, 8), (240, 4, 4),
                                                   (384, 2, 2)]
    # the pipeline option builds; with no stage axis (one process) its stages run in
    # sequence, in eval mode as inside a pipeline, and give the sequential encoder's maps
    kw = dict(blocks=(1, 1, 1, 1), channels=(8, 12, 16, 24), k=4, img_size=32)
    piped = changevig.VIGBackbone(pipeline={"n_micro": 2}, **kw).eval()
    plain = changevig.VIGBackbone(**kw).eval()
    plain.load_state_dict(piped.state_dict())
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for got, want in zip(piped(x), plain(x)):
            assert torch.equal(got, want)
