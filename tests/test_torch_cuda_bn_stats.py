"""The bn_stats CUDA kernel on the card: CUDA graphs that captured it,
replayed at once on two streams.

The kernel finishes by counting arrivals on integer tickets. Two graphs
that shared their tickets could let one call's last block fire before the
other's partial rows are written, and leave a ticket off zero for every
later call. Each captured call has its own tickets, so the replays must
give the eager call's sums bit for bit, during and after the overlap.

These tests need a card and skip without one. This file imports neither JAX
nor the JAX package, so that it runs where only PyTorch is installed; on
the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_bn_stats.py

Tolerance: the sums against a float64 sum to 1e-5 relative (relative to
max(1, |sum|)), as chip_smoke.py holds them; bit-equal to the eager call.
"""

import pytest
import torch

from stcd_tpu_torch.ops.bn_stats import bn_stats

pytestmark = pytest.mark.cuda

SHAPES = ((128, 32, 32, 512), (128, 16, 16, 1024))  # two SegCD-r50 shapes, ~34 and ~17 MB in bf16
REL_TOL = 1e-5
REPLAYS = 200


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _inputs(card, dtype):
    gen = torch.Generator(device="cpu").manual_seed(9)
    return [(torch.randn(shape, generator=gen) * 2.0 + 0.5).to(card, dtype) for shape in SHAPES]


def _rel_err(got, x):
    x64 = x.reshape(-1, x.shape[-1]).double()
    want = (x64.sum(0), (x64 * x64).sum(0))
    return max(((g.double() - w).abs() / w.abs().clamp_min(1.0)).max().item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_graphs_replayed_at_once_on_two_streams(card, dtype):
    xs = _inputs(card, dtype)
    eager = [bn_stats(x) for x in xs]
    graphs, outs = [], []
    torch.cuda.synchronize()
    for x in xs:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):  # both captured on the same capture stream
            outs.append(bn_stats(x))
        graphs.append(graph)
    streams = [torch.cuda.Stream() for _ in xs]
    torch.cuda.synchronize()
    for _ in range(REPLAYS):
        for graph, stream in zip(graphs, streams):
            with torch.cuda.stream(stream):
                graph.replay()
    torch.cuda.synchronize()
    for out, want in zip(outs, eager):
        assert all(torch.equal(o, w) for o, w in zip(out, want))
    # every ticket is back at 0: each graph alone, then an eager call, as before
    for graph, out, want in zip(graphs, outs, eager):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(out, want))
    for x, want in zip(xs, eager):
        assert all(torch.equal(o, w) for o, w in zip(bn_stats(x), want))
        assert _rel_err(want, x) <= REL_TOL
        assert _rel_err(bn_stats(x, impl="plain"), x) <= REL_TOL


def test_eager_calls_at_once_on_two_streams(card):
    """Eager calls on two streams, each with its stream's tickets, overlapping."""
    xs = _inputs(card, torch.bfloat16)
    eager = [bn_stats(x) for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    torch.cuda.synchronize()
    last = [None] * len(xs)
    for _ in range(50):
        for i, (x, stream) in enumerate(zip(xs, streams)):
            with torch.cuda.stream(stream):
                last[i] = bn_stats(x)
    torch.cuda.synchronize()
    for got, want in zip(last, eager):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
