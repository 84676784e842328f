"""The UNet's CUDA graphs (``osmosis_tpu_torch/models/unet.py``): the reader
``unet_graph_pct`` on the CPU, and (marker ``cuda``) the graphed forward and
pullback against the eager ones on a card, at the full-width UNet of the
cells ``hybrid_bf16_b1`` (bf16, cuDNN's default algorithms) and
``ref_fp32_b1`` (fp32; its pullback under cuDNN's deterministic algorithms,
since the default fp32 backward-data algorithm does not repeat its own bits
from call to call): bit for bit, outputs that a later replay leaves alone, a
stale pullback recomputed, and the kernels' launch counters as the eager
calls count them."""

import pytest
import torch

CELLS = {"bf16_b1": ("hybrid_bf16_b1", False), "fp32_b1": ("ref_fp32_b1", True)}
KERNEL_COUNTERS = ("upsample_nearest_2x.", "box_sum_2x.", "group_norm_forward.",
                   "group_norm_backward.")


def read(ctx=None):
    import run
    return run.reader(run.HERE, "unet_graph_pct")(ctx)


def test_unet_graph_pct_is_replays_over_calls():
    from osmosis_tpu_torch.utils import profiling
    profiling.reset_counters("unet.calls", "unet.graph_replays")
    assert read() is None
    profiling.count("unet.calls", 8)
    assert read() == 0.0
    profiling.count("unet.graph_replays", 6)
    assert read() == pytest.approx(75.0)
    profiling.reset_counters("unet.calls", "unet.graph_replays")


def setup(bench, card, shape):
    """The cell's model, seeded, and seeded inputs: two x_t, their
    timesteps and two cotangents of the output."""
    from harness.cell import Cell
    name, deterministic = CELLS[shape]
    model = Cell(name, bench, card).program(seed=2 ** 31 + 77)
    gen = torch.Generator(card).manual_seed(11)
    xs = [torch.randn(1, 256, 256, 4, device=card, generator=gen) for _ in range(3)]
    ts = [torch.tensor([t], device=card) for t in (699.0, 120.0, 40.0)]
    gs = [torch.randn(1, 256, 256, 8, device=card, generator=gen) for _ in range(3)]
    return model, xs, ts, gs, deterministic


def kernel_counts(since):
    from osmosis_tpu_torch.utils import profiling
    c = profiling.counters() - since
    return {k: v for k, v in c.items() if k.startswith(KERNEL_COUNTERS)}


def call(fn, x, t, g):
    """A forward with grad on x and its pullback: (output, gradient at x)."""
    x = x.clone().requires_grad_(True)
    out = fn(x, t)
    (gx,) = torch.autograd.grad(out, x, g)
    return out, gx


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(CELLS))
def test_graphed_calls_equal_the_eager_ones_bit_for_bit(bench, card, shape, capsys):
    from harness import program
    from osmosis_tpu_torch.utils import profiling
    model, xs, ts, gs, deterministic = setup(bench, card, shape)
    with program.cudnn_algorithms(deterministic):
        c0 = profiling.counters()
        graphed = [call(model, x, t, g) for x, t, g in zip(xs[:2], ts, gs)]
        first = [v.clone() for v in graphed[0]]
        with torch.no_grad():
            free = model(xs[2], ts[2])
        c1 = profiling.counters()
        eager = [call(model._forward, x, t, g) for x, t, g in zip(xs[:2], ts, gs)]
        with torch.no_grad():
            free_eager = model._forward(xs[2], ts[2])
    torch.cuda.synchronize()
    counted = c1 - c0
    assert len(model._graphs) == 1 and counted["unet.graph_captures"] == 1
    assert (counted["unet.graph_replays"], counted["unet.graph_pullbacks"]) == (3, 2)
    capsys.readouterr()
    for (out, gx), (out_e, gx_e) in zip(graphed, eager):
        print(shape, "forward", torch.equal(out, out_e), "pullback", torch.equal(gx, gx_e))
        assert out_e.abs().max() > 0 and gx_e.abs().max() > 0
        assert torch.equal(out, out_e) and torch.equal(gx, gx_e)
    assert torch.equal(free, free_eager)
    # what call 0 returned survives the replays of calls 1 and 2
    assert torch.equal(graphed[0][0], first[0]) and torch.equal(graphed[0][1], first[1])
    assert not torch.equal(graphed[0][0], graphed[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(CELLS))
def test_a_stale_pullback_recomputes_and_is_right(bench, card, shape):
    from harness import program
    from osmosis_tpu_torch.utils import profiling
    model, xs, ts, gs, deterministic = setup(bench, card, shape)
    with program.cudnn_algorithms(deterministic):
        want = [call(model._forward, x, t, g)[1] for x, t, g in zip(xs, ts, gs)]
        a, b = (x.clone().requires_grad_(True) for x in xs[:2])
        out_a, out_b = model(a, ts[0]), model(b, ts[1])
        with torch.no_grad():
            model(xs[2], ts[2])
        c0 = profiling.counters()
        (gb,) = torch.autograd.grad(out_b, b, gs[1])  # stale behind the grad-free replay
        (ga,) = torch.autograd.grad(out_a, a, gs[0])  # stale behind two replays
        stale = profiling.counters() - c0
        c = xs[2].clone().requires_grad_(True)
        (gc,) = torch.autograd.grad(model(c, ts[2]), c, gs[2])  # the newest: replayed
        torch.cuda.synchronize()
    assert stale["unet.graph_pullbacks"] == 0
    assert (profiling.counters() - c0)["unet.graph_pullbacks"] == 1
    for got, w in zip((ga, gb, gc), want):
        assert torch.equal(got, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(CELLS))
def test_replays_count_the_kernels_as_the_eager_calls_do(bench, card, shape):
    from harness import program
    from osmosis_tpu_torch.utils import profiling
    model, xs, ts, gs, deterministic = setup(bench, card, shape)
    with program.cudnn_algorithms(deterministic):
        def run(fn):
            c0 = profiling.counters()
            for x, t, g in zip(xs, ts, gs):  # a pullback on the first two, then a grad-free call
                if g is gs[2]:
                    with torch.no_grad():
                        fn(x, t)
                else:
                    call(fn, x, t, g)
            torch.cuda.synchronize()
            return kernel_counts(c0)

        graphed = run(model)  # its first call captures: that counts nothing
        eager = run(model._forward)
    assert eager["group_norm_forward.launches"] > 0 and eager["group_norm_backward.launches"] > 0
    assert graphed == eager
