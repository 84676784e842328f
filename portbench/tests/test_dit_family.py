"""The family ``dit`` (DiT-XL/4 as the RGBD prior): its FLOP yardstick
against ``torch.utils.flop_counter``'s count of the plain reference, a run
of its cell at a tiny size on the CPU (correct; its control and planted
faults refused; its readers silent off the card), and (marker ``cuda``) the
port's bf16 DiT at full width against the fp32 reference on a card, and its
grad-free forward, replayed as a CUDA graph, against its eager one."""

import math

import pytest
import torch

TINY_DIT = dict(image_size=32, patch_size=4, hidden_size=64, depth=2, num_heads=4,
                frequency_embedding_size=64)
CELL = "dit_xl4_bf16_b1"


def test_flop_matches_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from reference.dit import DiT, Sizes
    from yardstick.dit_cost import attn_flop, flop
    s = Sizes(**TINY_DIT)
    model = DiT(s, remat=False).requires_grad_(False)
    x = torch.randn(2, 32, 32, 4, requires_grad=True)
    t = torch.tensor([10.0, 600.0])
    with FlopCounterMode(display=False) as fc:
        out = model(x, t)
    forward = fc.get_total_flops()
    bmm = fc.get_flop_counts()["Global"][torch.ops.aten.bmm]
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(out, x, torch.randn_like(out))
    assert flop(s, 2) == (forward, fc.get_total_flops())
    assert attn_flop(s, 2) == bmm


def test_checkpointed_reference_computes_the_same():
    from reference.dit import DiT, Sizes
    torch.manual_seed(0)
    plain = DiT(Sizes(**TINY_DIT), remat=False)
    remat = DiT(Sizes(**TINY_DIT))
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(1, 32, 32, 4)
    t = torch.tensor([300.0])
    got = []
    for m in (plain, remat):
        xg = x.clone().requires_grad_(True)
        out = m(xg, t)
        got += [out, torch.autograd.grad(out, xg, torch.ones_like(out))[0]]
    assert torch.equal(got[0], got[2]) and torch.allclose(got[1], got[3], rtol=1e-6, atol=1e-7)


def test_tiny_cell_is_correct_and_its_readers_are_silent_off_the_card(bench, capsys):
    import run
    result = run.run_cell(bench, CELL, 2 ** 31 + 21, 0.5, True, "cpu", overrides=TINY_DIT)
    capsys.readouterr()
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert not {"dit_mfu_pct", "dit_attn_mfu_pct", "dit_host_ms_per_step"} & set(result["metrics"])


def _scaled(factor):
    def swap(model):
        return lambda x, t: model(x, t) * factor
    return swap


def _one_value(model):
    def fn(x, t):
        out = model(x, t)
        return out + torch.zeros_like(out).index_put_((torch.tensor([0]),) * 4, torch.tensor(0.5))
    return fn


@pytest.mark.parametrize("plant", ["control", "scaled", "one_value"])
def test_control_and_faults_are_refused(bench, plant):
    from calibrate import control_kwargs
    from harness.cell import Cell
    cell = Cell(CELL, bench, "cpu", TINY_DIT)
    seed = 2 ** 31 + 22
    kw = {"control": lambda: control_kwargs(cell, seed),
          "scaled": lambda: dict(swap_model=_scaled(1 + 1e-1)),
          "one_value": lambda: dict(swap_model=_one_value)}[plant]()
    out = cell.run(seed, 0.5, **kw)
    assert not out.correct, out.gaps


@pytest.mark.cuda
def test_full_width_bf16_dit_against_the_fp32_reference(bench, card, capsys):
    """DiT-XL/4 at 4096 tokens on the seeded weights: the program's bf16
    forward against the plain fp32 reference within the configuration's
    ``eps`` and ``var`` limits, then one segment of the cell held stage by
    stage, its x-pullback of the chain's own cotangents included, within
    all of them."""
    from harness.cell import Cell
    from reference.diffusion import gap
    cell = Cell(CELL, bench, card)
    x = torch.randn(1, 256, 256, 4, device=card, generator=torch.Generator(card).manual_seed(5))
    t = torch.tensor([555.0], device=card)
    with torch.no_grad():
        prog, ref = cell.program(9)(x, t), cell.reference(9)(x, t)
    limits = cell.config["limits"]
    gaps = {"eps": gap(prog[..., :4], ref[..., :4]), "var": gap(prog[..., 4:], ref[..., 4:])}
    assert all(math.isfinite(v) and v <= limits[k] for k, v in gaps.items()), gaps
    assert ref.abs().max() > 0
    out = cell.run(2 ** 31 + 23, 1.0)
    capsys.readouterr()
    print("full-width gaps:", gaps, out.gaps)
    assert out.correct and out.x_prev_steps > 0, out.gaps


@pytest.mark.cuda
def test_graph_replay_matches_the_eager_forward(card, capsys):
    """Without grad the DiT replays one CUDA graph an input shape: two calls
    on new inputs give the eager forward's output, the first call's output
    survives the second replay, and a call with grad runs eagerly."""
    from osmosis_tpu_torch.models.dit import DiTConfig, load_dit
    cfg = DiTConfig(image_size=64, patch_size=4, hidden_size=144, depth=3, num_heads=2,
                    dtype=torch.bfloat16)
    model = load_dit("", cfg, card, seed=3)
    gen = torch.Generator(card).manual_seed(3)
    for p in model.parameters():  # DiT's init zeroes the modulations and the output
        p.copy_(0.05 * torch.randn(p.shape, device=card, generator=gen))
    xs = [torch.randn(2, 64, 64, 4, device=card, generator=gen) for _ in range(2)]
    ts = [torch.tensor([10.0, 900.0], device=card), torch.tensor([500.0, 3.0], device=card)]
    with torch.no_grad():
        graphed = [model(x, t) for x, t in zip(xs, ts)]
        eager = [model._forward(x, t) for x, t in zip(xs, ts)]
    assert len(model._graphs) == 1
    capsys.readouterr()
    print("graph against eager, bitwise:", [torch.equal(g, e) for g, e in zip(graphed, eager)])
    for g, e in zip(graphed, eager):
        assert e.abs().max() > 0
        torch.testing.assert_close(g, e, rtol=1e-3, atol=1e-3)
    x = xs[0].clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(model(x, ts[0]).sum(), x)
    assert len(model._graphs) == 1 and gx.abs().max() > 0
