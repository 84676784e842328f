"""The plain reference against the port at a tiny size on the CPU: the
UNet's output and pullback on the same seeded weights, and each recorded
step of a run of every cell."""

import pytest
import torch

from conftest import TINY


@pytest.mark.parametrize("config", ["osmosis_ref_fp32", "osmosis_hybrid_bf16"])
def test_unet_against_port(bench, config):
    from harness.cell import Cell
    cell = Cell({"osmosis_ref_fp32": "ref_fp32_b1"}.get(config, "hybrid_bf16_b1"), bench, "cpu",
                TINY)
    port = cell.program(77)
    ref = cell.reference(77)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, 32, 4, generator=gen)
    t = torch.tensor([700.0, 20.0])
    u = torch.randn(2, 32, 32, 8, generator=gen)
    got, want = [], []
    for model, sink in ((port, got), (ref, want)):
        xg = x.clone().requires_grad_(True)
        y = model(xg, t)
        (gx,) = torch.autograd.grad(y, xg, u)
        sink += [y.detach(), gx]
    tol = 2e-5 if config == "osmosis_ref_fp32" else 6e-2  # bf16 torso against fp32
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= tol * b.abs().max()
        assert a.abs().max() > 0


@pytest.mark.parametrize("cell", ["ref_fp32_b1", "hybrid_bf16_b1", "hybrid_bf16_fleet4"])
def test_steps_against_port(bench, cell):
    from harness.cell import Cell
    out = Cell(cell, bench, "cpu", TINY).run(99, 1.0)
    assert out.checked_steps >= 2 and out.failed == 0
    assert set(out.gaps) == set(out.limits)
    assert out.correct, out.gaps
    if cell == "ref_fp32_b1":
        assert max(out.gaps.values()) < 1e-5
