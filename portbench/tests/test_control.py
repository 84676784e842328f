"""``correct`` comes out false for the configuration's control and for the
faults a cell can have, with the run driven as a benchmark run drives it
(the look for a card skipped), on the CPU at a tiny UNet.

The control: the plain reference in the program's place, its UNet's
products on operands rounded to TF32 (the fp32 configuration; on a card
cuDNN's own TF32) or fp8 (the bf16 configuration), the stages after the UNet
in bfloat16. The faults: a segment that hands on its input state unchanged;
half of a fleet's lanes left out, the rest's output given to them; one
value of the UNet's output, and one of a segment's sample, altered where it
is produced. The exchange between chips is no fault of these one-chip
cells."""

import dataclasses

import pytest
import torch

from conftest import TINY

CELLS = ["ref_fp32_b1", "hybrid_bf16_b1", "hybrid_bf16_fleet4"]


def run(bench, cell, **plant):
    from harness.cell import Cell
    c = Cell(cell, bench, "cpu", TINY)
    return c, c.run(2 ** 31 + 7, 1.0, **plant)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(bench, cell):
    from calibrate import control_kwargs
    from harness.cell import Cell
    c = Cell(cell, bench, "cpu", TINY)
    out = c.run(2 ** 31 + 8, 1.0, **control_kwargs(c, 2 ** 31 + 8))
    assert not out.correct, out.gaps


def unchanged(segment, _unet):
    def seg(x, y, seed, phi, opt, ts, buf):
        return dataclasses.replace(segment(x, y, seed, phi, opt, ts, buf), sample=x)
    return seg


def altered_sample(segment, _unet):
    def seg(x, y, seed, phi, opt, ts, buf):
        res = segment(x, y, seed, phi, opt, ts, buf)
        s = res.sample.clone()
        s[0, 3, 5, 1] += 0.5
        return dataclasses.replace(res, sample=s)
    return seg


def altered_output(model):
    def fn(x, t):
        out = model(x, t)
        return out + torch.zeros_like(out).index_put_((torch.tensor([0]),) * 4, torch.tensor(0.5))
    return fn


def half_batch(model):
    def fn(x, t):
        half = model(x[: x.shape[0] // 2], t[: x.shape[0] // 2])
        return torch.cat([half, half])
    return fn


FAULTS = [(c, "swap_segment", unchanged) for c in CELLS] + [
    (c, "swap_segment", altered_sample) for c in CELLS] + [
    (c, "swap_model", altered_output) for c in CELLS] + [
    ("hybrid_bf16_fleet4", "swap_model", half_batch)]


@pytest.mark.parametrize("cell,where,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, f in FAULTS])
def test_fault_is_refused(bench, cell, where, fault):
    _, out = run(bench, cell, **{where: fault})
    assert not out.correct, out.gaps


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cell):
    _, out = run(bench, cell)
    assert out.correct, out.gaps
