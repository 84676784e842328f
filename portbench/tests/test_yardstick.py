"""The yardstick's arithmetic: FLOP against torch's counter at a tiny size
and against the port's records at full width, and the GroupNorm bytes
against ``tools/gn_bench``'s bounds."""

import dataclasses

import pytest
import torch

from conftest import TINY
from reference.unet import Arch
from yardstick.unet_cost import flop, gn_bytes, gn_sites

HBM = 3.35e12


def port_unet(arch_overrides):
    from osmosis_tpu_torch.models.unet import UNetConfig, UNetModel
    cfg = UNetConfig(image_size=arch_overrides["image_size"],
                     model_channels=arch_overrides["model_channels"],
                     channel_mult=tuple(arch_overrides["channel_mult"]),
                     attention_resolutions=tuple(arch_overrides["image_size"] // r
                                                 for r in arch_overrides["attention_resolutions"]),
                     num_head_channels=arch_overrides["num_head_channels"],
                     num_res_blocks=arch_overrides["num_res_blocks"])
    return UNetModel(cfg).requires_grad_(False)


@pytest.mark.parametrize("batch", [1, 3])
def test_flop_matches_torch_counter(batch):
    from torch.utils.flop_counter import FlopCounterMode
    arch = Arch.from_preset(dict(image_size=32, num_channels=32, num_res_blocks=1,
                                 attention_resolutions="16", channel_mult="1,2",
                                 num_head_channels=16, use_scale_shift_norm=True,
                                 resblock_updown=True))
    model = port_unet(TINY)
    x = torch.randn(batch, 32, 32, 4, requires_grad=True)
    t = torch.full((batch,), 500.0)
    with FlopCounterMode(display=False) as fc:
        y = model(x, t)
    fwd = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(y[..., :4], x, torch.ones_like(y[..., :4]))
    pull = fc.get_total_flops()
    assert flop(arch, batch) == (fwd, pull)


def test_flop_at_full_width():
    """PERF.md's 2.241 / 2.253 TFLOP (the port's UNet under
    ``FlopCounterMode`` on the card, batch 1), to the digits it gives."""
    fwd, pull = flop(Arch(), 1)
    assert round(fwd / 1e12, 3) == 2.241 and round(pull / 1e12, 3) == 2.253


def test_gn_bytes_match_gn_bench_bounds():
    """``tools/gn_bench``'s bounds a fp32 step at batch 1: 0.956 ms forward,
    1.434 ms backward over the 101 sites; bf16 hybrid 0.498 ms forward."""
    arch = Arch()
    assert len(gn_sites(arch)) == 101
    fwd, bwd = gn_bytes(arch, 1, 4)
    assert round(fwd / HBM * 1e3, 3) == 0.956 and round(bwd / HBM * 1e3, 3) == 1.434
    fwd16, _ = gn_bytes(arch, 1, 2)
    assert round(fwd16 / HBM * 1e3, 3) == 0.498
    assert gn_bytes(arch, 4, 4) == (4 * fwd, 4 * bwd)
    assert dataclasses.replace(arch) == arch


@pytest.mark.parametrize("torso, peak_key", [("fp32", "fp32_flops"), ("bf16", "bf16_flops")])
def test_step_mfu_is_the_traced_steps_flop_over_the_device_busy_time(torso, peak_key):
    """``step_mfu_pct`` reads the traced segments alone: their counted FLOP
    over the device's busy time in them, not the window's wall time; without
    a trace or a busy device it reads nothing."""
    from types import SimpleNamespace

    import run
    read = run.reader(run.HERE, "step_mfu_pct")
    arch = Arch()
    peaks = {"fp32_flops": 67e12, "bf16_flops": 989e12}
    busy = SimpleNamespace(busy_s=lambda: 2.5)
    outcome = SimpleNamespace(lanes=4, trace_steps=40, trace_x_prev=10, steps=999,
                              x_prev_steps=999, window_s=1.0)
    ctx = SimpleNamespace(outcome=outcome, trace=busy, arch=arch, peaks=peaks, torso=torso)
    fwd, pull = flop(arch, 4)
    assert read(ctx) == pytest.approx(100 * (40 * fwd + 10 * pull) / (2.5 * peaks[peak_key]))
    assert read(SimpleNamespace(**dict(vars(ctx), trace=None))) is None
    idle = SimpleNamespace(busy_s=lambda: 0.0)
    assert read(SimpleNamespace(**dict(vars(ctx), trace=idle))) is None
