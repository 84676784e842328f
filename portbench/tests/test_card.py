"""On a card: every cell's run path at a tiny UNet (the look for a card,
the kernels' build, the device trace)."""

import json

import pytest

from conftest import TINY


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ref_fp32_b1", "hybrid_bf16_b1", "hybrid_bf16_fleet4"])
def test_cell_on_card(bench, card, capsys, cell):
    import run
    result = run.run_cell(bench, cell, 3, 1.0, True, card, overrides=TINY)
    capsys.readouterr()
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert {"launches_per_step", "step_mfu_pct", "device_idle_pct", "peak_mem_gib"} <= set(
        result["metrics"])
    json.dumps(result)
