"""Each cell's whole run path, on the CPU at a tiny UNet: the facts, the
compared numbers and a well-formed result line."""

import json

import pytest

from conftest import TINY

CELLS = ("ref_fp32_b1", "hybrid_bf16_b1", "hybrid_bf16_fleet4")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(bench, capsys, cell, trace, **kw):
    import run as runner
    result = runner.run_cell(bench, cell, 2 ** 31 + 12345, 1.0, trace, "cpu",
                             overrides=TINY, **kw)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(result))
    return last, out, err


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_run_path(bench, capsys, cell, trace):
    last, out, err = run(bench, capsys, cell, bool(trace))
    assert list(last)[:5] == RESULT_KEYS and list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] > 0
    names = [m["name"] for m in bench["per_layer" if trace else "end_to_end"]]
    if trace:
        assert "breakdown" in last and last["device"]["window_s"] > 0
        assert {"launches_per_step", "device_idle_pct"} <= set(last["metrics"])
        # no card: no share of a card's peak, and no allocator peak
        assert not {"step_mfu_pct", "gn_roofline_pct", "peak_mem_gib"} & set(last["metrics"])
    else:
        assert set(last["metrics"]) == set(names)
    for m in last["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    assert "departure from the preset: clip_denoised" in out
    assert "the phi-update slice t = " in out and "gradient clip" in out
    checks = [line for line in err.strip().splitlines() if line.startswith("check ")]
    assert checks and err.strip().splitlines()[-len(checks):] == checks


def test_tap_holds_a_bounded_uniform_sample():
    """The recorder keeps its fixed steps and k more, each with the input of
    the step after it, and nothing else, however long the window."""
    import numpy as np
    import torch
    from harness.cell import Tap
    counts = np.zeros(400)
    for seed in range(60):
        tap = Tap(lambda x, t: 2 * x)
        tap.arm({0, 19}, 6, np.random.default_rng(seed))
        for s in range(400):
            tap(torch.full((1,), float(s)), None)
        rec = sorted(k for k, v in tap.kept.items() if "out" in v)
        assert set(rec) == {0, 19} | set(tap.pool) and len(rec) == 8
        assert set(tap.kept) == set(rec) | {s + 1 for s in rec if s + 1 < 400}
        assert all(float(tap.kept[s]["x"]) == s for s in tap.kept)
        counts[[s for s in tap.pool]] += 1
    # uniform over the other steps: the first and second half about alike
    assert abs(counts[:200].sum() - counts[200:].sum()) < 0.25 * counts.sum()
