"""The port's ``seed_replicate`` (``osmosis_tpu_torch.tools.seed_replicate``)
against the JAX tool on the CPU: the cells, the resume predicate and the
summary of ``tests/test_seed_replicate.py``'s rows are the JAX tool's, and a
cell runs through the port's ``validate_toy_e2e`` (the subprocess replaced)
and lands in the grid with its seed. Nothing here runs a chain."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from osmosis_tpu_torch.tools import seed_replicate as SR

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools import seed_replicate as JSR  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _row(name, gain, corr, seed=None, **extra):
    r = {"row": name, "psnr_gain_db": gain, "depth_corr_mean": corr, **extra}
    if seed is not None:
        r["seed"] = seed
    return r


ROWS = {
    "ranking_survives": [
        _row("r256_s50_x0", 10.65, 0.25), _row("r256_s50_x0", 10.2, 0.22, seed=1),
        _row("r256_s50_x0", 10.9, 0.28, seed=2),
        _row("r256_s50_hyb4", 8.09, 0.30), _row("r256_s50_hyb4", 7.5, 0.25, seed=1),
        _row("r256_s50_hyb4", 8.4, 0.33, seed=2),
        _row("r256_s50_eta2.5e-4", 2.52, 0.16),
        _row("r256_s25_hyb4", 6.36, 0.23), _row("r256_s25_hyb4", 5.9, 0.20, seed=1),
        _row("r256_s25_hyb4", 6.7, 0.25, seed=2), _row("r256_s25_ddpm", 1.42, 0.28),
        _row("r256_s25_x0", 3.1, 0.03, **{"pass": False}),
        _row("r256_s25_x0", 3.4, 0.21, seed=1, **{"pass": True}),
        _row("r256_s100_x0", 10.59, 0.22), _row("r256_s100_x0", 10.4, 0.20, seed=1),
        _row("r256_s100_x0", 10.8, 0.24, seed=2),
    ],
    "ranking_collapses": [
        _row("r256_s50_x0", 10.65, 0.25), _row("r256_s50_x0", 7.0, 0.1, seed=1),
        _row("r256_s50_x0", 8.0, 0.15, seed=2),
        _row("r256_s50_hyb4", 8.09, 0.30), _row("r256_s50_hyb4", 8.0, 0.28, seed=1),
        _row("r256_s50_hyb4", 8.2, 0.31, seed=2),
    ],
    "single_draw": [_row("r128_s100_x0", 10.43, 0.398)],
    "knee_without_comparator": [_row("r256_s25_hyb4", 6.36, 0.23),
                                _row("r256_s25_hyb4", 5.9, 0.20, seed=1)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(ROWS))
def test_summary_is_the_jax_tools(case):
    got = SR.summarize(ROWS[case])
    assert got == JSR.summarize(ROWS[case])
    if case == "ranking_survives":
        chk = got["checks"]
        assert chk["mode_ranking_256px_50steps"]["survives"] is True
        assert chk["knee_25steps_hyb4_above_collapse"]["x0_25_depth_gate_failures"] == "1/2 draws"
        assert chk["x0_100_vs_50_256px"]["within_noise"] is True
    if case == "ranking_collapses":
        assert got["checks"]["mode_ranking_256px_50steps"]["survives"] is False


def test_cells_and_resume_predicate_are_the_jax_tools():
    assert SR.CELLS == JSR.CELLS
    rows = [_row("r128_s50_x0", 10.0, 0.3, seed=1), _row("r256_s50_x0", 9.0, 0.2)]
    for cell in SR.CELLS:
        for seed in (0, 1, 2, None):
            assert SR.have(rows, cell, seed) == JSR.have(rows, cell, seed), (cell, seed)
    assert SR.have(rows, "r128_s50_x0", 1) and not SR.have(rows, "r128_s50_x0", 2)
    assert SR.GRID.endswith("grid_3a_ii_torch.jsonl") and SR.GRID != JSR.GRID
    assert SR.SUMMARY.endswith("seed_replication_3a_ii_torch.json") and SR.SUMMARY != JSR.SUMMARY


def test_run_cell_drives_the_ports_validate_toy_e2e(tmp_path, monkeypatch):
    """A cell's command is the port's validate_toy_e2e with the cell's flags,
    the override after them, its seed and row name, and the device flags;
    its JSON row is appended to the grid with its seed, and a cell already
    in the grid at that seed is not run again."""
    calls = []

    def fake_run(cmd, cwd, capture_output, text, timeout):
        calls.append((cmd, cwd))
        seed = int(cmd[cmd.index("--sample-seed") + 1])
        row = {"row": cmd[cmd.index("--row-name") + 1], "psnr_gain_db": 1.0 + seed,
               "depth_corr_mean": 0.1, "seed": seed}
        return SimpleNamespace(returncode=1, stdout="triage\n" + json.dumps(row) + "\n",
                               stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    grid, summary = tmp_path / "grid.jsonl", tmp_path / "summary.json"
    argv = ["--cells", "r128_s50_x0", "--seeds", "1", "2", "--grid", str(grid),
            "--summary", str(summary), "--override", "--checkpoint ck.msgpack --scenes 2",
            "--cpu"]
    SR.main(argv)
    assert len(calls) == 2
    cmd, cwd = calls[0]
    assert cmd[:3] == [sys.executable, "-m", "osmosis_tpu_torch.tools.validate_toy_e2e"]
    assert cwd == SR.ROOT
    flags = cmd[3:]
    cell = SR.CELLS["r128_s50_x0"].split()
    assert flags[:len(cell)] == cell
    assert flags[len(cell):] == ["--checkpoint", "ck.msgpack", "--scenes", "2",
                                 "--sample-seed", "1", "--row-name", "r128_s50_x0", "--cpu"]
    rows = SR.load_grid(str(grid))
    assert [(r["row"], r["seed"]) for r in rows] == [("r128_s50_x0", 1), ("r128_s50_x0", 2)]
    with open(summary) as f:
        assert json.load(f)["cells"]["r128_s50_x0"]["seeds"] == [1, 2]
    SR.main(argv)  # both seeds are in the grid now: nothing runs
    assert len(calls) == 2 and len(SR.load_grid(str(grid))) == 2
    with pytest.raises(SystemExit):
        SR.main(["--seeds", "0", "--grid", str(grid)])


def test_a_crashed_cell_adds_no_row(tmp_path, monkeypatch):
    monkeypatch.setattr(subprocess, "run", lambda *a, **kw: SimpleNamespace(
        returncode=2, stdout="", stderr="Traceback: CUDA error"))
    assert SR.run_cell("r128_s50_x0", 1, ["-d", "0"]) is None
    grid = tmp_path / "grid.jsonl"
    SR.main(["--cells", "r128_s50_x0", "--seeds", "1", "--grid", str(grid),
             "--summary", str(tmp_path / "s.json")])
    assert not grid.exists()
