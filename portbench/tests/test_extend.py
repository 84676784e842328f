"""A cell, a configuration, a traffic mix and a per-layer metric added as new
files in a copy of the benchmark's folder and new entries of the
benchmark's table, with no file of it edited."""

import copy
import json
import os
import shutil

from conftest import HOME, TINY


def test_new_cell_from_files_alone(bench, tmp_path, capsys):
    import run
    home = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(HOME, sub), home / sub)
    before = {p: p.read_bytes() for p in home.rglob("*") if p.is_file()}
    cfg = json.loads((home / "configs" / "osmosis_ref_fp32.json").read_text())
    cfg["preset"]["sample_pattern"]["n_iter"] = 5
    (home / "configs" / "osmosis_ref_fp32_n5.json").write_text(json.dumps(cfg))
    mix = json.loads((home / "traffic" / "phi_window_b1.json").read_text())
    mix["lanes"] = 2
    (home / "traffic" / "phi_window_fleet2.json").write_text(json.dumps(mix))
    (home / "metrics" / "steps_in_window.py").write_text(
        "def read(ctx):\n    return ctx.outcome.steps\n")
    b = copy.deepcopy(bench)
    b["configs"].append(dict(b["configs"][0], name="osmosis_ref_fp32_n5",
                             file="portbench/configs/osmosis_ref_fp32_n5.json"))
    b["workloads"].append(dict(name="ref_n5_fleet2", config="osmosis_ref_fp32_n5",
                               traffic="phi_window_fleet2", chips=1, why="a test"))
    b["per_layer"].append(dict(name="steps_in_window", unit="steps", better="higher",
                               source="program_counter", layer="guided step (diffusion/guided)",
                               moves="image_steps_per_s", workloads=["ref_n5_fleet2"]))
    result = run.run_cell(b, "ref_n5_fleet2", 5, 0.5, True, "cpu", home=str(home),
                          unet_overrides=TINY)
    capsys.readouterr()
    assert result["correct"] and result["metrics"]["steps_in_window"]["value"] > 0
    assert result["attempted"] == 2 * result["metrics"]["steps_in_window"]["value"]
    assert all(p.read_bytes() == data for p, data in before.items())
