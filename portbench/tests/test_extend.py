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
    for sub in ("configs", "families", "traffic", "metrics"):
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
                          overrides=TINY)
    capsys.readouterr()
    assert result["correct"] and result["metrics"]["steps_in_window"]["value"] > 0
    assert result["attempted"] == 2 * result["metrics"]["steps_in_window"]["value"]
    assert all(p.read_bytes() == data for p, data in before.items())


NEW = os.path.join(os.path.dirname(os.path.abspath(__file__)), "new_family")
PATCH_TF = dict(image_size=32, patch=4, hidden=64, depth=2, heads=4, mlp=256, freq=64,
                in_channels=4, out_channels=8)


def test_new_family_from_files_alone(bench, tmp_path, capsys):
    """A configuration whose model is not the ADM UNet (``new_family/``: a
    two-block patch transformer, its program-side model and its plain
    reference) added as new files in a copy of the benchmark's folder: a
    run of its cell is correct, the family's control and a fault planted in
    its output are refused, and a per-layer metric reads the family's FLOP."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    import run
    from calibrate import control_kwargs
    from harness.cell import Cell
    home = tmp_path / "portbench"
    skip = shutil.ignore_patterns("__pycache__")
    for sub in ("configs", "families", "reference", "traffic", "metrics"):
        shutil.copytree(os.path.join(HOME, sub), home / sub, ignore=skip)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    shutil.copytree(os.path.join(NEW, "port"), tmp_path / "port", ignore=skip)
    for sub in ("families", "reference"):
        shutil.copy(os.path.join(NEW, "portbench", sub, "patch_tf.py"), home / sub)
    cfg = json.loads((home / "configs" / "osmosis_ref_fp32.json").read_text())
    del cfg["preset"]["unet_model"]
    cfg.update(name="patch_tf_fp32", family="patch_tf", model=PATCH_TF)
    (home / "configs" / "patch_tf_fp32.json").write_text(json.dumps(cfg))
    (home / "metrics" / "model_gflop_per_call.py").write_text(
        "def read(ctx):\n    return ctx.family.flop(ctx.arch, 1)[0] / 1e9\n")
    b = copy.deepcopy(bench)
    b["configs"].append(dict(name="patch_tf_fp32", source="https://arxiv.org/abs/2212.09748",
                             file="portbench/configs/patch_tf_fp32.json", reduced=[],
                             why="a test"))
    b["workloads"].append(dict(name="patch_tf_b1", config="patch_tf_fp32",
                               traffic="phi_window_b1", chips=1, why="a test"))
    b["per_layer"].append(dict(name="model_gflop_per_call", unit="GFLOP", better="lower",
                               source="program_counter", layer="model (families)",
                               moves="image_steps_per_s", workloads=["patch_tf_b1"]))
    result = run.run_cell(b, "patch_tf_b1", 2 ** 31 + 16, 0.5, True, "cpu", home=str(home))
    capsys.readouterr()
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert list(result["metrics"]) == ["model_gflop_per_call"]

    cell = Cell("patch_tf_b1", b, "cpu", home=str(home))
    with FlopCounterMode(display=False) as fc:
        cell.program(1)(torch.randn(1, 32, 32, 4), torch.tensor([500.0]))
    assert result["metrics"]["model_gflop_per_call"]["value"] * 1e9 == fc.get_total_flops()
    seed = 2 ** 31 + 17
    control = cell.run(seed, 0.5, **control_kwargs(cell, seed))
    assert not control.correct, control.gaps
    fault = cell.run(seed, 0.5, swap_model=lambda m: lambda x, t: m(x, t) * (1 + 1e-3))
    assert not fault.correct and fault.gaps["eps"] > cfg["limits"]["eps"], fault.gaps
    assert all(p.read_bytes() == data for p, data in before.items())
