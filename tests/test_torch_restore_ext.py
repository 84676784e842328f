"""The port's restore extensions through ``run_restoration`` on the CPU:
best_of / accept_loss / phi_jitter, global_eta_scale, async_save, the
``perf:`` section, the fleet (data.batch_size > 1) with its tail chunk and
GT grids, the phase summary, and the CLI's ``--bf16`` and ``--progress``,
on the serial and fleet paths.
A tiny random-init UNet, 32² images, 8 respaced steps."""

import dataclasses
import json
import os
import re
from os.path import join as pjoin

import numpy as np
import pytest
import yaml
from PIL import Image

from osmosis_tpu_torch import perf as PF
from osmosis_tpu_torch.pipelines import restore as R
from osmosis_tpu_torch.pipelines.restore import _better_loss, run_restoration
from osmosis_tpu_torch.utils.profiling import PhaseTimers
from tests.test_torch_chain_checkpoint import _cfg, _pngs
from tests.test_torch_pipeline import images, one_torch_thread  # noqa: F401


def _edit(path, change):
    with open(path) as f:
        cfg = yaml.safe_load(f)
    change(cfg)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)


def _rows(out):
    with open(pjoin(out, "progress.json")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _log(out):
    with open(pjoin(out, "log.txt")) as f:
        return f.read()


def test_better_loss_and_its_nan_arm():
    assert _better_loss(1.0, None)
    assert _better_loss(1.0, 2.0) and not _better_loss(2.0, 1.0)
    assert _better_loss(3.0, float("nan"))  # a finite trial displaces a diverged one
    assert not _better_loss(float("nan"), 1.0)
    assert not _better_loss(float("nan"), float("nan"))


def test_best_of_with_phi_jitter_keeps_the_lowest_loss(tmp_path, images):  # noqa: F811
    out = run_restoration(_cfg(tmp_path, images, "a", False, best_of=3, phi_jitter=0.05,
                               sample_pattern=dict(pattern="original")), device="cpu")
    log = _log(out)
    # two images, three restarts each, every restart with its own final loss
    losses = [float(v) for v in re.findall(r"restart \d: final loss (\S+)", log)]
    kept = [float(v) for v in re.findall(r"kept restart with final loss (\S+)", log)]
    assert len(losses) == 6 and len(kept) == 2
    assert kept == [min(losses[:3]), min(losses[3:])]
    assert len(set(losses[:3])) == 3  # other seeds and jittered phi: other chains
    rows = _rows(out)
    assert [r["final_loss"] for r in rows] == pytest.approx(kept, abs=1e-4)


def test_accept_loss_stops_the_restarts(tmp_path, images):  # noqa: F811
    out = run_restoration(_cfg(tmp_path, images, "a", False, best_of=3, accept_loss=1e9,
                               sample_pattern=dict(pattern="original")), device="cpu")
    log = _log(out)
    assert log.count("restart 0: final loss") == 2 and "restart 1:" not in log


@pytest.mark.parametrize("fleet", [False, True], ids=["serial", "fleet"])
def test_global_eta_scale_zero_freezes_phi_in_later_chains(tmp_path, images, fleet):  # noqa: F811
    path = _cfg(tmp_path, images, "a", fleet)
    _edit(path, lambda cfg: cfg["sample_pattern"].update(global_eta_scale=0.0))
    rows = _rows(run_restoration(path, device="cpu"))  # global_N 2: chain 0 moves phi
    for img in ("img_0.png", "img_1.png"):
        first, second = [r for r in rows if r["image"] == img]
        assert first["phi_a_0"] != 1.1
        assert {k: v for k, v in first.items() if k.startswith("phi_")} == \
            {k: v for k, v in second.items() if k.startswith("phi_")}


@pytest.mark.parametrize("fleet", [False, True], ids=["serial", "fleet"])
def test_async_save_writes_the_same_files(tmp_path, images, fleet):  # noqa: F811
    out_a = run_restoration(_cfg(tmp_path, images, "a", fleet), device="cpu")
    # a perf: section with TPU layout knobs too: accepted, noted as having no effect
    perf = dict(async_save=True, strip_conv=False, scan_unroll=1, pallas_upsample=True)
    out_b = run_restoration(_cfg(tmp_path, images, "b", fleet, perf=perf), device="cpu")
    assert _pngs(out_a) == _pngs(out_b) and len(_pngs(out_b)) == 14
    order = (["img_0.png", "img_1.png"] * 2 if fleet
             else ["img_0.png"] * 2 + ["img_1.png"] * 2)
    assert [r["image"] for r in _rows(out_b)] == order
    snap = open(pjoin(out_b, "configurations.txt")).read()
    assert "perf.async_save: True\n" in snap
    assert "perf.strip_conv: False  # no effect in the port" in snap
    # a later run without a perf: section starts from the defaults again
    out_c = run_restoration(_cfg(tmp_path, images, "c", fleet), device="cpu")
    assert "perf.async_save: False\n" in open(pjoin(out_c, "configurations.txt")).read()


@pytest.mark.parametrize("fleet", [False, True], ids=["serial", "fleet"])
def test_async_save_reraises_a_worker_error(tmp_path, images, monkeypatch, fleet):  # noqa: F811
    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(R, "_save_osmosis_outputs", broken)
    with pytest.raises(OSError, match="disk full"):
        run_restoration(_cfg(tmp_path, images, "a", fleet, perf=dict(async_save=True)),
                        device="cpu")


def test_configure_from_dict_accepts_every_jax_knob():
    from osmosis_tpu import perf as JPF

    jax_knobs = {f.name: f.default for f in dataclasses.fields(JPF.PerfConfig)}
    assert PF.DEFAULTS == jax_knobs
    cfg = PF.configure_from_dict(dict(jax_knobs, async_save=True, strip_count=8))
    assert cfg.async_save is True and cfg.values["strip_count"] == 8
    text = PF.snapshot_text(cfg)
    for k in jax_knobs:
        assert f"perf.{k}: " in text
    assert "perf.strip_count: 8  # no effect in the port" in text
    assert text.count("no effect in the port") == len(jax_knobs) - 1
    assert PF.configure_from_dict(None).async_save is False
    with pytest.raises(KeyError):
        PF.configure_from_dict({"not_a_knob": 1})


def _gt_images(root, n):
    import cv2

    rng = np.random.default_rng(1)
    for sub in ("input", "gt_rgb", "gt_depth"):
        os.makedirs(pjoin(root, sub))
    for i in range(n):
        for sub in ("input", "gt_rgb"):
            Image.fromarray(rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)).save(
                pjoin(root, sub, f"img_{i}.png"))
        cv2.imwrite(pjoin(root, "gt_depth", f"img_{i}.png"),
                    rng.integers(0, 65535, (40, 48), dtype=np.uint16))


def test_fleet_runs_chunks_with_a_tail_and_gt_grids(tmp_path):
    """Three GT images at batch 2: a chunk of 2 and a tail chunk of 1; each
    image's row close to its serial run's (lane-separable against the serial
    path's joint loss at batch 1: float32 reductions grouped otherwise)."""
    root = str(tmp_path / "sim")
    _gt_images(root, 3)
    data = dict(name="sim", root=pjoin(root, "input"), gt_rgb=pjoin(root, "gt_rgb"),
                gt_depth=pjoin(root, "gt_depth"), stop_after=-1, ground_truth=True)
    outs = {}
    for fleet in (False, True):
        path = _cfg(tmp_path, pjoin(root, "input"), f"f{int(fleet)}", fleet)
        _edit(path, lambda cfg: cfg.update(data=dict(data, batch_size=2 if fleet else 1)))
        outs[fleet] = run_restoration(path, device="cpu")
    log = _log(outs[True])
    assert "tail chunk of 1 images" in log and log.count("fleet chunk ") == 2
    for i in range(3):
        for g in (0, 1):
            assert os.path.exists(pjoin(outs[True], "grid_results", f"img_{i}_g{g}_grid.png"))
    serial, fleet = _rows(outs[False]), _rows(outs[True])
    key = lambda r: (r["image"], r["global_iter"])  # noqa: E731
    assert sorted(map(key, serial)) == sorted(map(key, fleet))
    by_key = {key(r): r for r in serial}
    for r in fleet:
        s = by_key[key(r)]
        assert r["batch"] == (1 if r["image"] == "img_2.png" else 2)
        assert r["final_loss"] == pytest.approx(s["final_loss"], rel=1e-4)
        for k in (k for k in s if k.startswith("phi_")):
            assert r[k] == pytest.approx(s[k], abs=2e-6)
    grid = np.asarray(Image.open(pjoin(outs[True], "grid_results", "img_0_g0_grid.png")))
    assert grid.shape[0] > grid.shape[1] / 2  # two rows: outputs over the GT


def test_phase_timers_summarise_each_phase():
    timers = PhaseTimers()
    for name in ("sample", "sample", "save"):
        with timers.phase(name):
            pass
    summary = timers.summary()
    assert re.search(r"sample\s+\d+\.\d\ds / 2 calls", summary)
    assert re.search(r"save\s+\d+\.\d\ds / 1 calls", summary)


def test_phase_timers_count_every_call_from_many_threads():
    import sys
    import threading

    timers, n_threads, n_calls = PhaseTimers(), 32, 300
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_calls):
                with timers.phase("save"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    assert timers.counts["save"] == n_threads * n_calls


@pytest.mark.parametrize("fleet", [False, True], ids=["serial", "fleet"])
def test_cli_bf16_and_progress(tmp_path, images, capsys, fleet):  # noqa: F811
    from osmosis_tpu_torch.sample import main

    out = main(["-c", _cfg(tmp_path, images, "a", fleet), "--cpu", "--bf16", "--progress", "2"])
    assert "bf16 torso, fp32 GroupNorm statistics" in _log(out)
    printed = capsys.readouterr().out
    # timesteps 6, 4, 2, 0 of 8 for each of the 2 global chains: of each of
    # the 2 images, or of the fleet's one chain over both
    rows = re.findall(r"^  t=\s*(\d+) loss=\S+ \{'phi_a'", printed, re.M)
    assert [int(t) for t in rows] == [6, 4, 2, 0] * (2 if fleet else 4)
    assert len(_rows(out)) == 4


def test_gt_depth_reads_the_same_without_opencv(tmp_path, monkeypatch):
    import sys

    from osmosis_tpu_torch.data import datasets as D

    root = str(tmp_path / "sim")
    _gt_images(root, 1)
    path = pjoin(root, "gt_depth", "img_0.png")
    with_cv2 = D._read_unchanged(path)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    without = D._read_unchanged(path)
    assert with_cv2.dtype == without.dtype == np.uint16
    assert np.array_equal(with_cv2, without)
