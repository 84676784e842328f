"""The port's day-one runbook (``osmosis_tpu_torch.tools.real_weights_runbook``)
on the CPU, after ``tests/test_runbook.py``: the per-chain contraction gate,
the phi-stall gate, skipping haze with a prebuilt sim dir, the ``--tiny``
self-test with one preset plus the prior, a preset failure that does not
abort the sweep, NaN against absent x0_std, and the gates against the JAX
tool's on run dirs written by either package's ``run_restoration``."""

import json
import os
import sys
from os.path import join as pjoin

import numpy as np
import pytest
import torch
import yaml

from osmosis_tpu_torch.tools import real_weights_runbook as RB
from tests.test_torch_pipeline import _config, images, one_torch_thread  # noqa: F401


def _telemetry_block(rows):
    """One _log_trace_summary block as restore.py writes it."""
    lines = ["chain telemetry (scan trace; step runs t=T-1..0):"]
    for t, loss, std in rows:
        lines.append(f"  t={t:4d} loss={loss:9.3f} x0_std={std:.3f}"
                     " {'phi_a': [1.1, 0.95, 0.95]}")
    return "\n".join(lines)


def _progress_row(done, total, t, std):
    """A progress_segments row: its x0_std= token is not chain telemetry."""
    return (f"  progress {done:4d}/{total} steps (t={t})"
            f" loss={100.0:9.3f} x0_std={std:.3f}")


def _write_log(tmp_path, name, text):
    d = tmp_path / name
    d.mkdir()
    (d / "log.txt").write_text(text + "\n")
    return str(d)


TS = [999, 888, 777, 666, 555, 444, 333, 222, 111, 0]
CONTRACTING = [1.6, 1.5, 1.2, 0.9, 0.6, 0.45, 0.4, 0.37, 0.35, 0.34]


def test_x0_contraction_gate_per_chain(tmp_path):
    run = _write_log(tmp_path, "ok", _telemetry_block(list(zip(TS, [12.0] * 10, CONTRACTING))))
    ok, detail = RB.check_x0_contraction(run)
    assert ok, detail

    # flat amplitude after progress rows whose large x0_std would fake an
    # early maximum if they were read as telemetry
    text = "\n".join([_progress_row(250, 1000, 749, 9.999), _progress_row(500, 1000, 499, 9.999),
                      _telemetry_block(list(zip(TS, [50.0] * 10, [1.0] * 10)))])
    ok, detail = RB.check_x0_contraction(_write_log(tmp_path, "flat", text))
    assert not ok, detail

    # two flat chains that a whole-file parse would pass
    text = "\n".join([_telemetry_block(list(zip(TS, [50.0] * 10, [1.0] * 10))),
                      "some unrelated log line",
                      _telemetry_block(list(zip(TS, [50.0] * 10, [0.5] * 10)))])
    ok, detail = RB.check_x0_contraction(_write_log(tmp_path, "mix", text))
    assert not ok, detail

    text = "\n".join([_telemetry_block(list(zip(TS, [12.0] * 10, CONTRACTING))),
                      _telemetry_block(list(zip(TS, [12.0] * 10, [s * 2 for s in CONTRACTING])))])
    ok, detail = RB.check_x0_contraction(_write_log(tmp_path, "mix_ok", text))
    assert ok and "2 chain" in detail, detail

    ok, _ = RB.check_x0_contraction(_write_log(tmp_path, "empty", "nothing here"))
    assert ok


def test_phi_stall_gate_requires_high_final_loss(tmp_path):
    cfg = dict(measurement=dict(operator=dict(
        name="underwater_physical_revised", optimizer="sgd",
        phi_a="1.1,0.95,0.95", phi_a_eta=1e-5, phi_a_learn_flag=True,
        phi_b="0.95,0.8,0.8", phi_b_eta=0.0,
        phi_inf="0.14,0.29,0.49", phi_inf_eta=0.0)))
    frozen = {"phi_a_0": 1.1, "phi_a_1": 0.95, "phi_a_2": 0.95}
    ts = [40, 30, 20, 10, 0]

    def mk(name, losses, row=frozen, log=True):
        d = tmp_path / name
        d.mkdir()
        (d / "progress.json").write_text(json.dumps(row) + "\n")
        if log:
            (d / "log.txt").write_text(_telemetry_block(
                list(zip(ts, losses, [1.0, 0.8, 0.6, 0.5, 0.5]))) + "\n")
        return str(d)

    assert RB.check_phi_stall(cfg, mk("converged", [100, 60, 30, 10, 5])) is False
    assert RB.check_phi_stall(cfg, mk("stuck", [100, 99, 98, 97, 96])) is True
    assert RB.check_phi_stall(cfg, mk("nolog", None, log=False)) is True
    assert RB.check_phi_stall(cfg, mk("moved", None, dict(frozen, phi_a_0=0.9), False)) is False


def _main_with_fakes(monkeypatch, tmp_path, presets, fake_run_preset, extra=()):
    ckpt = tmp_path / "ck.pt"
    ckpt.write_bytes(b"x")
    sim = tmp_path / "sim"
    sim.mkdir()
    out = tmp_path / "out"
    monkeypatch.setattr(RB, "sh", lambda cmd, log_path=None, check=True:
                        "parity ok\nrel err 0\nconverted\n")
    monkeypatch.setattr(RB, "run_preset", fake_run_preset)
    RB.main(["--checkpoint", str(ckpt), "--sim-dir", str(sim), "--out", str(out),
             "--presets", presets, "--cpu", *extra])
    with open(out / "RUNBOOK_REPORT.json") as f:
        return json.load(f), (out / "RUNBOOK_REPORT.md").read_text()


def test_runbook_prebuilt_simdir_skips_haze_instead_of_aborting(tmp_path, monkeypatch):
    calls = []
    report, md = _main_with_fakes(
        monkeypatch, tmp_path, "reference,fast,haze,prior",
        lambda name, ctx, report: (calls.append(name),
                                   report["presets"].setdefault(name, {"ran": True})))
    assert calls == ["reference", "fast", "prior"]  # haze dropped, the rest ran
    assert "skipped" in report["presets"]["haze"]
    assert "SKIPPED" in md


def test_runbook_preset_failure_does_not_abort_sweep(tmp_path, monkeypatch):
    calls = []

    def fake_run_preset(name, ctx, report):
        calls.append(name)
        if name == "fast":
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        report["presets"].setdefault(name, {"ran": True})

    rehearsal = tmp_path / "rehearsal.json"
    report, md = _main_with_fakes(monkeypatch, tmp_path, "reference,fast,prior",
                                  fake_run_preset, ("--rehearsal-json", str(rehearsal)))
    assert calls == ["reference", "fast", "fast", "prior"]  # fast retried once
    assert "illegal memory access" in report["presets"]["fast"]["error"]
    assert report["presets"]["prior"] == {"ran": True}
    assert "ERROR" in md
    with open(rehearsal) as f:
        rj = json.load(f)
    errs = [s for s in rj["stages"] if s["stage"] == "preset:fast:error"]
    assert len(errs) == 2 and errs[-1]["attempt"] == 2
    assert rj["device"] == "cpu" and rj["mode"] == "production-geometry"


def test_contraction_gate_nan_vs_absent_x0_std(tmp_path):
    lines = ["chain telemetry (scan trace; step runs t=T-1..0):"]
    lines += [f"  t={t:4d} loss=      nan x0_std=nan {{}}" for t in TS]
    ok, detail = RB.check_x0_contraction(_write_log(tmp_path, "nan", "\n".join(lines)))
    assert not ok, detail

    lines = ["chain telemetry (scan trace; step runs t=T-1..0):"]
    lines += [f"  t={t:4d} loss={50.0 - 4 * i:9.3f}" for i, t in enumerate(TS)]
    run = _write_log(tmp_path, "lossonly", "\n".join(lines))
    ok, detail = RB.check_x0_contraction(run)
    assert ok and "no x0_std" in detail
    chains = RB.parse_chain_telemetry(pjoin(run, "log.txt"))
    assert len(chains) == 1 and len(chains[0]) == 10
    assert all(std is None for _, _, std in chains[0])
    assert chains[0][-1][1] == 14.0


def test_every_preset_takes_the_smoke_cut(tmp_path):
    """``--smoke-steps`` cuts each preset's chain last (over the turbo
    presets' own respacing) and keeps its n_iter and widths."""
    for name, base in RB.PRESET_BASES.items():
        if name == "prior":
            continue
        base_cfg = RB._load_cfg(pjoin(RB.CONFIGS, base))
        cfg, path = RB.make_preset_cfg(base_cfg, name, checkpoint="ck.msgpack",
                                       sim_dir=str(tmp_path), out_dir=str(tmp_path),
                                       stop_after=1, smoke_steps=10)
        assert cfg["diffusion"]["timestep_respacing"] == "ddim10", name
        assert cfg["diffusion"]["sampler"] == "ddim" and cfg["diffusion"]["clip_denoised"]
        assert cfg["sample_pattern"]["n_iter"] == base_cfg["sample_pattern"]["n_iter"]
        assert cfg["unet_model"]["num_channels"] == base_cfg["unet_model"]["num_channels"]
        with open(path) as f:
            assert yaml.safe_load(f) == cfg


def test_runbook_tiny_single_preset(tmp_path):
    """``--tiny --cpu``: a tiny random checkpoint from the port's
    validate_checkpoint, a simulated set, the reference preset scored and
    gated, the prior's smoke row, the report."""
    out = str(tmp_path / "rb")
    report = RB.main(["--tiny", "--cpu", "--out", out, "--stop-after", "1",
                      "--presets", "reference,prior"])
    with open(pjoin(out, "RUNBOOK_REPORT.json")) as f:
        assert json.load(f)["presets"].keys() == report["presets"].keys()
    assert report["checkpoint"].endswith(".msgpack")
    entry = report["presets"]["reference"]
    assert {"psnr_mean", "ssim_mean", "phi_mae"} <= set(entry["score"])
    assert "x0_std_contraction" in entry
    prior = report["presets"]["prior"]
    assert prior["score"]["n_images"] == 2 and len(prior["prior_stats"]) == 2
    assert prior["x0_std_contraction"]["ok"] is True
    assert os.path.exists(pjoin(out, "RUNBOOK_REPORT.md"))
    stages = [s["stage"] for s in report["stage_seconds"]]
    assert stages[:2] == ["stage1_convert", "stage2_simulate"]
    assert "preset:reference" in stages and "preset:prior" in stages
    with open(pjoin(entry["run_dir"], "log.txt")) as f:
        log = f.read()
    assert "Convolution algorithms: cpu (no cuDNN)" in log and "Host ops: " in log


@pytest.fixture(scope="module")
def jax_tool():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tools import real_weights_runbook as JRB

    return JRB


def test_gates_agree_with_the_jax_tool(tmp_path, images, jax_tool):  # noqa: F811
    """On one run dir written by the port's run_restoration and one by the
    JAX package's (the same tiny config), the port's parse_phi_rows,
    check_phi_stall, parse_chain_telemetry and check_x0_contraction give the
    JAX tool's results."""
    from osmosis_tpu.pipelines import run_restoration as jax_run_restoration
    from osmosis_tpu_torch.pipelines.restore import run_restoration

    diffusion = dict(sampler="ddim", steps=1000, noise_schedule="linear",
                     model_mean_type="epsilon", model_var_type="learned_range",
                     dynamic_threshold=False, clip_denoised=True, min_max_denoised=False,
                     rescale_timesteps=False, timestep_respacing="ddim4")
    pattern = dict(pattern="pcgs", update_start=1.0, update_end=0, global_N=1, local_M=1,
                   s_start=1, s_end=0, n_iter=2, start_guidance=1, stop_guidance=0)
    # one tiny UNet for both packages, as a .msgpack in the JAX layout (JAX's
    # random-init fallback would spend half a minute in flax's init)
    from osmosis_tpu_torch.models import convert as C
    from osmosis_tpu_torch.models.unet import unet_config_from_yaml
    from tests.test_torch_pipeline import TINY_UNET

    ucfg = unet_config_from_yaml(TINY_UNET)
    ckpt = str(tmp_path / "tiny.msgpack")
    C.save_params_msgpack(C.params_from_state_dict(C.init_unet(ucfg, seed=0).state_dict(), ucfg),
                          ckpt)
    runs = {}
    for who, run in (("port", lambda p: run_restoration(p, device="cpu")),
                     ("jax", jax_run_restoration)):
        # x0 guidance (no UNet pullback) keeps the JAX chain's compile short
        path = _config(tmp_path, images, diffusion=diffusion, sample_pattern=pattern,
                       conditioning=dict(method="osmosis", params=dict(
                           loss_function="norm", loss_weight="depth",
                           weight_function="gamma,1.4,1.4,1", scale="7,7,7,0.9",
                           gradient_x_prev=False, gradient_clip="True,0.005")),
                       record_process=False, unet_model=dict(TINY_UNET, model_path=ckpt),
                       data=dict(batch_size=1, name="tiny", root=images,
                                                       stop_after=2, ground_truth=False),
                       save_dir=str(tmp_path / f"results_{who}"))
        with open(path) as f:
            cfg = yaml.safe_load(f)
        runs[who] = run(path)
    for who, run_dir in runs.items():
        log = pjoin(run_dir, "log.txt")
        rows = RB.parse_phi_rows(run_dir)
        assert len(rows) == 2 and rows == jax_tool.parse_phi_rows(run_dir), who
        chains = RB.parse_chain_telemetry(log)
        assert len(chains) == 2 and len(chains[0]) == 4, (who, chains)
        assert str(chains) == str(jax_tool.parse_chain_telemetry(log)), who  # NaN-safe
        assert RB.check_phi_stall(cfg, run_dir) == jax_tool.check_phi_stall(cfg, run_dir), who
        # phi_inf moves, the others barely: as if phi_inf were not learned, the
        # gate reaches the loss exemption, which each bar turns both ways
        frozen = yaml.safe_load(yaml.safe_dump(cfg))
        frozen["measurement"]["operator"]["phi_inf_eta"] = 0.0
        verdicts = [RB.check_phi_stall(frozen, run_dir, loss_high_rel=r) for r in (0.0, 1.0)]
        assert verdicts == [True, False], (who, verdicts)
        assert verdicts == [jax_tool.check_phi_stall(frozen, run_dir, loss_high_rel=r)
                            for r in (0.0, 1.0)], who
        assert RB.check_x0_contraction(run_dir) == jax_tool.check_x0_contraction(run_dir), who
    assert np.isfinite([r["final_loss"] for r in RB.parse_phi_rows(runs["port"])]).all()
    assert torch.get_num_threads() == 1


def test_synth_builds_both_simulation_sets(tmp_path, monkeypatch):
    """``--synth N`` (the rehearsal's source, no dataset) builds the
    underwater and the haze set from N procedural 256px scenes, through the
    port's simulate_degraded with the run's device flags."""
    ckpt = tmp_path / "ck.pt"
    ckpt.write_bytes(b"x")
    cmds = []
    monkeypatch.setattr(RB, "sh", lambda cmd, log_path=None, check=True:
                        cmds.append(cmd) or "converted\n")
    monkeypatch.setattr(RB, "run_preset", lambda name, ctx, report:
                        report["presets"].setdefault(name, {"sim": ctx["sim_dir"]}))
    report = RB.main(["--checkpoint", str(ckpt), "--synth", "2", "--out", str(tmp_path / "out"),
                      "--presets", "reference,haze", "--cpu"])
    sims = [c for c in cmds if c[2] == "osmosis_tpu_torch.tools.simulate_degraded"]
    assert [c[c.index("--operator") + 1] for c in sims] == ["underwater_physical",
                                                             "haze_physical"]
    for c in sims:
        assert c[c.index("--synth") + 1] == "2" and c[c.index("--size") + 1] == "256"
        assert c[-1] == "--cpu" and "--gt-rgb" not in c
    assert report["presets"]["reference"]["sim"] == str(tmp_path / "out" / "sim")
    with pytest.raises(SystemExit):
        RB.main(["--checkpoint", str(ckpt), "--out", str(tmp_path / "o2"), "--cpu"])
