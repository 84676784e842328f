"""The port's ``utils/profiling`` and ``perf`` against the JAX package's on
the CPU: ``phase`` and ``TIMERS`` summarise in JAX's format,
``enable_nan_debugging`` turns on autograd's NaN check, and the
``OSMOSIS_TPU_*`` environment overrides act on a run's knobs as JAX's
``effective()`` reads them: an ``OSMOSIS_TPU_ASYNC_SAVE=1`` run saves on the
worker thread, and ``snapshot_text`` writes the values after the overrides."""

import dataclasses
import threading
import time
from os.path import join as pjoin

import pytest
import torch

from osmosis_tpu import perf as JPF
from osmosis_tpu.utils import profiling as JPR
from osmosis_tpu_torch import perf as PF
from osmosis_tpu_torch.pipelines import restore as R
from osmosis_tpu_torch.utils import profiling as PR
from tests.test_torch_pipeline import _config, images, one_torch_thread  # noqa: F401


def test_phase_and_timers_summarise_as_jax_does():
    assert PR.phase.__self__ is PR.TIMERS
    totals = {"sample": 12.5, "postprocess+save": 0.731, "a_phase_with_a_long_name_x": 3.0}
    counts = {"sample": 4, "postprocess+save": 4, "a_phase_with_a_long_name_x": 1}
    port, jax = PR.PhaseTimers(), JPR.PhaseTimers()
    for t in (port, jax):
        t.totals.update(totals)
        t.counts.update(counts)
    assert port.summary() == jax.summary()
    before = PR.TIMERS.counts["test_phase"]
    with PR.phase("test_phase"):
        time.sleep(0.01)
    assert PR.TIMERS.counts["test_phase"] == before + 1 and PR.TIMERS.totals["test_phase"] >= 0.01
    assert "  test_phase " in PR.TIMERS.summary()


def test_enable_nan_debugging_checks_the_backward():
    before = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    try:
        PR.enable_nan_debugging()
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x = torch.tensor([-1.0, 4.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(*before)


ENVS = {
    "none": {},
    "bools_ints_strings": {"OSMOSIS_TPU_ASYNC_SAVE": "1", "OSMOSIS_TPU_STRIP_CONV": "0",
                           "OSMOSIS_TPU_STRIP_COUNT": "8", "OSMOSIS_TPU_STRIP_BWD": "raw",
                           "OSMOSIS_TPU_FUSED_NORM_SILU": "false",
                           "OSMOSIS_TPU_PALLAS_UPSAMPLE": "yes"},
    "flat_alias": {"OSMOSIS_TPU_STRIP_BWD_FLAT": "1", "OSMOSIS_TPU_STRIP_BWD": "raw",
                   "OSMOSIS_TPU_SCAN_UNROLL": ""},
}


@pytest.mark.parametrize("env", sorted(ENVS))
def test_snapshot_holds_jaxs_effective_values(env, monkeypatch):
    for var in list(PF.ENV.values()) + [PF.BWD_FLAT_ENV]:
        monkeypatch.delenv(var, raising=False)
    for var, value in ENVS[env].items():
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(JPF, "_CONFIG", JPF.PerfConfig())
    assert PF.ENV == JPF._ENV and PF.BWD_FLAT_ENV == JPF._BWD_FLAT_ENV
    cfg = PF.configure_from_dict({"hybrid_scan_unroll": 3})
    JPF.configure_from_dict({"hybrid_scan_unroll": 3})
    want = JPF.effective()
    assert cfg.values == want
    text = PF.snapshot_text(cfg)
    got = dict(line.split("  #")[0][len("perf."):].split(": ", 1)
               for line in text.splitlines() if line.startswith("perf."))
    assert got == {k: str(v) for k, v in want.items()}
    assert "# perf knobs" in text


def test_async_save_from_the_environment_acts(tmp_path, images, monkeypatch):  # noqa: F811
    """OSMOSIS_TPU_ASYNC_SAVE=1 over a config without a perf section: the
    images are saved on the saver's worker thread, and configurations.txt
    says so; without it, on the caller's."""
    threads = []
    finish = R._finish_image
    monkeypatch.setattr(R, "_finish_image", lambda *a, **kw: (
        threads.append(threading.current_thread() is threading.main_thread()),
        finish(*a, **kw))[-1])
    diffusion = dict(sampler="ddim", steps=1000, noise_schedule="linear",
                     model_mean_type="epsilon", model_var_type="learned_range",
                     dynamic_threshold=False, clip_denoised=True, min_max_denoised=False,
                     rescale_timesteps=False, timestep_respacing="ddim2")
    for env, on_main in (("1", False), ("", True)):
        monkeypatch.setenv("OSMOSIS_TPU_ASYNC_SAVE", env)
        threads.clear()
        out = R.run_restoration(_config(tmp_path, images, diffusion=diffusion,
                                        save_dir=str(tmp_path / f"r{env}")), device="cpu")
        assert threads and all(t == on_main for t in threads), (env, threads)
        with open(pjoin(out, "configurations.txt")) as f:
            assert f"perf.async_save: {not on_main}\n" in f.read()
    assert dataclasses.is_dataclass(PF.PerfConfig)
