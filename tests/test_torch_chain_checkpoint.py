"""The port's chain journal and ``progress_segments``/``chain_checkpoint``
through ``run_restoration`` on the CPU (after tests/test_chain_checkpoint.py).

The claim is bitwise: chain noise is keyed on (seed, t, i), so a chain cut
into segments, or killed after a boundary (the
OSMOSIS_TPU_CRASH_AFTER_SEGMENTS hook) and resumed, writes the PNGs of the
uninterrupted run byte for byte, on the serial path and on the fleet path.
"""

import os
import pickle
from os.path import join as pjoin

import numpy as np
import pytest
import torch

from osmosis_tpu_torch.diffusion.guided import GuidedResult
from osmosis_tpu_torch.pipelines import restore as R
from osmosis_tpu_torch.pipelines.restore import run_restoration
from osmosis_tpu_torch.utils.chainjournal import ChainJournal
from tests.test_torch_pipeline import _config, images, one_torch_thread  # noqa: F401

STEPS = 8
SEGMENTS = 4  # segments of 2 steps: 3 boundaries a chain


def test_journal_roundtrip(tmp_path):
    j = ChainJournal(str(tmp_path), "img_0", "fp-abc")
    res = {"sample": np.arange(6.0).reshape(2, 3), "phi": {"a": torch.ones(3)}}
    j.save_chain(0, 0, res)
    j.save_chain(1, 0, {"sample": np.zeros(2)})
    loaded = j.load_chains()
    assert set(loaded) == {(0, 0), (1, 0)}
    np.testing.assert_array_equal(loaded[(0, 0)]["sample"], res["sample"])
    assert loaded[(0, 0)]["sample"].flags.writeable  # resumed state must be writable
    loaded[(0, 0)]["phi"]["a"][0] = 7.0
    state = {"done": 10, "x": torch.ones((1, 4)), "traces": {}}
    j.save_partial((1, 0), state)
    assert j.load_partial((1, 0))["done"] == 10
    assert j.load_partial((0, 1)) is None  # another chain's tag
    j.clear_partial()
    assert j.load_partial((1, 0)) is None
    j.save_partial((0, 0), state)
    j.clear()
    assert not os.path.exists(j.dir)


def test_journal_roundtrip_guided_result_with_bf16_tensors(tmp_path):
    gen = torch.Generator().manual_seed(0)
    res = GuidedResult(
        sample=torch.randn((1, 4, 4, 4), generator=gen),
        pred_xstart=torch.randn((1, 4, 4, 4), generator=gen).to(torch.bfloat16),
        phi={"phi_a": torch.full((1, 3), 1.1)},
        sep_loss=torch.arange(6, dtype=torch.float32).reshape(3, 2),
        phi_trace={"phi_a": torch.zeros((3, 1, 3))},
        aux_trace={"val_loss": torch.tensor([0.5, 0.25, 0.0])},
        x0_std_trace=torch.ones((3, 1)),
        opt_state={"m": {"phi_a": torch.zeros((1, 3))}, "count": 3},
        x0_snapshots=None,
        eps_hist=(torch.ones((1, 2)), torch.zeros((1, 2), dtype=torch.bfloat16)),
        snapshot_steps=(29, 19, 9),
    )
    j = ChainJournal(str(tmp_path), "img_0", "fp")
    j.save_chain(2, 1, res)
    got = j.load_chains()[(2, 1)]
    assert isinstance(got, GuidedResult)
    assert got.pred_xstart.dtype == torch.bfloat16
    assert torch.equal(got.pred_xstart.view(torch.int16), res.pred_xstart.view(torch.int16))
    assert torch.equal(got.sample, res.sample) and torch.equal(got.sep_loss, res.sep_loss)
    assert torch.equal(got.aux_trace["val_loss"], res.aux_trace["val_loss"])
    assert got.opt_state["count"] == 3 and torch.equal(got.phi["phi_a"], res.phi["phi_a"])
    assert got.x0_snapshots is None and isinstance(got.eps_hist, tuple)
    assert got.eps_hist[1].dtype == torch.bfloat16
    assert got.snapshot_steps == (29, 19, 9)
    with np.load(pjoin(j.dir, "chain_2_1.npz"), allow_pickle=False) as z:
        assert "__manifest__" in z


def test_journal_ignores_stale_and_corrupt_state(tmp_path):
    j = ChainJournal(str(tmp_path), "img_0", "fp-old")
    j.save_chain(0, 0, {"v": torch.ones(2)})
    j.save_partial((0, 0), {"done": 5})
    j2 = ChainJournal(str(tmp_path), "img_0", "fp-new")  # a changed config
    assert j2.load_chains() == {} and j2.load_partial((0, 0)) is None
    with open(pjoin(j.dir, "chain_0_0.npz"), "wb") as f:
        f.write(b"not an npz archive")
    assert j2.load_chains() == {}
    with open(pjoin(j.dir, "chain_1_0.npz"), "wb") as f:  # never unpickled
        pickle.dump({"version": 1, "fp": "fp-new", "payload": {}}, f)
    assert j2.load_chains() == {}


def _cfg(tmp_path, images, tag, fleet, **over):  # noqa: F811
    diffusion = dict(sampler="ddpm", steps=1000, noise_schedule="linear",
                     model_mean_type="epsilon", model_var_type="learned_range",
                     dynamic_threshold=False, clip_denoised=True, min_max_denoised=False,
                     rescale_timesteps=False, timestep_respacing=STEPS)
    data = dict(batch_size=2 if fleet else 1, name="tiny", root=images, stop_after=-1,
                ground_truth=False)
    path = _config(tmp_path, images, diffusion=diffusion, data=data, record_every=2,
                   save_dir=str(tmp_path / f"results_{tag}"), **over)
    os.replace(path, str(tmp_path / f"{tag}.yaml"))
    return str(tmp_path / f"{tag}.yaml")


def _pngs(out):
    files = {}
    for d, _, fs in os.walk(out):
        for f in fs:
            if f.endswith(".png"):
                with open(pjoin(d, f), "rb") as fh:
                    files[os.path.relpath(pjoin(d, f), out)] = fh.read()
    return files


@pytest.mark.parametrize("fleet", [False, True], ids=["serial", "fleet"])
def test_segmented_run_equals_one_call_bitwise(tmp_path, images, fleet):  # noqa: F811
    out_a = run_restoration(_cfg(tmp_path, images, "a", fleet), device="cpu")
    out_b = run_restoration(_cfg(tmp_path, images, "b", fleet, progress_segments=SEGMENTS),
                            device="cpu")
    a, b = _pngs(out_a), _pngs(out_b)
    assert len(a) == (2 * 4 + 2 * 2 + 2) and a == b  # 2 images: singles, 2 grids, process
    log = open(pjoin(out_b, "log.txt")).read()
    # a row at each of the 4 segment ends, for each of the 2 global chains
    n_chains = 2 if fleet else 4
    assert log.count("  progress ") == SEGMENTS * n_chains
    assert "phase timings:" in log and "sample" in log.split("phase timings:")[1]


@pytest.mark.parametrize("fleet,crash_after", [(False, 1), (False, 5), (True, 1), (True, 4)],
                         ids=["serial-first-chain", "serial-second-chain", "fleet-first-chain",
                              "fleet-second-chain"])
def test_crash_then_resume_bitwise(tmp_path, images, fleet, crash_after):  # noqa: F811
    over = dict(progress_segments=SEGMENTS, chain_checkpoint=True)
    out_a = run_restoration(_cfg(tmp_path, images, "a", fleet, **over), device="cpu")
    assert not os.path.exists(pjoin(out_a, ".chain_state"))

    path_b = _cfg(tmp_path, images, "b", fleet, **over)
    os.environ["OSMOSIS_TPU_CRASH_AFTER_SEGMENTS"] = str(R._CRASH_SAVES["n"] + crash_after)
    try:
        with pytest.raises(RuntimeError, match="injected crash"):
            run_restoration(path_b, device="cpu")
    finally:
        del os.environ["OSMOSIS_TPU_CRASH_AFTER_SEGMENTS"]
    states = [d for d, _, _ in os.walk(str(tmp_path / "results_b")) if d.endswith(".chain_state")]
    assert states, "no chain state persisted before the crash"

    out_b = run_restoration(_cfg(tmp_path, images, "b", fleet, resume=True, **over),
                            device="cpu")
    log = open(pjoin(out_b, "log.txt")).read()
    assert "resuming chain at step 2/8" in log or "resuming chain at step 4/8" in log
    if crash_after > 3:  # the crash came in the second global chain: the first replays
        assert "replayed from the chain checkpoint" in log
    assert not os.path.exists(pjoin(out_b, ".chain_state"))
    assert _pngs(out_a) == _pngs(out_b)
