"""Smoke tests of the port's quality tools ``validate_toy_e2e`` and
``demo_toy_restore`` on the CPU (after tests/test_validate_toy_e2e.py): a
tiny toy-arch checkpoint written by the JAX package's
``save_params_msgpack`` (random weights), 10 respaced steps or fewer. The
whole protocol runs (scenes, the degradation with known phi, guided
restoration, the metrics JSON); random weights restore nothing, so the
validator reports ``pass: false``, exits 1 and points at the port's
``check_prior_stats``."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from osmosis_tpu_torch.tools import demo_toy_restore as D
from osmosis_tpu_torch.tools import validate_toy_e2e as V


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    from osmosis_tpu.models import UNetModel
    from osmosis_tpu.models.convert import save_params_msgpack
    from tools.train_toy_prior import toy_unet_config

    params = jax.jit(UNetModel(toy_unet_config(32, 32, "toy")).init)(
        jax.random.key(0), jax.numpy.zeros((1, 32, 32, 4)), jax.numpy.zeros((1,)))
    path = str(tmp_path_factory.mktemp("ckpt") / "rand.msgpack")
    save_params_msgpack(jax.device_get(params), path)
    return path


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_validator_smoke(jax_checkpoint, capsys):
    rc = V.main(["--checkpoint", jax_checkpoint, "--size", "32", "--channels", "32",
                 "--arch", "toy", "--scenes", "1", "--respacing", "10", "--n-iter", "2",
                 "--cpu"])
    out = capsys.readouterr()
    report = _last_json(out.out)
    row = report["scenes"][0]
    assert row["scene"] == 0 and np.isfinite(row["psnr_degraded"])
    assert "psnr_gain_db" in report and "depth_corr_mean" in report
    assert report["pass"] is False and rc == 1
    assert "python -m osmosis_tpu_torch.tools.check_prior_stats" in out.err
    assert f"--checkpoint {jax_checkpoint}" in out.err and "--cpu" in out.err


def test_validator_restarts_scene_choice_and_strip(jax_checkpoint, tmp_path, capsys):
    png = str(tmp_path / "strip.png")
    V.main(["--checkpoint", jax_checkpoint, "--size", "32", "--channels", "32",
            "--scenes", "2", "--only-scene", "1", "--respacing", "6", "--n-iter", "2",
            "--best-of", "2", "--phi-jitter", "0.05", "--sample-seed", "3", "--row-name", "r1",
            "--x-prev-every", "2", "--save-png", png, "--cpu"])
    out = capsys.readouterr()
    report = _last_json(out.out)
    assert report["row"] == "r1" and report["seed"] == 3
    assert [r["scene"] for r in report["scenes"]] == [1]
    assert "scene 1: try 1 final loss" in out.err and "best-of-2 kept try" in out.err
    assert os.path.getsize(png) > 0


def test_validator_refuses_to_fall_back_to_the_cpu(jax_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.main(["--checkpoint", jax_checkpoint, "--size", "32", "--channels", "32"])


@pytest.mark.parametrize("operator", ["underwater_physical_revised", "rgb_guidance"])
def test_demo_smoke(jax_checkpoint, tmp_path, capsys, operator):
    report = D.main(["--checkpoint", jax_checkpoint, "--size", "32", "--channels", "32",
                     "--scenes", "2", "--respacing", "5", "--operator", operator,
                     "--workdir", str(tmp_path / "demo"), "--cpu"])
    out = capsys.readouterr()
    assert "Randomly initialize" not in out.out  # the run loaded the JAX checkpoint
    assert _last_json(out.out) == report
    assert report["operator"] == operator and report["depth_corr_positive"].endswith("/2")
    assert np.isfinite(report["psnr_restored"]) and 0 < report["ssim_restored"] <= 1
    assert ("psnr_gain_db" in report) == (operator != "rgb_guidance")
    rgb = os.path.join(report["run_dir"], "single_images", "rgb")
    assert sorted(os.listdir(rgb)) == ["scene_0.png", "scene_1.png"]
