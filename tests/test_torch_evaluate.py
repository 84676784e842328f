"""The port's ``tools/evaluate`` against the JAX package's ``tools/evaluate.py``
on the same seeded arrays, image directories, simulation manifest and run
``progress.json``: PSNR, SSIM (both covariance conventions), the directory
means and the recovered-phi error agree to 1e-12."""

import importlib.util
import json
import os

import numpy as np
import pytest
from PIL import Image

from osmosis_tpu_torch.tools import evaluate as E

_spec = importlib.util.spec_from_file_location(
    "jax_evaluate", os.path.join(os.path.dirname(__file__), "..", "tools", "evaluate.py"))
J = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(J)


@pytest.mark.parametrize("shape", [(48, 48), (40, 44, 3)])
def test_psnr_and_ssim_equal_the_jax_tools(shape):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    assert E.psnr(x, y) == pytest.approx(J.psnr(x, y), abs=1e-12)
    assert E.psnr(x, x) == J.psnr(x, x) == float("inf")
    for cov in (True, False):
        assert E.ssim(x, y, use_sample_covariance=cov) == pytest.approx(
            J.ssim(x, y, use_sample_covariance=cov), abs=1e-12)


def _write_dir(d, rng, n, shape):
    os.makedirs(d)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, shape, dtype=np.uint8)).save(
            os.path.join(d, f"img_{i + 1}.png"))


def test_evaluate_dirs_and_phi_error_equal_the_jax_tools(tmp_path):
    rng = np.random.default_rng(1)
    res, gt = str(tmp_path / "res"), str(tmp_path / "gt")
    _write_dir(res, rng, 3, (32, 32, 3))
    _write_dir(gt, rng, 3, (40, 52, 3))  # resized and cropped to 32 by resize_gt
    for resize in (32, 0):
        if resize == 0:
            gt = str(tmp_path / "gt_same")
            _write_dir(gt, rng, 3, (32, 32, 3))
        got, want = E.evaluate_dirs(res, gt, resize), J.evaluate_dirs(res, gt, resize)
        assert got["n"] == want["n"] == 3
        for k in ("psnr", "ssim"):
            assert got[k] == pytest.approx(want[k], abs=1e-12)

    manifest = {"images": {f"img_{i}": {"phi_a": list(rng.uniform(0.3, 0.7, 3)),
                                        "phi_inf": list(rng.uniform(0.1, 0.5, 3)),
                                        "phi_ab": [0.8]}
                           for i in range(3)}}
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump(manifest, f)
    run = tmp_path / "run"
    run.mkdir()
    with open(run / "progress.json", "w") as f:
        for g in range(2):  # global_N 2: the last record of an image counts
            for i in range(2):  # img_2 never ran
                rec = {"image": f"img_{i}.png", "global_iter": g}
                for p in ("phi_a", "phi_inf"):
                    rec.update({f"{p}_{c}": float(rng.uniform(0.1, 0.9)) for c in range(3)})
                f.write(json.dumps(rec) + "\n")
            f.write(json.dumps({"other": 1}) + "\n")
    got = E.phi_error(str(tmp_path / "manifest.json"), str(run))
    assert got == J.phi_error(str(tmp_path / "manifest.json"), str(run))
    assert got["n_phi_images"] == 2 and got["phi_unmatched"] == ["phi_ab"]


def test_more_results_than_gt_is_refused(tmp_path):
    rng = np.random.default_rng(2)
    _write_dir(str(tmp_path / "res"), rng, 2, (8, 8, 3))
    _write_dir(str(tmp_path / "gt"), rng, 1, (8, 8, 3))
    with pytest.raises(ValueError, match="more results"):
        E.evaluate_dirs(str(tmp_path / "res"), str(tmp_path / "gt"))


def test_cli_prints_the_rounded_means(tmp_path, capsys):
    rng = np.random.default_rng(3)
    res, gt = str(tmp_path / "res"), str(tmp_path / "gt")
    _write_dir(res, rng, 2, (16, 16, 3))
    _write_dir(gt, rng, 2, (16, 16, 3))
    E.main(["--results", res, "--gt", gt, "--resize-gt", "0"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = J.evaluate_dirs(res, gt, 0)
    assert report == {"n": 2, "psnr_mean": round(want["psnr"], 3),
                      "ssim_mean": round(want["ssim"], 4)}
