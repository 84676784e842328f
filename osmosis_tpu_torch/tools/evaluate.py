"""PSNR and SSIM of restored images against ground truth, and the error of
the recovered water parameters (the port of the JAX package's
``tools/evaluate.py``).

    python -m osmosis_tpu_torch.tools.evaluate --results <run_dir>/single_images/rgb \\
        --gt <gt_rgb dir> [--resize-gt 256] [--manifest <simulation manifest.json> [--run DIR]]

Prints one JSON line: the mean PSNR and SSIM over the natural-sorted pairing
of result and GT files and, with ``--manifest``, the mean absolute error of
each image's final phi (``progress.json`` of the run) against the true phi
that ``simulate_degraded`` wrote. numpy, PIL and
``scipy.ndimage.gaussian_filter`` on the host: no device work, so the tool
takes no device flags.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from PIL import Image

from ..data.datasets import natsorted
from ..data.transforms import preprocess_image


def load01(path, size=None):
    """An image file as float32 [H, W, 3] in [0, 1]; with ``size`` through
    the pipeline's resize and center crop."""
    img = Image.open(path).convert("RGB")
    if size is not None:
        return 0.5 * (preprocess_image(img, size) + 1.0)
    return np.asarray(img, dtype=np.float32) / 255.0


def psnr(a, b):
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(1.0 / mse))


def _ssim_single(x, y, data_range=1.0, sigma=1.5, use_sample_covariance=True):
    """scikit-image ``structural_similarity(gaussian_weights=True,
    sigma=1.5)`` on ONE channel: an 11x11 gaussian window (truncate 3.5,
    radius 5), 'reflect' boundary, a border crop of (win - 1) // 2 and the
    sample-covariance normalization NP / (NP - 1) by default;
    ``use_sample_covariance=False`` is the Wang et al. ``ssim_index.m``
    variant."""
    from scipy.ndimage import gaussian_filter

    truncate = 3.5
    r = int(truncate * sigma + 0.5)
    win = 2 * r + 1  # 11
    x = x.astype(np.float64)
    y = y.astype(np.float64)

    def filt(z):
        return gaussian_filter(z, sigma, truncate=truncate, mode="reflect")

    n_px = win * win
    cov_norm = n_px / (n_px - 1.0) if use_sample_covariance else 1.0

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    pad = (win - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def ssim(a, b, data_range=1.0, use_sample_covariance=True):
    """Mean over channels (skimage ``channel_axis=-1``) of the gaussian-window
    SSIM. Inputs [H, W, 3] (or [H, W]) in [0, data_range]."""
    if a.ndim == 2:
        return _ssim_single(a, b, data_range, use_sample_covariance=use_sample_covariance)
    return float(np.mean([
        _ssim_single(a[..., c], b[..., c], data_range,
                     use_sample_covariance=use_sample_covariance)
        for c in range(a.shape[-1])
    ]))


def evaluate_dirs(results_dir: str, gt_dir: str, resize_gt: int = 256) -> dict:
    """Mean PSNR/SSIM of natsorted result images against natsorted GT; with
    ``resize_gt`` the GT goes through the pipeline's resize and crop to the
    result's size."""
    res_files = natsorted(os.listdir(results_dir))
    gt_files = natsorted(os.listdir(gt_dir))
    if len(res_files) > len(gt_files):
        raise ValueError(f"more results ({len(res_files)}) than GT images ({len(gt_files)})")

    psnrs, ssims = [], []
    for rf, gf in zip(res_files, gt_files):
        a = load01(os.path.join(results_dir, rf))
        size = a.shape[0] if resize_gt else None
        b = load01(os.path.join(gt_dir, gf), size=size)
        psnrs.append(psnr(a, b))
        ssims.append(ssim(a, b))
    return {"n": len(psnrs), "psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}


def phi_error(manifest_path: str, run_dir: str) -> dict:
    """Recovered-phi error: the simulation manifest's true per-image phi
    against the final phi that the pipeline logged as per-channel values in
    the run dir's ``progress.json``; with global_N > 1 the last record of an
    image (the scored chain) counts. A parameter whose channels do not all
    appear (another operator's manifest) is listed under ``phi_unmatched``."""
    with open(manifest_path) as f:
        manifest = json.load(f)
    last = {}
    with open(os.path.join(run_dir, "progress.json")) as f:
        for line in f:
            rec = json.loads(line)
            if "image" in rec:
                last[os.path.splitext(rec["image"])[0]] = rec

    per_name = {}
    n_img = 0
    unmatched = set()
    for stem, truth in manifest["images"].items():
        rec = last.get(stem)
        if rec is None:
            continue
        matched_any = False
        for pname, tvals in truth.items():
            rvals = [rec[f"{pname}_{ci}"] for ci in range(len(tvals)) if f"{pname}_{ci}" in rec]
            if len(rvals) == len(tvals):
                matched_any = True
                per_name.setdefault(pname, []).append(float(np.mean(np.abs(
                    np.asarray(rvals, np.float64) - np.asarray(tvals, np.float64)))))
            else:
                unmatched.add(pname)
        n_img += matched_any
    out = {"n_phi_images": int(n_img)}
    all_errs = [e for v in per_name.values() for e in v]
    if all_errs:
        out["phi_mae"] = round(float(np.mean(all_errs)), 4)
        for pname, errs in sorted(per_name.items()):
            out[f"{pname}_mae"] = round(float(np.mean(errs)), 4)
    if unmatched:
        out["phi_unmatched"] = sorted(unmatched)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--resize-gt", type=int, default=256,
                    help="preprocess GT through the same resize/crop (0 = off)")
    ap.add_argument("--manifest", default=None,
                    help="simulate_degraded's manifest.json: adds the recovered-phi error "
                         "against the true parameters")
    ap.add_argument("--run", default=None,
                    help="run directory containing progress.json "
                         "(default: two levels up from --results)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = evaluate_dirs(args.results, args.gt, args.resize_gt)
    report = {"n": out["n"], "psnr_mean": round(out["psnr"], 3),
              "ssim_mean": round(out["ssim"], 4)}
    if args.manifest:
        run_dir = args.run or os.path.dirname(os.path.dirname(os.path.abspath(args.results)))
        report.update(phi_error(args.manifest, run_dir))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
