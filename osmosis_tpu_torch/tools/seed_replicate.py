"""Seed-replicate the decision-bearing cells of the 3a-ii quality grid (port of
the JAX package's ``tools/seed_replicate.py``).

    python -m osmosis_tpu_torch.tools.seed_replicate [--seeds 1 2] [--cells r256_s50_x0 ...] \\
        [-d 0 | --cpu]

Every operating-point claim of the grid (the x0 > hybrid > full-grad mode
ranking, the 25-step knee, the x0-turbo preset's gain) rested on one
sampling draw per cell. This tool re-runs the decision cells with other
sampling seeds: the same held-out scenes and degradations
(``validate_toy_e2e --sample-seed`` re-roots only the chain randomness),
other chain noise. Then it:
  * appends the new rows (with a ``seed`` field) to the port's grid,
    ``docs/data/grid_3a_ii_torch.jsonl`` (rows without a seed field are draw
    0);
  * writes ``docs/data/seed_replication_3a_ii_torch.json``: per cell the mean
    and standard deviation of psnr_gain_db and depth_corr_mean over all
    draws, and the mode-ranking and 25-step-knee checks.
The JAX tool's files are never written. Cells and flags are the grid's
recipes verbatim; each cell's prior (``checkpoints/toy_prior{128,256}_offn*``,
the JAX layout, which the port reads) must be in ``checkpoints/``. Resumable:
a cell already in the grid at a seed is skipped. ``--override`` appends flags
to every cell's command (``validate_toy_e2e``'s argparse takes the last of a
repeated flag), for a run on another prior or at another size.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
GRID = os.path.join(ROOT, "docs", "data", "grid_3a_ii_torch.jsonl")
SUMMARY = os.path.join(ROOT, "docs", "data", "seed_replication_3a_ii_torch.json")

C128 = ("--checkpoint checkpoints/toy_prior128_offn.msgpack --size 128 "
        "--channels 64 --arch production --scenes 6 --scale 8,8,8,4 "
        "--optimizer adam")
C256 = ("--checkpoint checkpoints/toy_prior256_offn.msgpack --size 256 "
        "--channels 64 --arch production --scenes 6 --scale 16,16,16,8 "
        "--optimizer adam")
C256_4K = ("--checkpoint checkpoints/toy_prior256_offn4k.msgpack --size 256 "
           "--channels 64 --arch production --scenes 6 --scale 16,16,16,8 "
           "--optimizer adam")

# the decision-bearing cells: x0@100/50 at both resolutions, hybrid k=4
# @50/25 on the converged 24k prior, and the full-grad turbo rung; flags
# verbatim from the grid's recipes (a later --scale overrides the base C*
# one: argparse takes the last)
CELLS = {
    "r128_s100_x0": f"{C128} --x0-grad --scale 4,4,4,2 --phi-eta 5e-4 "
                    "--respacing 100",
    "r128_s50_x0": f"{C128} --x0-grad --scale 4,4,4,2 --phi-eta 5e-4 "
                   "--respacing 50",
    "r256_s100_x0": f"{C256} --x0-grad --scale 8,8,8,4 --phi-eta 2.5e-4 "
                    "--respacing 100",
    "r256_s50_x0": f"{C256} --x0-grad --scale 8,8,8,4 --phi-eta 2.5e-4 "
                   "--respacing 50",
    "r256_s50_hyb4": f"{C256} --phi-eta 2.5e-4 --respacing 50 "
                     "--x-prev-every 4",
    "r256_s25_hyb4": f"{C256} --phi-eta 2.5e-4 --respacing 25 "
                     "--x-prev-every 4",
    "r128_s100_eta5e-4": f"{C128} --phi-eta 5e-4 --respacing 100",
    # the two knee comparators behind the hybrid-turbo preset: the x0
    # depth-gate failure at 25 steps and the full-grad collapse
    "r256_s25_x0": f"{C256} --x0-grad --scale 8,8,8,4 --phi-eta 2.5e-4 "
                   "--respacing 25",
    "r256_s25_ddpm": f"{C256} --respacing 25 --phi-eta 2.5e-4",
    # the 128px side of the knee asymmetry ("128px still passes at 25 steps")
    "r128_s25_x0": f"{C128} --x0-grad --scale 4,4,4,2 --phi-eta 5e-4 "
                   "--respacing 25",
    "r128_s25_eta5e-4": f"{C128} --phi-eta 5e-4 --respacing 25",
    # the eta-bracketing evidence on the 4k checkpoint-strength prior
    "r256k4_s100_eta1e-4": f"{C256_4K} --respacing 100 --phi-eta 1e-4",
    "r256k4_s100_eta2e-4": f"{C256_4K} --respacing 100 --phi-eta 2e-4",
    "r256k4_s50_eta1e-4": f"{C256_4K} --respacing 50 --phi-eta 1e-4",
    "r256k4_s50_eta4e-4": f"{C256_4K} --respacing 50 --phi-eta 4e-4",
    # the 200-step baselines the turbo preset's "100 steps holds quality"
    # claim compares against
    "r128_s200_eta5e-4": f"{C128} --phi-eta 5e-4 --respacing 200",
    "r256k4_s200_eta1e-4": f"{C256_4K} --respacing 200 --phi-eta 1e-4",
    # the full-grad comparator inside the mode-ranking check
    "r256_s50_eta2.5e-4": f"{C256} --respacing 50 --phi-eta 2.5e-4",
}


def load_grid(path=GRID):
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    return rows


def have(rows, cell, seed):
    return any(r.get("row") == cell and r.get("seed") == seed for r in rows)


def cell_command(cell, seed, device_flags=(), override=()):
    """The ``validate_toy_e2e`` command of one cell at one sampling seed."""
    return ([sys.executable, "-m", "osmosis_tpu_torch.tools.validate_toy_e2e"]
            + CELLS[cell].split() + list(override)
            + ["--sample-seed", str(seed), "--row-name", cell] + list(device_flags))


def run_cell(cell, seed, device_flags=(), override=()):
    """One cell at one seed through ``validate_toy_e2e``, from the repo's root;
    its JSON row, or None where it timed out, crashed or printed none."""
    cmd = cell_command(cell, seed, device_flags, override)
    t0 = time.time()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=3600)
    except subprocess.TimeoutExpired:
        # skip the cell and keep the sweep alive, like any per-cell failure
        print(f"[seed_replicate] {cell} seed {seed} TIMED OUT after "
              f"{(time.time() - t0) / 60:.0f} min", file=sys.stderr)
        return None
    dt = time.time() - t0
    # rc 1 = the tool's own pass gate failed (possible at the knee cells);
    # the row is still the measurement we came for
    if p.returncode not in (0, 1):
        print(f"[seed_replicate] {cell} seed {seed} CRASHED rc="
              f"{p.returncode}\n{p.stderr[-2000:]}", file=sys.stderr)
        return None
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    if not line:
        print(f"[seed_replicate] {cell} seed {seed}: no JSON on stdout\n"
              f"{p.stderr[-2000:]}", file=sys.stderr)
        return None
    row = json.loads(line[-1])
    print(f"[seed_replicate] {cell} seed {seed}: gain "
          f"{row['psnr_gain_db']} dB corr {row['depth_corr_mean']} "
          f"({dt / 60:.1f} min)", file=sys.stderr)
    return row


def summarize(rows):
    import numpy as np

    cells = {}
    for cell in CELLS:
        draws = [r for r in rows if r.get("row") == cell]
        if not draws:
            continue
        gains = [r["psnr_gain_db"] for r in draws]
        corrs = [r["depth_corr_mean"] for r in draws]
        cells[cell] = {
            "n_draws": len(draws),
            "seeds": [r.get("seed", 0) for r in draws],
            "gain_db": gains,
            "gain_mean": round(float(np.mean(gains)), 2),
            "gain_std": round(float(np.std(gains, ddof=1)), 2)
            if len(gains) > 1 else None,
            "depth_corr": corrs,
            "corr_mean": round(float(np.mean(corrs)), 3),
            "corr_std": round(float(np.std(corrs, ddof=1)), 3)
            if len(corrs) > 1 else None,
        }

    checks = {}
    # the mode ranking at 256px/50 steps on the 24k prior: x0 > hybrid k=4 >
    # full-grad; the full-grad comparator is the r256_s50_eta2.5e-4 row
    if "r256_s50_x0" in cells and "r256_s50_hyb4" in cells:
        x0, hyb = cells["r256_s50_x0"], cells["r256_s50_hyb4"]
        fullc = cells.get("r256_s50_eta2.5e-4")
        full = [r for r in rows if r.get("row") == "r256_s50_eta2.5e-4"]
        full_gain = (fullc["gain_mean"] if fullc else
                     full[0]["psnr_gain_db"] if full else None)
        checks["mode_ranking_256px_50steps"] = {
            "x0_gain": f"{x0['gain_mean']}±{x0['gain_std']}",
            "hyb4_gain": f"{hyb['gain_mean']}±{hyb['gain_std']}",
            "full_grad_gain": (f"{fullc['gain_mean']}±{fullc['gain_std']}"
                               if fullc else full_gain),
            "x0_beats_hyb4_by_db": round(x0["gain_mean"] - hyb["gain_mean"], 2),
            "survives": bool(
                x0["gain_mean"] - (x0["gain_std"] or 0)
                > hyb["gain_mean"] + (hyb["gain_std"] or 0)
                and (full_gain is None or hyb["gain_mean"] > full_gain)
            ),
        }
    # the 25-step knee: does hyb4@25's gain stay clearly above the full-grad
    # collapse, and is the x0 depth-gate failure a property of the mode, not
    # of one draw (each row carries its own pass verdict)?
    if "r256_s25_hyb4" in cells:
        hyb25 = cells["r256_s25_hyb4"]
        ddpm25 = cells.get("r256_s25_ddpm")
        full_gain = (ddpm25["gain_mean"] if ddpm25 else
                     next((r["psnr_gain_db"] for r in rows
                           if r.get("row") == "r256_s25_ddpm"), 1.42))
        x0_25 = [r for r in rows if r.get("row") == "r256_s25_x0"]
        entry = {
            "hyb4_25_gain": f"{hyb25['gain_mean']}±{hyb25['gain_std']}",
            "full_grad_25": (f"{ddpm25['gain_mean']}±{ddpm25['gain_std']}"
                             if ddpm25 else full_gain),
            "survives": bool(hyb25["gain_mean"] - 2 * (hyb25["gain_std"] or 0)
                             > full_gain),
        }
        if x0_25:
            entry["x0_25_depth_gate_failures"] = (
                f"{sum(1 for r in x0_25 if not r.get('pass', True))}"
                f"/{len(x0_25)} draws")
            entry["x0_25_depth_corr_per_draw"] = [
                r["depth_corr_mean"] for r in x0_25]
        checks["knee_25steps_hyb4_above_collapse"] = entry
    # x0 step-count invariance at the turbo point: x0@50 against x0@100
    if "r256_s100_x0" in cells and "r256_s50_x0" in cells:
        a, b = cells["r256_s100_x0"], cells["r256_s50_x0"]
        diff = round(b["gain_mean"] - a["gain_mean"], 2)
        spread = max(a["gain_std"] or 0, b["gain_std"] or 0)
        checks["x0_100_vs_50_256px"] = {
            "gain_100": f"{a['gain_mean']}±{a['gain_std']}",
            "gain_50": f"{b['gain_mean']}±{b['gain_std']}",
            "diff_db": diff,
            "within_noise": bool(abs(diff) <= 2 * spread),
        }
    return {"cells": cells, "checks": checks,
            "protocol": "6 fixed scenes per draw; --sample-seed varies "
                        "chain noise only; draw 0 = the round-4 grid row "
                        "(no seed field)"}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2],
                    help="sample-seed values (>=1). 0 is RESERVED for the "
                         "original grid draw (rows without a seed field)")
    ap.add_argument("--cells", nargs="+", default=list(CELLS), choices=list(CELLS))
    ap.add_argument("--summarize-only", action="store_true")
    ap.add_argument("--grid", default=GRID, help="the grid's jsonl (rows are appended)")
    ap.add_argument("--summary", default=SUMMARY, help="where the summary JSON goes")
    ap.add_argument("--override", default="",
                    help="flags appended to every cell's validate_toy_e2e command")
    ap.add_argument("-d", "--device", type=int, default=0, help="CUDA device index")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if any(s < 1 for s in args.seeds):
        ap.error("--seeds must be >= 1 (draw 0 IS the original grid row)")
    device_flags = ["--cpu"] if args.cpu else ["-d", str(args.device)]

    rows = load_grid(args.grid)
    if not args.summarize_only:
        for cell in args.cells:
            for seed in args.seeds:
                if have(rows, cell, seed):
                    print(f"[seed_replicate] {cell} seed {seed}: already "
                          "in grid, skipping", file=sys.stderr)
                    continue
                row = run_cell(cell, seed, device_flags, args.override.split())
                if row is None:
                    continue
                rows.append(row)
                os.makedirs(os.path.dirname(os.path.abspath(args.grid)), exist_ok=True)
                with open(args.grid, "a") as f:
                    f.write(json.dumps(row) + "\n")
    summary = summarize(rows)
    os.makedirs(os.path.dirname(os.path.abspath(args.summary)), exist_ok=True)
    with open(args.summary, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary["checks"], indent=1))
    print(f"[seed_replicate] summary -> {args.summary}", file=sys.stderr)
    return summary


if __name__ == "__main__":
    main()
