"""Day-one runbook for the real checkpoint (``osmosis_outdoor.pt``): the port of
the JAX package's ``tools/real_weights_runbook.py``.

    python -m osmosis_tpu_torch.tools.real_weights_runbook --checkpoint osmosis_outdoor.pt \\
        --gt-rgb <nyu_rgb_dir> --gt-depth <nyu_depth_dir> --stop-after 5 [-d 0 | --cpu]

One command from the weights to a scored report. Stages (each writes into
``<out>/``, default ``runbook_results/``):
  1. convert + parity: ``validate_checkpoint --skip-sample`` turns the ``.pt``
     into a ``.msgpack`` and holds the two forwards to the repo's UNet bar;
  2. simulate: ``simulate_degraded`` builds the paper-protocol simulation set
     (degraded input, GT RGB and depth, the true-phi manifest) at 256px from
     the clean RGBD folders (or from ``--synth N`` procedural scenes), and a
     haze set for the haze preset; skipped
     where ``--sim-dir`` already holds one (haze is then skipped without
     ``--sim-dir-haze``);
  3. the reference preset (1000 steps) through ``run_restoration``, scored by
     ``evaluate``: PSNR, SSIM and the recovered-phi MAE;
  4. the sign-off sweeps on the same images, each scored: fast (ddim200),
     turbo (ddim100), x0, x0_turbo (x0 at ddim100), hybrid (x_prev every 4th
     step), hybrid_turbo (ddim25), then the other reference surfaces: haze,
     rgb (rgb_guidance, 'ps') and the unconditional RGBD prior (N images that
     must be present, finite and not constant);
  5. health gates on every run: a phi stall (every learned phi channel within
     1% of its init while the loss stays high) retries the preset once with
     ``optimizer: adam`` and keeps the better score; the x0-hat amplitude
     (``x0_std``) must contract from its early maximum by mid-chain in every
     chain; a preset that fails is retried once, then recorded, and the sweep
     goes on.
Everything lands in ``<out>/RUNBOOK_REPORT.{md,json}``, with each stage's
wall time (``stage_seconds``; ``--rehearsal-json`` writes them with the
card's name and power limit too).

The stage subprocesses run ``python -m osmosis_tpu_torch.tools.<name>`` with
this run's device flags; the presets run in this process, on CUDA device
``-d`` (the default, which raises without a card) or on the CPU with
``--cpu``. Self-test, no weights needed:

    python -m osmosis_tpu_torch.tools.real_weights_runbook --tiny --cpu

builds a seeded random tiny checkpoint (``validate_checkpoint --tiny``),
synthesizes toy scenes and drives every stage. ``--smoke-steps K`` keeps the
real widths but cuts every chain to K respaced steps (ddim, clip_denoised
on; the prior: its last K steps, 2 images): a quick run of every stage at
production geometry.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import yaml

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
CONFIGS = os.path.join(ROOT, "configs")

# the run's device flags, passed to every stage subprocess that runs on one
DEVICE_FLAGS = []

# execution-ordered per-stage wall-clock records; they land in
# RUNBOOK_REPORT.json["stage_seconds"] and (with --rehearsal-json) in the
# rehearsal record: the day-one wall-clock budget
STAGE_SECONDS = []


def _record_stage(stage, seconds, **extra):
    STAGE_SECONDS.append({"stage": stage, "seconds": round(seconds, 1), **extra})


def tool_cmd(name, *args, device=True):
    """``python -m osmosis_tpu_torch.tools.<name> <args>``, with the run's
    device flags where the tool runs on a device."""
    return [sys.executable, "-m", f"osmosis_tpu_torch.tools.{name}", *map(str, args),
            *(DEVICE_FLAGS if device else [])]


def sh(cmd, log_path=None, check=True):
    """Run a stage as a subprocess (a fresh process per stage) from the repo's
    root, echoing its output and optionally writing it to a log file."""
    print(f"\n[runbook] $ {' '.join(cmd)}", flush=True)
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    _record_stage(
        os.path.splitext(os.path.basename(log_path))[0] if log_path
        else cmd[2].rsplit(".", 1)[-1] if len(cmd) > 2 else cmd[0],
        time.time() - t0,
    )
    print(proc.stdout)
    if log_path:
        with open(log_path, "w") as f:
            f.write(proc.stdout)
    if check and proc.returncode != 0:
        raise RuntimeError(f"stage failed (rc={proc.returncode}): {cmd}")
    return proc.stdout


# ---------------------------------------------------------------- presets

# every shipped reference config is a runbook row: the six sweep presets
# share the simulation base; haze/rgb/prior use their own reference config
PRESET_BASES = {
    "reference": "osmosis_simulation_sample_config.yaml",
    "fast": "osmosis_simulation_sample_config.yaml",
    "turbo": "osmosis_simulation_sample_config.yaml",
    "x0": "osmosis_simulation_sample_config.yaml",
    "x0_turbo": "osmosis_simulation_sample_config.yaml",
    "hybrid": "osmosis_simulation_sample_config.yaml",
    "hybrid_turbo": "osmosis_simulation_sample_config.yaml",
    "haze": "osmosis_haze_sample_config.yaml",
    "rgb": "rgb_guidance_sample_config.yaml",
    "prior": "RGBD_sample_config.yaml",
}


def _load_cfg(path):
    with open(path) as f:
        return yaml.safe_load(f)


def make_preset_cfg(base_cfg, name, *, checkpoint, sim_dir, out_dir, stop_after,
                    tiny_unet=None, optimizer=None, smoke_steps=None):
    """One sweep variant from its reference base config. Returns (cfg, path).
    ``smoke_steps`` cuts the chain last: ddim ``smoke_steps``, clip_denoised."""
    cfg = copy.deepcopy(base_cfg)
    cfg["save_dir"] = os.path.join(out_dir, name)
    cfg["unet_model"]["model_path"] = checkpoint
    if tiny_unet:
        cfg["unet_model"].update(tiny_unet)
    cfg["data"].update(
        root=os.path.join(sim_dir, "input"),
        gt_rgb=os.path.join(sim_dir, "gt_rgb"),
        gt_depth=os.path.join(sim_dir, "gt_depth"),
        stop_after=stop_after, ground_truth=True,
    )
    cfg["record_process"] = False

    params = cfg["conditioning"]["params"]
    tiny = tiny_unet is not None
    if tiny and name in ("haze", "rgb"):
        # the underwater bases get their tiny shortening in main(); these
        # presets carry their own reference base configs
        cfg["diffusion"].update(sampler="ddim", timestep_respacing="ddim5")
        cfg["sample_pattern"]["n_iter"] = 2
    if name == "fast":
        # the tiny self-test keeps the base's short chain; real runs ddim200
        if not tiny:
            cfg["diffusion"].update(sampler="ddim", timestep_respacing="ddim200")
        _scale_etas(cfg, 5.0)  # 5x fewer steps -> 5x phi eta
    elif name == "turbo":
        if not tiny:
            cfg["diffusion"].update(sampler="ddim", timestep_respacing="ddim100")
        _scale_etas(cfg, 10.0)
    elif name == "x0":
        # x0-gradient mode: no UNet backward; halve the scale, keep the ratio
        params["gradient_x_prev"] = False
        params["scale"] = _scale_guidance(params["scale"], 0.5)
    elif name == "x0_turbo":
        # x0 mode at the turbo step count, the fast preset's 5x etas only
        params["gradient_x_prev"] = False
        params["scale"] = _scale_guidance(params["scale"], 0.5)
        if not tiny:
            cfg["diffusion"].update(sampler="ddim", timestep_respacing="ddim100")
        _scale_etas(cfg, 5.0)
    elif name == "hybrid":
        params["x_prev_every"] = 4
    elif name == "hybrid_turbo":
        # hybrid k=4 at ddim25, full scale, the fast preset's 5x etas
        # (25 % 4 = 1 exercises the epilogue block)
        params["x_prev_every"] = 4
        if not tiny:
            cfg["diffusion"].update(sampler="ddim", timestep_respacing="ddim25")
        _scale_etas(cfg, 5.0)
    elif name == "haze":
        # the haze preset degammas its (gamma-encoded photo) inputs; the
        # simulation set is linear-coded PNGs, so degamma off
        cfg["degamma_input"] = False
    elif name not in ("reference", "rgb"):
        raise ValueError(name)
    if optimizer:
        cfg["measurement"]["operator"]["optimizer"] = optimizer
    if smoke_steps:
        cfg["diffusion"].update(sampler="ddim", timestep_respacing=f"ddim{smoke_steps}",
                                clip_denoised=True)

    path = os.path.join(out_dir, f"cfg_{name}{'_' + optimizer if optimizer else ''}.yaml")
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    return cfg, path


def _scale_etas(cfg, factor):
    op = cfg["measurement"]["operator"]
    for k in list(op):
        if k.endswith("_eta"):
            op[k] = float(op[k]) * factor


def _scale_guidance(scale, factor):
    vals = [float(s) for s in str(scale).split(",")]
    return ",".join(str(v * factor) for v in vals)


# ------------------------------------------------------------ health checks

def parse_phi_rows(run_dir):
    """The run's progress.json rows (each image's final phi, loss, seconds)."""
    rows = []
    p = os.path.join(run_dir, "progress.json")
    if os.path.exists(p):
        with open(p) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    return rows


def check_phi_stall(cfg, run_dir, stall_rel=0.01, loss_high_rel=0.5):
    """True (stalled) when every learned phi channel moved <1% from its init
    on every image WHILE the measurement loss stayed high: with a nonzero eta
    the optimizer is stuck, so retry with adam. A run whose phi froze because
    the init was already near the truth shows a low final loss and is not a
    stall."""
    rows = parse_phi_rows(run_dir)
    if not rows:
        return False
    op = cfg["measurement"]["operator"]
    inits = {}
    for k, v in op.items():
        if k.startswith("phi_") and not k.endswith(("_eta", "_learn_flag")):
            inits[k] = np.fromstring(str(v), sep=",")
    moved = []
    for r in rows:
        for pname, init in inits.items():
            eta = float(op.get(f"{pname}_eta", 0))
            if eta == 0 or not op.get(f"{pname}_learn_flag", True):
                continue
            for ci, iv in enumerate(init):
                fv = r.get(f"{pname}_{ci}")
                if fv is None:
                    continue
                denom = max(abs(iv), 1e-6)
                moved.append(abs(fv - iv) / denom >= stall_rel)
    if not (bool(moved) and not any(moved)):
        return False
    # phi froze: a stall only if the loss was NOT driven down. Judged from
    # the per-chain telemetry (rows run t=T-1..0, so the last row is the
    # chain's final loss); without telemetry the displacement verdict stays.
    log = os.path.join(run_dir, "log.txt")
    if os.path.exists(log):
        per_chain_converged = []
        for chain in parse_chain_telemetry(log):
            ls = np.asarray([loss for _, loss, _ in chain], float)
            ls = ls[np.isfinite(ls)]
            if ls.size >= 2 and ls.max() > 0:
                per_chain_converged.append(ls[-1] <= loss_high_rel * ls.max())
        if per_chain_converged and all(per_chain_converged):
            return False
    return True


_TELEMETRY_HEADER = "chain telemetry (scan trace"
# x0_std is optional: a loss-only row must still feed check_phi_stall's
# loss-convergence exemption
_TELEMETRY_ROW = re.compile(r"^\s+t=\s*(\d+)\s+loss=\s*(\S+)(?:\s+x0_std=(\S+))?")


def parse_chain_telemetry(log_path):
    """log.txt -> one [(t, loss, x0_std), ...] list per chain, from the blocks
    that ``pipelines.restore._log_trace_summary`` writes after each chain, so
    contraction is judged within a chain, never across all images' rows. The
    ``progress N/T ... x0_std=`` rows of progress_segments do not have the
    block-row shape and are left out."""
    chains, cur = [], None
    with open(log_path) as f:
        for line in f:
            if _TELEMETRY_HEADER in line:
                cur = []
                chains.append(cur)
                continue
            m = _TELEMETRY_ROW.match(line) if cur is not None else None
            if m is not None:
                try:
                    loss = float(m.group(2))
                except ValueError:
                    loss = float("nan")
                # an absent token is None (loss-only telemetry); one that
                # printed as nan stays NaN, so a diverged chain still fails
                # the contraction gate
                if m.group(3) is None:
                    std = None
                else:
                    try:
                        std = float(m.group(3))
                    except ValueError:
                        std = float("nan")
                cur.append((int(m.group(1)), loss, std))
            elif cur is not None:
                cur = None  # any non-row line closes the block
    return [c for c in chains if c]


def check_x0_contraction(run_dir):
    """Per-chain health gate on the x0-hat amplitude telemetry: a healthy
    chain contracts from its early-chain maximum toward the prior's scene
    scale by mid-chain; every chain in the run must. Returns (ok, detail)."""
    log = os.path.join(run_dir, "log.txt")
    if not os.path.exists(log):
        return True, "no log"
    # a chain with no x0_std token at all (loss-only telemetry) has nothing to
    # gate; one whose x0_std printed as nan (divergence) fails below
    chains = [
        [(t, loss, float("nan") if std is None else std) for t, loss, std in c]
        for c in parse_chain_telemetry(log)
        if len(c) >= 4 and any(std is not None for _, _, std in c)
    ]
    if not chains:
        return True, "no x0_std telemetry"
    details, all_ok = [], True
    for ci, rows in enumerate(chains):
        ts = np.asarray([r[0] for r in rows], float)
        vals = np.asarray([r[-1] for r in rows], float)
        # rows run t=T-1..0; "early" = the highest-t quarter of the chain,
        # "mid" = the row nearest t=T/2, positions inside THIS chain
        T = ts.max() + 1
        early = vals[ts >= 0.75 * (T - 1)]
        early_max = float(early.max()) if early.size else float(vals[0])
        mid = float(vals[np.argmin(np.abs(ts - T / 2))])
        ok = bool(np.isfinite(vals).all() and mid <= early_max * 0.95)
        all_ok &= ok
        details.append(f"chain {ci}: early_max={early_max:.3f} mid={mid:.3f} "
                       f"{'ok' if ok else 'NO CONTRACTION'}")
    return all_ok, f"{len(chains)} chain(s): " + "; ".join(details)


def score_run(run_dir, sim_dir, image_size=256, use_manifest=True):
    """PSNR/SSIM and the recovered-phi MAE from ``evaluate`` (one JSON line)."""
    rgb = os.path.join(run_dir, "single_images", "rgb")
    if not os.path.isdir(rgb):
        return {"error": "no outputs"}
    cmd = tool_cmd("evaluate", "--results", rgb, "--gt", os.path.join(sim_dir, "gt_rgb"),
                   "--resize-gt", image_size, device=False)
    manifest = os.path.join(sim_dir, "manifest.json")
    if use_manifest and os.path.exists(manifest):
        cmd += ["--manifest", manifest, "--run", run_dir]
    out = sh(cmd, check=False)
    # the report is the LAST line that decodes as a JSON object (stderr is
    # merged in); a parse failure never aborts the sweep
    for line in reversed(out.splitlines()):
        line = line.strip()
        if line.startswith("{") and line.endswith("}"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return {"error": "no score parsed", "tail": out.splitlines()[-3:]}


# ------------------------------------------------------------------- main

def run_prior_smoke(ctx, report):
    """The row of the unconditional RGBD prior sampler
    (configs/RGBD_sample_config.yaml): N images sampled, gated on being
    present, decodable, finite and not constant."""
    from PIL import Image

    from ..pipelines.prior import run_prior_sampling

    cfg = _load_cfg(os.path.join(CONFIGS, PRESET_BASES["prior"]))
    cfg["save_dir"] = os.path.join(ctx["out_dir"], "prior")
    cfg["unet_model"]["model_path"] = ctx["checkpoint"]
    tiny = ctx["tiny_unet"] is not None
    smoke = ctx.get("smoke_steps")
    if tiny:
        cfg["unet_model"].update(ctx["tiny_unet"])
        cfg["diffusion"].update(timestep_respacing=5)
    if smoke:
        cfg["diffusion"].update(timestep_respacing=smoke)
    cfg["number_of_images"] = 2 if tiny or smoke else 4
    cfg["record_process"] = False
    path = os.path.join(ctx["out_dir"], "cfg_prior.yaml")
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    t0 = time.time()
    run_dir = run_prior_sampling(path, device=ctx["device"])
    _record_stage("preset:prior", time.time() - t0, n_images=cfg["number_of_images"])

    rgb_dir = os.path.join(run_dir, "single_images", "rgb")
    names = sorted(os.listdir(rgb_dir)) if os.path.isdir(rgb_dir) else []
    ok = len(names) == cfg["number_of_images"]
    stats = []
    for n in names:
        arr = np.asarray(Image.open(os.path.join(rgb_dir, n)), dtype=float)
        stats.append({"name": n, "mean": round(float(arr.mean()), 2),
                      "std": round(float(arr.std()), 2)})
        # not constant: a collapsed or NaN chain clips to a flat image
        ok = ok and bool(np.isfinite(arr).all()) and arr.std() > 1.0
    entry = {
        "config": path, "run_dir": run_dir,
        "score": {"n_images": len(names)},
        "prior_stats": stats,
        "x0_std_contraction": {
            "ok": bool(ok),
            "detail": "prior smoke gate: outputs present/finite/non-constant",
        },
    }
    if not ok:
        print(f"[runbook] WARNING prior: smoke gate failed ({stats})")
    report["presets"]["prior"] = entry
    return entry


def run_preset(name, ctx, report):
    """One preset through ``run_restoration``: health-checked, retried with
    adam on a phi stall, scored."""
    from ..pipelines.restore import run_restoration

    kw = dict(ctx)
    sim_haze = kw.pop("sim_dir_haze", None)
    device = kw.pop("device")
    if name == "prior":
        return run_prior_smoke(dict(kw, device=device), report)
    if name == "haze":
        kw["sim_dir"] = sim_haze
    base_cfg = kw.pop("base_cfg")[name]
    use_manifest = name != "rgb"  # identity operator: no phi to recover

    cfg, path = make_preset_cfg(base_cfg, name, **kw)
    t0 = time.time()
    run_dir = run_restoration(path, device=device)
    # per-image seconds from the run's own progress rows: the first image
    # carries the warm-up (the kernels' first launches, cuDNN's plans), so
    # image 0 - steady estimates it
    per_img = [r["seconds"] for r in parse_phi_rows(run_dir) if "seconds" in r]
    steady = (sum(per_img[1:]) / len(per_img[1:])) if len(per_img) > 1 else None
    _record_stage(
        f"preset:{name}", time.time() - t0,
        per_image=[round(s, 1) for s in per_img],
        steady_s_per_image=round(steady, 1) if steady else None,
        compile_estimate_s=round(per_img[0] - steady, 1) if steady and per_img else None,
    )
    entry = {"config": path, "run_dir": run_dir}

    size = (kw["tiny_unet"] or {}).get("image_size", 256)
    stalled = check_phi_stall(cfg, run_dir)
    if stalled and cfg["measurement"]["operator"].get("optimizer") != "adam":
        print(f"[runbook] {name}: phi stall detected -> retrying with adam")
        _, path2 = make_preset_cfg(base_cfg, name, optimizer="adam", **kw)
        t0 = time.time()
        run_dir2 = run_restoration(path2, device=device)
        _record_stage(f"preset:{name}:adam-retry", time.time() - t0)
        entry.update(phi_stall_sgd=True, adam_run_dir=run_dir2)
        s1 = score_run(run_dir, kw["sim_dir"], size, use_manifest)
        s2 = score_run(run_dir2, kw["sim_dir"], size, use_manifest)
        if s2.get("psnr_mean", -1) > s1.get("psnr_mean", -1):
            entry.update(score=s2, kept="adam", score_sgd=s1)
            run_dir = run_dir2
        else:
            entry.update(score=s1, kept="sgd", score_adam=s2)
    else:
        entry["score"] = score_run(run_dir, kw["sim_dir"], size, use_manifest)

    ok, detail = check_x0_contraction(run_dir)
    entry["x0_std_contraction"] = {"ok": ok, "detail": detail}
    if not ok:
        print(f"[runbook] WARNING {name}: x0_std did not contract ({detail}): "
              "an off-manifold chain")
    report["presets"][name] = entry
    return entry


def device_description(device):
    """The run's device for the rehearsal record: on a card its name and power
    limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return str(device)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(device.index or 0)],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    import torch

    return out or f"{torch.cuda.get_device_name(device)} (nvidia-smi unavailable)"


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=None, help="osmosis_outdoor.pt")
    ap.add_argument("--gt-rgb", default=None, help="clean RGB dir (e.g. NYUv2)")
    ap.add_argument("--gt-depth", default=None, help="uint16 depth dir")
    ap.add_argument("--sim-dir", default=None,
                    help="pre-built simulation set (input/gt_rgb/gt_depth)")
    ap.add_argument("--sim-dir-haze", default=None,
                    help="pre-built HAZE simulation set for the haze preset")
    ap.add_argument("--synth", type=int, default=None, metavar="N",
                    help="build the simulation sets from N procedural 256px scenes instead of "
                         "--gt-rgb/--gt-depth (a rehearsal without a dataset)")
    ap.add_argument("--out", default="runbook_results")
    ap.add_argument("--stop-after", type=int, default=5,
                    help="images per preset (full protocol: -1 = all)")
    ap.add_argument("--presets",
                    default="reference,fast,turbo,x0,x0_turbo,hybrid,hybrid_turbo,haze,rgb,prior",
                    help="comma list; one row per reference surface "
                         f"(known: {','.join(sorted(PRESET_BASES))})")
    ap.add_argument("--tiny", action="store_true",
                    help="harness self-test: tiny random checkpoint + toy scenes")
    ap.add_argument("--smoke-steps", type=int, default=None,
                    help="cut every chain to this many respaced steps (ddim, clip_denoised; "
                         "the prior: its last steps, 2 images) at the real widths")
    ap.add_argument("--rehearsal-json", default=None,
                    help="also write a dated per-stage wall-clock record here, with the "
                         "device's name and power limit")
    ap.add_argument("-d", "--device", type=int, default=0, help="CUDA device index")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    from ..pipelines.restore import resolve_device
    from .validate_checkpoint import TINY

    presets = [p.strip() for p in args.presets.split(",") if p.strip()]
    unknown = [p for p in presets if p not in PRESET_BASES]
    if unknown:
        ap.error(f"unknown presets: {unknown}")
    device = resolve_device("cpu" if args.cpu else f"cuda:{args.device}")
    DEVICE_FLAGS[:] = ["--cpu"] if args.cpu else ["-d", str(args.device)]
    STAGE_SECONDS.clear()

    # the stage subprocesses run from the repo's root while the in-process
    # stages run in the caller's cwd: every path argument absolute
    for attr in ("checkpoint", "gt_rgb", "gt_depth", "sim_dir", "sim_dir_haze", "out"):
        v = getattr(args, attr)
        if v:
            setattr(args, attr, os.path.abspath(v))

    os.makedirs(args.out, exist_ok=True)
    report = {"checkpoint": args.checkpoint, "presets": {}}
    bases = {name: _load_cfg(os.path.join(CONFIGS, PRESET_BASES[name]))
             for name in presets if name != "prior"}
    tiny_unet = None
    if args.smoke_steps:
        print(f"[runbook] cut: every chain at ddim{args.smoke_steps} with clip_denoised "
              f"(the prior: its last {args.smoke_steps} steps, 2 images); n_iter and the "
              "widths as each preset has them")

    if args.tiny:
        # a tiny random checkpoint at a small arch, and toy scenes
        ckpt = os.path.join(args.out, "tiny_random.msgpack")
        sh(tool_cmd("validate_checkpoint", "--tiny", "--skip-sample", "--out", ckpt),
           log_path=os.path.join(args.out, "stage1_convert.log"))
        tiny_unet = dict(TINY)
        # shorten the simulation-based sweep presets here; haze/rgb carry
        # their own base configs and shorten inside make_preset_cfg
        for name, cfg in bases.items():
            if PRESET_BASES[name].startswith("osmosis_simulation"):
                cfg["diffusion"].update(sampler="ddim", timestep_respacing="ddim5")
                cfg["sample_pattern"]["n_iter"] = 2
        args.checkpoint = ckpt
        if not args.sim_dir:
            args.sim_dir = os.path.join(args.out, "sim")
            sh(tool_cmd("simulate_degraded", "--out", args.sim_dir, "--synth", 2, "--size", 32,
                        "--operator", "underwater_physical"),
               log_path=os.path.join(args.out, "stage2_simulate.log"))
        if "haze" in presets and not args.sim_dir_haze:
            args.sim_dir_haze = os.path.join(args.out, "sim_haze")
            sh(tool_cmd("simulate_degraded", "--out", args.sim_dir_haze, "--synth", 2,
                        "--size", 32, "--operator", "haze_physical"),
               log_path=os.path.join(args.out, "stage2_simulate_haze.log"))
    else:
        if not args.checkpoint or not os.path.exists(args.checkpoint):
            ap.error("--checkpoint is required (or use --tiny for the self-test)")
        # stage 1: convert + activation parity (fails loudly on a mismatch)
        ckpt_ms = os.path.join(args.out, "osmosis_outdoor.msgpack")
        out = sh(tool_cmd("validate_checkpoint", "--checkpoint", args.checkpoint,
                          "--skip-sample", "--out", ckpt_ms),
                 log_path=os.path.join(args.out, "stage1_convert.log"))
        report["activation_parity"] = out.splitlines()[-3:]
        args.checkpoint = ckpt_ms

        # stage 2: the simulation set (the paper's protocol), from the clean
        # RGBD folders or, with --synth, from procedural scenes
        source = (["--synth", args.synth] if args.synth else
                  ["--gt-rgb", args.gt_rgb, "--gt-depth", args.gt_depth])
        if not args.sim_dir:
            if not (args.synth or args.gt_rgb and args.gt_depth):
                ap.error("need --sim-dir, --gt-rgb/--gt-depth or --synth")
            args.sim_dir = os.path.join(args.out, "sim")
            sh(tool_cmd("simulate_degraded", "--out", args.sim_dir, *source, "--size", 256,
                        "--operator", "underwater_physical"),
               log_path=os.path.join(args.out, "stage2_simulate.log"))
        if "haze" in presets and not args.sim_dir_haze:
            if not (args.synth or args.gt_rgb and args.gt_depth):
                # a pre-built --sim-dir run cannot synthesize the haze set:
                # run every other surface and flag haze, not abort
                print("[runbook] skipping haze preset: needs --sim-dir-haze "
                      "or --gt-rgb/--gt-depth to build one", file=sys.stderr)
                presets = [p for p in presets if p != "haze"]
                report["presets"]["haze"] = {
                    "skipped": "no --sim-dir-haze and no --gt-rgb/--gt-depth to build one"}
        if "haze" in presets and not args.sim_dir_haze:
            args.sim_dir_haze = os.path.join(args.out, "sim_haze")
            sh(tool_cmd("simulate_degraded", "--out", args.sim_dir_haze, *source, "--size", 256,
                        "--operator", "haze_physical"),
               log_path=os.path.join(args.out, "stage2_simulate_haze.log"))

    report["checkpoint"] = args.checkpoint  # the converted msgpack
    ctx = dict(checkpoint=args.checkpoint, sim_dir=args.sim_dir,
               sim_dir_haze=args.sim_dir_haze, out_dir=args.out,
               stop_after=args.stop_after, tiny_unet=tiny_unet,
               smoke_steps=args.smoke_steps, base_cfg=bases, device=device)

    # stages 3 and 4: the reference preset, the sign-off sweeps, the other
    # surfaces. One preset's failure must not abort the sweep: it is retried
    # once, then recorded as the preset's row, and the sweep goes on.
    for name in presets:
        for attempt in (1, 2):
            t0 = time.time()
            try:
                run_preset(name, ctx, report)
                break
            except Exception as e:  # noqa: BLE001 — keep the sweep alive
                print(f"[runbook] ERROR {name} (attempt {attempt}): "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
                # the failed attempt's real time: the day-one budget must
                # not undercount a chain that dies at its end
                _record_stage(f"preset:{name}:error", time.time() - t0,
                              error=f"{type(e).__name__}: {e}"[:300], attempt=attempt)
                if attempt == 2:
                    report["presets"][name] = {"error": f"{type(e).__name__}: {e}"[:500]}

    report["stage_seconds"] = STAGE_SECONDS
    with open(os.path.join(args.out, "RUNBOOK_REPORT.json"), "w") as f:
        json.dump(report, f, indent=2, default=str)
    if args.rehearsal_json:
        total = sum(s["seconds"] for s in STAGE_SECONDS)
        rehearsal = {
            "date": time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime()),
            "mode": ("tiny-selftest" if args.tiny else
                     f"smoke-{args.smoke_steps}-steps" if args.smoke_steps
                     else "production-geometry"),
            "device": device_description(device),
            "stop_after": args.stop_after,
            "presets": presets,
            "stages": STAGE_SECONDS,
            "total_seconds": round(total, 1),
            "total_human": f"{total / 60:.1f} min",
            "note": ("per-preset compile_estimate_s = image0 - steady-state: the first "
                     "image's warm-up (first kernel launches, cuDNN plans); the CUDA kernels "
                     "are built once per checkout (osmosis_tpu_torch/_build)"),
        }
        os.makedirs(os.path.dirname(os.path.abspath(args.rehearsal_json)), exist_ok=True)
        with open(args.rehearsal_json, "w") as f:
            json.dump(rehearsal, f, indent=1)
        print(f"[runbook] rehearsal record -> {args.rehearsal_json}")
    lines = ["# Real-weights runbook report", ""]
    lines.append(f"checkpoint: `{report['checkpoint']}`")
    lines.append("")
    lines.append("| preset | PSNR | SSIM | phi MAE | x0_std contracts | notes |")
    lines.append("|---|---|---|---|---|---|")
    for name, e in report["presets"].items():
        s = e.get("score", {})
        notes = []
        if e.get("phi_stall_sgd"):
            notes.append(f"phi stalled on sgd; kept {e['kept']}")
        if e.get("skipped"):
            notes.append(f"SKIPPED: {e['skipped']}")
        if e.get("error"):
            notes.append(f"ERROR: {e['error']}")
        contraction = e.get("x0_std_contraction", {}).get("ok", "n/a")
        lines.append(
            f"| {name} | {s.get('psnr_mean', 'n/a')} | "
            f"{s.get('ssim_mean', 'n/a')} | {s.get('phi_mae', 'n/a')} | "
            f"{contraction} | {'; '.join(notes) or '-'} |"
        )
    lines += ["", "Paper protocol: PSNR/SSIM vs GT on the NYUv2-simulated set "
              "(reference README.md:93-106). Compare against the paper's "
              "table 1 for parity sign-off."]
    with open(os.path.join(args.out, "RUNBOOK_REPORT.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return report


if __name__ == "__main__":
    main()
