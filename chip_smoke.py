#!/usr/bin/env python3
"""Smoke run of osmosis_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failed check:
  1. device: the card's name and power limit;
  2. build: the CUDA C++ kernels (K1-K5) from osmosis_tpu_torch/ops/csrc with
     nvcc for sm_90a, one nvcc per source, all started together, and the
     native host ops (osmosis_tpu_torch/utils/csrc/host_ops.cc, g++ with
     zlib), whose build failure raises;
  3. kernels: every kernel (K1-K4) against its plain PyTorch version at every
     shape the main path gives it, fp32 and bf16, forward and backward (K4
     with and without its parameter sums), timed
     on the device (ten calls captured in one CUDA graph, replayed) and
     eagerly, beside its
     plain version, its byte bound and one PyTorch library call that
     computes the same function; K3/K4 also give the same bits on a second
     call and launch the device kernels their geometry plans (1 or 2); K5,
     the phi fit (19 passes at 256x256, the hybrid preset's operator, batch
     1 and 4), with the Fit the guided loop's route gives, against its
     plain version and the eager loop it replaces, timed beside its byte
     bound and that loop;
  4. a tiny UNet, forward and x-VJP, through the kernels on the card against
     the plain versions on the CPU;
  5. the main path at full width: the reference preset through
     ``run_restoration`` (the CLI's entry point) with a seeded random-init
     checkpoint, 20 respaced steps, one image; the kernels' launch counts are
     zeroed just before and read just after, K5's one at each step with
     phi-only passes (here and in every osmosis chain below; none in the
     prior, rgb_guidance and training). Then the first step's UNet
     forward and pullback, timed and FLOP-counted, seconds per warm guided
     step, and the device's busy share over one warm guided step from
     ``torch.profiler``;
  6. the bf16 fast path at full width: the hybrid preset (bf16 torso, the
     UNet pullback at every 4th step, the x0 gradient between) through
     ``run_restoration`` with ddim20, one image, the same checkpoint; the
     launch counts are asserted per step kind (K3 at every step, K4 and the
     backward resampling at the x_prev steps only, K5 at every step with
     phi-only passes) and the loaded torso's
     dtypes printed;
  7. bf16 timing: seconds per warm x_prev step and per warm x0 step, the
     busy share over a warm hybrid chain, the bf16 UNet forward and forward +
     pullback against the 989 TFLOP/s bf16 peak; one hybrid segment at batch
     1 (8 steps, cuDNN deterministic): K5 launched once a step, and its phi
     against the eager twin's (K5 barred) at K5's bar;
  8. the RGBD prior sampler (``run_prior_sampling``) at full width, fp32, 20
     steps, one image: K3 at every forward, K4 never; seconds per step;
  9. rgb_guidance (vanilla DPS) through ``run_restoration``, fp32, 10 steps,
     one image: the run dir complete;
 10. the haze (haze_physical, degamma) and simulation (underwater_physical,
     ground truth) presets through ``run_restoration`` at full width, fp32,
     20 steps, one seeded image each (GT RGB and uint16 depth written from a
     seed): the run dirs, the GT grid, the launch counts per step;
 11. every kernel at every main-path site at batch 4, as in phase 3, with
     the launch geometries that differ from batch 1's printed; K4 also timed
     with its parameter sums (a train step's call) against its bound and the
     library's autograd with the weight gradients;
 12. the fleet: data.batch_size 4 with 4 seeded images through
     ``run_restoration``, the fp32 preset and the bf16 hybrid preset
     (clip_denoised), with batch 1's launch counts per step; each lane's
     first-step UNet output and pullback at batch 4 against its batch-1 call;
     seconds per step and per image-step at batch 1, 2 and 4 in both dtypes,
     the busy share at batch 4 and the peak memory;
 13. progress_segments and chain_checkpoint on the bf16 hybrid preset: two
     plain runs compared, then a run killed after its first boundary and
     resumed, whose PNGs must equal the uninterrupted run's byte for byte;
     the same kill and resume on the fp32 preset (ddim20, clip_denoised),
     whose chain_checkpoint runs take cuDNN's deterministic algorithms;
 14. best_of 2 with phi_jitter, global_N 2 with global_eta_scale 0.5 and
     async_save, asserted by their log lines;
 15. training at full width: the toy-prior trainer's step (Adam and the EMA)
     on ``toy_unet_config(256, 256, "production")``, the preset model's 552.8M
     parameters, batch 4, fp32: seconds per step and per image, the busy
     share, the peak; K1-K4's launches per step asserted, K4 with its
     parameter sums at every site (the FiLM sums at the 42 FiLM sites);
     finite loss and gradients, the EMA moved; one step with remat (K3 run
     again in the backward) at a lower peak;
 16. the toy loop: ``train_toy_prior`` at 32x32 (300 steps at batch 128,
     health check on) whose loss must fall; a restore run of the preset at
     toy size that loads its EMA checkpoint (``.msgpack``) without the
     random-init fallback; one tiny train step on the card against the CPU;
 17. the server (``tools.serve``) at full width: the fast preset (bf16
     torso, x_prev at every step) with the seeded checkpoint, ddim20 and
     clip_denoised, behind HTTP on a local port: /healthz 503 before the
     warmup and 200 after it, three restores of a data/underwater image
     (seed 0 twice: the same bytes; seed 1: other bytes) with the launch
     counts zeroed before and asserted after each, a bad payload (400) and an
     unknown route (404); ms per request and per step, the busy share over
     one request, the peak memory;
 18. the quality tools at toy size: ``simulate_degraded`` (card against
     CPU), ``validate_toy_e2e`` on phase 16's EMA checkpoint (4 scenes, 50
     steps), ``demo_toy_restore`` (``run_restoration`` scored by
     ``evaluate``) and ``validate_checkpoint --tiny``;
 19. two ranks on the one card (``parallel/multihost`` over gloo), each a
     process of the port's CLI (``--coordinator 127.0.0.1:<port>
     --num-processes 2 --process-id k -d 0``): the fp32 preset (10 steps,
     clip_denoised, cuDNN's deterministic algorithms) on three images
     against one process (one run dir, image i on rank i % 2, each rank's
     launches, every PNG byte for byte; the same run with cuDNN's default
     algorithms and the UNet's repeated calls show why),
     the prior on two indices, and the fp32 preset (10 steps) and the bf16
     hybrid preset (ddim20) on four images each, timed in one process and in
     two: seconds per image-step and each rank's peak memory;
 20. the day-one runbook (``tools.real_weights_runbook.main``) at full width
     on the card, every stage: the seeded checkpoint converted and checked,
     the underwater and haze simulation sets built from a seeded GT scene,
     the reference, x0_turbo, hybrid_turbo, haze, rgb and prior presets cut
     to ddim10 (clip_denoised; the prior: 2 images, its last 10 steps), one
     image each, scored and gated, with each preset's launch counts (K4 on
     the x_prev steps only, K5 in the SGD run of an osmosis preset) and no
     preset failing; ``tools.seed_replicate``
     on one cell, overridden to phase 16's toy EMA and 2 scenes, its row in a
     workdir grid; the native host ops against their numpy paths (the same
     values, host ms per image);
 21. the (dp, tp) mesh (``parallel/mesh``, ``parallel/tp``) through
     ``tools.mesh_check``: two ranks share cuda:0 over gloo, fp32, TF32 off,
     cuDNN deterministic, the preset's 552.8M UNet at 256² from the seeded
     checkpoint: tp=2 (the UNet forward and x-pullback, the 2-step guided
     chain at batch 1 with clip_denoised) and dp=2 (the joint-loss chain at
     batch 2 through ``guided_sample_loop(mesh=)``, its loss reduced over
     the dp group, and the fleet runner at N=2 with ``mesh=``), every output
     within rtol/atol 5e-4 (the loss trace 1e-3) of one process (under dp
     its UNet called on each rank's images, the difference from the whole
     batch in one call reported); each rank's K1-K4 launches those of one
     process; under tp=2 each rank holds the replicated parameter bytes and
     half the sharded ones; each rank's peak and seconds. Then the committed
     orbax fixture (``tests/data/orbax_tiny_unet``) read by ``load_unet``
     onto the card with the native zstd decoder, its forward against the
     recorded one at the UNet parity bar (rtol 1e-3, atol 5e-4); and the
     seeded 552.8M tree written by ``save_params_orbax`` and read back by
     ``load_unet`` onto the card, its forward bit for bit the in-memory
     model's (write and read seconds: host numbers).
The line before the last gives the card's name and power limit, the one
before it the kernels' JSON summary (each kernel's fp32 numbers on the main
path, its bf16 per-step numbers on the hybrid path, at batch 4, per train
step, its launches per served request, per runbook preset and per mesh
rank); the last
line is the result.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "results")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 dense on the tensor cores
STEPS = 20

# tolerances, max|kernel - plain| <= atol + rtol * max|plain|:
#   K1/K2 copy or sum in fp32 in the plain version's order: exact;
#   K3/K4 fp32: 1e-4 relative, for the order of summation over up to 2M values;
#   bf16: the output is rounded to bf16 (8 bits of mantissa); the kernel rounds
#   the epilogue's intermediates where the plain version does, but a sum in
#   another order can round a value to the neighbouring bf16 number.
TOL = {
    ("resample", "float32"): (0.0, 0.0),
    ("resample", "bfloat16"): (0.0, 0.0),
    ("norm", "float32"): (1e-4, 1e-5),
    ("norm", "bfloat16"): (3e-2, 3e-2),
    ("orbax", "float32"): (1e-3, 5e-4),  # the UNet parity bar
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def check_close(what, got, ref, kind, dtype_name):
    import torch

    rtol, atol = TOL[(kind, dtype_name)]
    err = (got.float() - ref.float()).abs().max().item() if got.numel() else 0.0
    scale = ref.float().abs().max().item() if ref.numel() else 0.0
    if not (math.isfinite(err) and err <= atol + rtol * scale):
        raise AssertionError(f"{what}: max abs err {err:.3e} over max|ref| {scale:.3e} "
                             f"exceeds atol {atol} + rtol {rtol}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    return err


# ---------------------------------------------------------------------------
# the main path's kernel call sites, from the UNet's architecture plan
# ---------------------------------------------------------------------------

def main_path_sites(cfg, batch=1):
    """Per UNet forward: GroupNorm sites (C, H, W, mode) and the NHWC input
    shapes of the nearest-2x upsamples and the 2x2 pools at ``batch``."""
    from osmosis_tpu_torch.models.unet import build_plan

    inputs, middle, outputs = build_plan(cfg)
    gn, ups, pools = [], [], []
    res = cfg.image_size

    def visit(lay):
        nonlocal res
        kind = lay["kind"]
        if kind in ("res", "res_down", "res_up"):
            gn.append((lay["in_ch"], res, res, "silu"))
            if kind == "res_down":
                pools.extend([(batch, res, res, lay["in_ch"])] * 2)
                res //= 2
            elif kind == "res_up":
                ups.extend([(batch, res, res, lay["in_ch"])] * 2)
                res *= 2
            gn.append((lay["out_ch"], res, res, "film"))
        elif kind == "attn":
            gn.append((lay["ch"], res, res, "none"))

    for block in inputs + [middle] + outputs:
        for lay in block:
            visit(lay)
    gn.append((int(cfg.channel_mult[0] * cfg.model_channels), res, res, "silu"))
    return gn, ups, pools


def counted(items):
    out = {}
    for it in items:
        out[it] = out.get(it, 0) + 1
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_resample_kernels(ups, pools, report, k_hybrid, suffix=""):
    import torch
    import torch.nn.functional as F

    from osmosis_tpu_torch.utils.timing import cuda_time_ms, graph_time_ms

    from osmosis_tpu_torch.ops import upsample as U

    rows = []
    # per guided step: K1 runs forward at every upsample and backward at every
    # pool (scale 0.25); K2 forward at every pool and backward at every upsample.
    # The forwards run at every step, the backwards at full (x_prev) steps only:
    # on the hybrid path one step in k_hybrid.
    k1_sites = [(s, 1.0) for s in ups] + [((b, h // 2, w // 2, c), 0.25) for b, h, w, c in pools]
    k2_sites = [((b, 2 * h, 2 * w, c), 1.0) for b, h, w, c in ups] + [(s, 0.25) for s in pools]
    for name, sites, kernel, plain, fwd_scale in (
            ("upsample_nearest_2x", k1_sites, U.upsample_nearest_2x_kernel,
             U.upsample_nearest_2x_plain, 1.0),
            ("box_sum_2x", k2_sites, U.box_sum_2x_kernel, U.box_sum_2x_plain, 0.25)):
        agg = dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   max_abs_err=0.0)
        hyb = dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   max_abs_err=0.0)
        for (shape, scale), n in counted(sites).items():
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[1]
                x = torch.randn(shape, device="cuda", dtype=dtype)
                got, ref = kernel(x, scale), plain(x, scale)
                torch.cuda.synchronize()
                err = check_close(f"{name}{shape} x{scale} {dn}", got, ref, "resample", dn)
                xn = x.permute(0, 3, 1, 2)
                if name == "upsample_nearest_2x":
                    lib = lambda: F.interpolate(xn, scale_factor=2, mode="nearest")  # noqa: E731
                else:
                    lib = lambda: F.avg_pool2d(  # noqa: E731
                        xn, 2, divisor_override=None if scale == 0.25 else 1)
                t_k = graph_time_ms(lambda: kernel(x, scale))
                t_e = cuda_time_ms(lambda: kernel(x, scale))
                t_p = graph_time_ms(lambda: plain(x, scale))
                t_l = graph_time_ms(lib)
                nbytes = (x.numel() + got.numel()) * x.element_size()
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                rows.append(dict(kernel=name, batch=shape[0], shape=list(shape), scale=scale,
                                 dtype=dn, per_step=n, max_abs_err=err, ms=t_k, eager_ms=t_e,
                                 plain_ms=t_p, library_ms=t_l, bound_ms=bound))
                log(f"  {name} {shape} x{scale} {dn}: err {err:.2e} kernel {t_k * 1e3:.1f} us"
                    f" (eager {t_e * 1e3:.1f}) plain {t_p * 1e3:.1f} library {t_l * 1e3:.1f}"
                    f" bound {bound * 1e3:.1f} (x{n} per step)")
                if dtype == torch.float32:  # the main path runs fp32
                    for k, v in (("ms", t_k), ("eager_ms", t_e), ("plain_ms", t_p),
                                 ("bound_ms", bound), ("library_ms", t_l)):
                        agg[k] += n * v
                    agg["max_abs_err"] = max(agg["max_abs_err"], err)
                else:  # the bf16 hybrid path, per step on average
                    w = n if scale == fwd_scale else n / k_hybrid
                    for k, v in (("ms", t_k), ("eager_ms", t_e), ("plain_ms", t_p),
                                 ("bound_ms", bound), ("library_ms", t_l)):
                        hyb[k] += w * v
                    hyb["max_abs_err"] = max(hyb["max_abs_err"], err)
        report[name + suffix] = agg
        report[name + "_bf16_hybrid" + suffix] = hyb
    return rows


def check_norm_kernels(gn_sites, report, k_hybrid, batch=1, suffix=""):
    import torch
    import torch.nn.functional as F

    from osmosis_tpu_torch.utils.timing import cuda_time_ms, graph_time_ms

    from osmosis_tpu_torch.ops import group_norm as G

    rows = []
    agg_f = dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                 max_abs_err=0.0)
    agg_b = dict(agg_f)
    agg_t = dict(agg_f)  # K4 as a train step calls it: with the parameter sums
    hyb_f = dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                 max_abs_err=0.0)
    hyb_b = dict(hyb_f)
    # the output norm runs in fp32 on the bf16 path too (the torso's output is
    # cast to fp32 before it); it is the last site of the plan
    out_site = gn_sites[-1]
    classes = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (c, h, w, mode), n in counted(gn_sites).items():
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]

            def rnd(*shape, scale=1.0, shift=0.0, dt=dtype):
                return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(dt)

            x = rnd(batch, c, h, w, scale=1.5, shift=0.3).contiguous(
                memory_format=torch.channels_last)
            wgt, bias = rnd(c, scale=0.1, shift=1.0, dt=torch.float32), rnd(c, scale=0.1,
                                                                             dt=torch.float32)
            fs = rnd(batch, c, scale=0.2) if mode == "film" else None
            ft = rnd(batch, c, scale=0.2) if mode == "film" else None
            silu = mode != "none"
            gy = rnd(batch, c, h, w).contiguous(memory_format=torch.channels_last)
            tag = f"group_norm B={batch} C={c} {h}x{w} {mode} {dn}"

            c0 = counters()
            k0 = (c0["group_norm_forward.kernel_launches"],
                  c0["group_norm_backward.kernel_launches"])
            y, m, i = G.group_norm_forward(x, wgt, bias, fs, ft, silu)
            k1 = counters()["group_norm_forward.kernel_launches"]
            grads = G.group_norm_backward(gy, x, wgt, bias, fs, ft, silu, m, i)
            k2 = counters()["group_norm_backward.kernel_launches"]
            yp, mp, ip = G.group_norm_forward_plain(x, wgt, bias, fs, ft, silu)
            gradsp = G.group_norm_backward_plain(gy, x, wgt, bias, fs, ft, silu, mp, ip)
            # a second call of each, and the backward without the parameter
            # sums (the main path's), must give the same bits
            y2, m2, i2 = G.group_norm_forward(x, wgt, bias, fs, ft, silu)
            grads2 = G.group_norm_backward(gy, x, wgt, bias, fs, ft, silu, m, i)
            dx_only = G.group_norm_backward(gy, x, wgt, bias, fs, ft, silu, m, i,
                                            param_grads=False)[0]
            torch.cuda.synchronize()
            same = (torch.equal(y, y2) and torch.equal(m, m2) and torch.equal(i, i2)
                    and all(a is None or torch.equal(a, b2) for a, b2 in zip(grads, grads2))
                    and torch.equal(dx_only, grads[0]))
            if not same:
                raise AssertionError(f"{tag}: two calls are not bit-identical")
            geo = []
            for bwd, k_call in ((False, k1 - k0[0]), (True, k2 - k0[1])):
                sums = 4 if (bwd and fs is not None) else 2
                p, p1 = (G._device_plan(torch.cuda.current_device(), b, c, h, w,
                                        G._DTYPE_CODES[dtype], G._mode(fs, silu), bwd, sums,
                                        G.MAX_CLUSTER) for b in (batch, 1))
                if k_call != p.kernels or k_call > 2:
                    raise AssertionError(f"{tag}: {k_call} device kernels in one call, "
                                         f"expected {p.kernels} ({p.geometry})")
                geo.append(f"{p.geometry}/{p.cluster}")
                if (p.geometry, p.cluster, p.chunks) != (p1.geometry, p1.cluster, p1.chunks):
                    log(f"  plan {'K4' if bwd else 'K3'} {tag}: {p.geometry} cluster {p.cluster}"
                        f" chunks {p.chunks} (batch 1: {p1.geometry} cluster {p1.cluster} "
                        f"chunks {p1.chunks})")
            err_f = check_close(tag + " forward", y, yp, "norm", dn)
            check_close(tag + " mean", m, mp, "norm", "float32")
            check_close(tag + " inv", i, ip, "norm", "float32")
            err_b = 0.0
            for gname, a, b in zip(("dx", "dgamma", "dbeta", "ds", "dt"), grads, gradsp):
                if a is not None:
                    e = check_close(f"{tag} backward {gname}", a, b, "norm", dn)
                    err_b = e if gname == "dx" else err_b

            def lib_fwd(xin=x, w_=wgt, b_=bias, s_=fs, t_=ft):
                hh = F.group_norm(xin, 32, w_.to(dtype), b_.to(dtype), 1e-5)
                if s_ is not None:
                    hh = hh * (1 + s_[:, :, None, None]) + t_[:, :, None, None]
                return F.silu(hh) if silu else hh

            def lib_fwd_bwd(params=()):
                xr = x.detach().requires_grad_(True)
                with torch.enable_grad():
                    return torch.autograd.grad(lib_fwd(xr, *params), [xr, *params], gy)

            fwd = lambda: G.group_norm_forward(x, wgt, bias, fs, ft, silu)  # noqa: E731
            # timed as the main path calls it: x-only, no parameter-gradient sums
            bwd = lambda: G.group_norm_backward(gy, x, wgt, bias, fs, ft, silu, m, i,  # noqa: E731
                                                param_grads=False)
            t_f, t_fe = graph_time_ms(fwd), cuda_time_ms(fwd)
            t_fp = graph_time_ms(lambda: G.group_norm_forward_plain(x, wgt, bias, fs, ft, silu))
            t_fl = graph_time_ms(lib_fwd)
            t_b, t_be = graph_time_ms(bwd), cuda_time_ms(bwd)
            t_bp = graph_time_ms(
                lambda: G.group_norm_backward_plain(gy, x, wgt, bias, fs, ft, silu, m, i))
            # the library backward: its forward and backward captured together,
            # less the forward alone (autograd runs a backward op on the stream
            # of its forward op, so the two are captured in one graph)
            t_bl = max(graph_time_ms(lib_fwd_bwd) - t_fl, 0.0)
            item = x.element_size()
            bound_f = 2 * x.numel() * item / HBM_BYTES_PER_S * 1e3  # read x, write y
            bound_b = 3 * x.numel() * item / HBM_BYTES_PER_S * 1e3  # read x, dy; write dx
            rows.append(dict(kernel="group_norm", batch=batch, C=c, H=h, W=w, mode=mode, dtype=dn,
                             per_step=n, fwd_geometry=geo[0], bwd_geometry=geo[1], fwd_err=err_f, bwd_err=err_b, fwd_ms=t_f,
                             fwd_eager_ms=t_fe, fwd_plain_ms=t_fp, fwd_library_ms=t_fl,
                             fwd_bound_ms=bound_f, bwd_ms=t_b, bwd_eager_ms=t_be,
                             bwd_plain_ms=t_bp, bwd_library_ms=t_bl, bwd_bound_ms=bound_b))
            log(f"  {tag}: err fwd {err_f:.2e} bwd {err_b:.2e} | K3 {t_f * 1e3:.1f} us (eager "
                f"{t_fe * 1e3:.1f}) plain {t_fp * 1e3:.1f} library {t_fl * 1e3:.1f} bound "
                f"{bound_f * 1e3:.1f} | K4 {t_b * 1e3:.1f} us (eager {t_be * 1e3:.1f}) plain "
                f"{t_bp * 1e3:.1f} library {t_bl * 1e3:.1f} bound {bound_b * 1e3:.1f} "
                f"(x{n} per step; {geo[0]} / {geo[1]})")
            if dtype == torch.float32:
                cls = classes.setdefault(site_class(h), dict(sites=0, k3_ms=0.0, k3_library_ms=0.0,
                                                             k3_bound_ms=0.0, k4_ms=0.0,
                                                             k4_library_ms=0.0, k4_bound_ms=0.0))
                cls["sites"] += n
                for k, v in (("k3_ms", t_f), ("k3_library_ms", t_fl), ("k3_bound_ms", bound_f),
                             ("k4_ms", t_b), ("k4_library_ms", t_bl), ("k4_bound_ms", bound_b)):
                    cls[k] += n * v
                # K4 as a train step calls it, with dγ, dβ (and dfs, dft at the
                # FiLM sites), against the library's autograd with the weight
                # leaves; the plain version computes the sums either way
                bwd_sums = lambda: G.group_norm_backward(gy, x, wgt, bias, fs, ft, silu, m, i)  # noqa: E731
                leaves = [t.clone().requires_grad_(True) for t in (wgt, bias, fs, ft)
                          if t is not None]
                t_t, t_te = graph_time_ms(bwd_sums), cuda_time_ms(bwd_sums)
                t_tl = max(graph_time_ms(lambda: lib_fwd_bwd(leaves)) - t_fl, 0.0)
                # read x and dy; write dx, dγ and dβ [C], and dfs and dft [B, C]
                out_params = 2 * c + (2 * batch * c if fs is not None else 0)
                bound_t = bound_b + out_params * item / HBM_BYTES_PER_S * 1e3
                log(f"  {tag} K4 with the parameter sums: {t_t * 1e3:.1f} us (eager "
                    f"{t_te * 1e3:.1f}) library {t_tl * 1e3:.1f} bound {bound_t * 1e3:.1f}")
                for agg, vals, e in ((agg_f, (t_f, t_fe, t_fp, bound_f, t_fl), err_f),
                                     (agg_b, (t_b, t_be, t_bp, bound_b, t_bl), err_b),
                                     (agg_t, (t_t, t_te, t_bp, bound_t, t_tl), err_b)):
                    for k, v in zip(("ms", "eager_ms", "plain_ms", "bound_ms", "library_ms"),
                                    vals):
                        agg[k] += n * v
                    agg["max_abs_err"] = max(agg["max_abs_err"], e)
            # the bf16 hybrid path: K3 at every step, K4 at one step in k_hybrid;
            # its sites run bf16 but for the output norm
            n_site = int((c, h, w, mode) == out_site)
            n_site = n_site if dtype == torch.float32 else n - n_site
            for hyb, wt, vals, e in (
                    (hyb_f, n_site, (t_f, t_fe, t_fp, bound_f, t_fl), err_f),
                    (hyb_b, n_site / k_hybrid, (t_b, t_be, t_bp, bound_b, t_bl), err_b)):
                for k, v in zip(("ms", "eager_ms", "plain_ms", "bound_ms", "library_ms"), vals):
                    hyb[k] += wt * v
                if wt:
                    hyb["max_abs_err"] = max(hyb["max_abs_err"], e)
    report["group_norm_forward" + suffix] = agg_f
    report["group_norm_backward" + suffix] = agg_b
    report["group_norm_backward_train" + suffix] = agg_t
    report["group_norm_forward_bf16_hybrid" + suffix] = hyb_f
    report["group_norm_backward_bf16_hybrid" + suffix] = hyb_b
    report["group_norm_classes" + suffix] = classes
    log("  K3/K4 by site class, fp32 device ms per guided step (kernel / library / bound):")
    for name, cls in classes.items():
        log(f"    {name} ({cls['sites']} sites): K3 {cls['k3_ms']:.4f} / {cls['k3_library_ms']:.4f}"
            f" / {cls['k3_bound_ms']:.4f}; K4 {cls['k4_ms']:.4f} / {cls['k4_library_ms']:.4f} / "
            f"{cls['k4_bound_ms']:.4f}")
    log(f"  K4 with the parameter sums (a train step's call), fp32 device ms per step: "
        f"{agg_t['ms']:.3f} (eager {agg_t['eager_ms']:.3f}) plain {agg_t['plain_ms']:.3f} library "
        f"{agg_t['library_ms']:.3f} bound {agg_t['bound_ms']:.3f}")
    return rows


def _phi_fit_inputs(cfg, batch, seed=0):
    """The preset's operator and guidance at ``batch`` lanes, and x0-hat, y
    and phi at 256x256 for K5: x0-hat in [-1, 1] with a smooth depth, y a
    dimmed copy of it plus noise."""
    import torch

    from osmosis_tpu_torch.diffusion.guided import GuidanceConfig
    from osmosis_tpu_torch.guidance.operators import get_operator

    op_kw = {k: v for k, v in cfg["measurement"]["operator"].items() if k != "name"}
    op = get_operator(cfg["measurement"]["operator"]["name"], batch_size=batch, **op_kw)
    gcfg = GuidanceConfig.from_config("osmosis", cfg["conditioning"]["params"],
                                      cfg["sample_pattern"], cfg["aux_loss"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x0 = torch.rand((batch, 256, 256, 4), generator=gen, device="cuda") * 2 - 1
    x0[..., 3] = 0.7 * torch.linspace(-1, 1, 256, device="cuda")[None, :, None] + 0.2 * x0[..., 3]
    y = (0.6 * x0[..., :3] - 0.2 + 0.1 * torch.randn((batch, 256, 256, 3), generator=gen,
                                                      device="cuda")).clamp(-1, 1)
    phi = {k: torch.as_tensor(v, device="cuda") for k, v in op.phi_init().items()}
    return op, gcfg, x0.contiguous(), y.contiguous(), phi


def phi_close(got, want, start, what):
    """K5's bar (tests/test_torch_kernels_cuda.py): each phi within 1e-5 of
    the largest step the eager loop took, or one fp32 spacing of phi."""
    import torch

    worst = 0.0
    for k in want:
        step = (want[k] - start[k]).abs().max().item()
        err = (got[k] - want[k]).abs().max().item()
        spacing = torch.finfo(torch.float32).eps * want[k].abs().max().item() if step else 0.0
        if not err <= max(1e-5 * step, spacing):
            raise AssertionError(f"{what}: {k} off by {err:.3g} against a step of {step:.3g}")
        worst = max(worst, err)
    return worst


def eager_phi_fit(op, gcfg, x0, y, phi, n):
    """The eager loop K5 replaces (``osmosis_guided``'s phi-only iterations,
    each image's loss its own): ``torch.autograd.grad`` of the guidance loss,
    then the SGD update; K5's library twin."""
    import torch

    from osmosis_tpu_torch.diffusion.guided import _make_weight_fn
    from osmosis_tpu_torch.guidance.phi_optim import make_phi_optimizer

    opt = make_phi_optimizer(op.optimizer, op.etas())
    weight = _make_weight_fn(gcfg)
    for _ in range(n):
        leaves = {k: v.detach().requires_grad_(True) for k, v in phi.items()}
        with torch.enable_grad():
            diff = ((y - (2.0 * op.forward(leaves, x0) - 1.0)) * weight(x0)).float()
            loss = torch.sqrt(torch.sum(diff ** 2, dim=(1, 2, 3))).sum()
            gs = torch.autograd.grad(loss, list(leaves.values()))
        phi, _ = opt.update(phi, dict(zip(leaves, gs)), {})
    return phi


def check_phi_fit_kernel(cfg, report):
    """K5 at the hybrid preset's settings, 256x256, 19 passes (a step's
    phi-only iterations), batch 1 and 4, with the Fit the guided loop's
    route gives: against its plain version (the closed form in PyTorch, on
    the card) and the eager autograd loop it replaces; timed on the device
    (ten calls a CUDA graph, replayed) and eagerly, beside its byte bound
    and the eager loop's time a step (CUDA events over back-to-back calls)."""
    import torch

    from osmosis_tpu_torch.diffusion.guided import _k5_route
    from osmosis_tpu_torch.ops import phi_fit as K5
    from osmosis_tpu_torch.utils.timing import cuda_time_ms, graph_time_ms

    n = int(cfg["sample_pattern"]["n_iter"]) - 1
    if cfg["conditioning"]["params"]["loss_function"] != "norm":
        raise AssertionError("K5's library twin here is the norm's eager loop")
    out = {}
    for batch in (1, FLEET):
        op, gcfg, x0, y, phi = _phi_fit_inputs(cfg, batch)
        fit = _k5_route(op, phi, x0, y, gcfg, None, True, None)
        if fit is None:
            raise AssertionError("K5 does not take the hybrid preset's phi fit")
        got = K5.phi_fit(x0, y, phi, fit, n)
        ref = K5.phi_fit_plain(x0, y, phi, fit, n)
        lib = eager_phi_fit(op, gcfg, x0, y, phi, n)
        torch.cuda.synchronize()
        err = phi_close(got, ref, phi, f"K5 against its plain version, batch {batch}")
        err_lib = phi_close(got, lib, phi, f"K5 against the eager loop, batch {batch}")
        t_k = graph_time_ms(lambda: K5.phi_fit(x0, y, phi, fit, n))
        t_e = cuda_time_ms(lambda: K5.phi_fit(x0, y, phi, fit, n))
        t_p = cuda_time_ms(lambda: K5.phi_fit_plain(x0, y, phi, fit, n))
        t_l = cuda_time_ms(lambda: eager_phi_fit(op, gcfg, x0, y, phi, n))
        bound = (x0.numel() + y.numel()) * 4 / HBM_BYTES_PER_S * 1e3
        g = K5.plan(256 * 256)
        out[f"b{batch}"] = dict(passes=n, max_abs_err=err, library_max_abs_err=err_lib, ms=t_k,
                                eager_ms=t_e, plain_ms=t_p, library_ms=t_l, bound_ms=bound,
                                cluster=g.cluster, px=g.px, cached=g.cached)
        log(f"  phi_fit (K5) batch {batch}, {n} passes at 256x256: err {err:.2e} (eager loop "
            f"{err_lib:.2e}) kernel {t_k * 1e3:.1f} us (eager call {t_e * 1e3:.1f}) plain "
            f"{t_p * 1e3:.1f} eager loop {t_l * 1e3:.1f} bound {bound * 1e3:.2f} (bytes); "
            f"clusters of {g.cluster} CTAs, {g.px} pixels each")
    report["phi_fit"] = out
    return out


def check_phi_fit_segment(model, cfg, n_steps=8):
    """One segment of the hybrid preset at batch 1 on the bf16 torso (phi
    unfrozen, cuDNN deterministic, clip_denoised): ``phi_fit.launches`` one a
    step with phi-only iterations, and its phi against the eager twin's (K5
    barred). At the first step both fit the same x0-hat, so phi meets K5's
    bar there. After it an update whose last rounding went the other way
    moves x, and the bf16 torso rounds the next x0-hat elsewhere, so the
    segment's last phi is held within 1e-3 of its step (7.2e-5 on an H100,
    PERF.md)."""
    import torch

    from osmosis_tpu_torch.diffusion import guided as G
    from osmosis_tpu_torch.diffusion.sampler import SamplerConfig
    from osmosis_tpu_torch.diffusion.schedules import make_schedule
    from osmosis_tpu_torch.utils import profiling

    op, _, _, y, phi0 = _phi_fit_inputs(cfg, 1, seed=5)
    pattern = dict(cfg["sample_pattern"], update_start=1.0)
    gcfg = G.GuidanceConfig.from_config("osmosis", cfg["conditioning"]["params"], pattern,
                                        cfg["aux_loss"])
    x = torch.randn((1, 256, 256, 4), generator=torch.Generator(device="cuda").manual_seed(6),
                    device="cuda")
    sch = make_schedule("linear", 1000, f"ddim{n_steps}")
    names = ("guided.phi_fits", "guided.phi_fits_k5", "phi_fit.launches")

    def segment():
        before = profiling.counters()
        res = G.guided_sample_loop(model, sch, x, y, op, gcfg, SamplerConfig(clip_denoised=True),
                                   sample_pattern=pattern, seed=0)
        torch.cuda.synchronize()
        after = profiling.counters()
        return res, {k: after[k] - before[k] for k in names}

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        res, counts = segment()
        route = G._k5_route
        G._k5_route = lambda *a: None  # K5 barred: the eager twin
        try:
            twin, twin_counts = segment()
        finally:
            G._k5_route = route
    finally:
        torch.backends.cudnn.deterministic = before
    log(f"  hybrid segment at batch 1 ({n_steps} steps): K5 {counts}, its eager twin "
        f"{twin_counts}")
    if not counts["guided.phi_fits"] == counts["guided.phi_fits_k5"] == counts[
            "phi_fit.launches"] == n_steps:
        raise AssertionError(f"the hybrid segment did not run K5 at every step: {counts}")
    if twin_counts["guided.phi_fits_k5"] or twin_counts["phi_fit.launches"]:
        raise AssertionError(f"the eager twin ran K5: {twin_counts}")
    first = phi_close({k: v[0] for k, v in res.phi_trace.items()},
                      {k: v[0] for k, v in twin.phi_trace.items()}, phi0,
                      "the first step's phi against the eager twin's")
    last = {}
    for k, v in res.phi_trace.items():
        step = (twin.phi_trace[k][-1] - phi0[k]).abs().max().item()
        last[k] = ((v[-1] - twin.phi_trace[k][-1]).abs().max().item(), step)
        if not last[k][0] <= 1e-3 * step:
            raise AssertionError(f"the segment's last {k} off by {last[k][0]:.3g} against a "
                                 f"step of {step:.3g}")
    log(f"  phi against the eager twin's: first step max err {first:.3g}; after {n_steps} steps "
        + ", ".join(f"{k} {e:.3g} of a step of {st:.3g}" for k, (e, st) in last.items()))
    return dict(counts=counts, twin_counts=twin_counts, first_step_max_abs_err=first,
                last_step_err_and_step=last)


def site_class(h):
    return "<=32x32" if h <= 32 else "64x64-128x128" if h <= 128 else "256x256"


# ---------------------------------------------------------------------------
# phase 4: tiny UNet, card (kernels) against CPU (plain versions)
# ---------------------------------------------------------------------------

def randomize_zero_inits(model, seed, std=0.02):
    """Add std * N(0, 1) to every all-zero parameter: the zero-initialized
    output convs (and the GroupNorm biases), so that they carry signal."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if not p.detach().cpu().any():
                p.add_(std * torch.randn(p.shape, generator=gen).to(p.device))
    return model


def check_tiny_unet():
    import torch

    from osmosis_tpu_torch.models.convert import init_unet
    from osmosis_tpu_torch.models.unet import UNetConfig

    cfg = UNetConfig(image_size=32, model_channels=64, num_res_blocks=1,
                     attention_resolutions=(4,), channel_mult=(1, 2, 2), num_heads=4,
                     num_head_channels=16)
    cpu = randomize_zero_inits(init_unet(cfg, seed=1), seed=2).requires_grad_(False)
    cpu = cpu.to(memory_format=torch.channels_last)
    gpu = init_unet(cfg, seed=1)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.requires_grad_(False).to(device="cuda", memory_format=torch.channels_last)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 32, 32, 4, generator=gen)
    t = torch.tensor([17.0, 433.0])
    g = torch.randn(2, 32, 32, 8, generator=gen)
    outs = []
    before = tuple(read_counts()[k] for k in UNET_KERNELS)
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        xd = x.to(dev).requires_grad_(True)
        y = model(xd, t.to(dev))
        (dx,) = torch.autograd.grad(y, xd, g.to(dev))
        outs.append((y.detach().cpu(), dx.cpu()))
    after = tuple(read_counts()[k] for k in UNET_KERNELS)
    if not all(a > b for a, b in zip(after, before)):
        raise AssertionError(f"tiny UNet on the card did not launch every kernel: {before} -> {after}")
    errs = []
    for what, a, b in (("forward", outs[1][0], outs[0][0]), ("x-VJP", outs[1][1], outs[0][1])):
        err = (a - b).abs().max().item()
        if not torch.allclose(a, b, rtol=1e-3, atol=5e-4):
            raise AssertionError(f"tiny UNet {what}: card vs CPU max abs err {err:.3e}")
        errs.append(err)
    log(f"  tiny UNet card vs CPU (rtol 1e-3, atol 5e-4): forward {errs[0]:.2e}, "
        f"x-VJP {errs[1]:.2e}")
    return dict(forward_err=errs[0], vjp_err=errs[1])


# ---------------------------------------------------------------------------
# shared by the full-width phases
# ---------------------------------------------------------------------------

UNET_KERNELS = ("upsample_nearest_2x", "box_sum_2x", "group_norm_forward", "group_norm_backward")
KERNELS = UNET_KERNELS + ("phi_fit",)  # K1-K4 in the UNet, K5 in the guided step's phi fit


def phi_fit_steps(T, last=None):
    """K5's launches in one chain of the osmosis presets (their pcgs pattern
    and n_iter) over ``T`` respaced steps that runs its ``last`` steps (all
    T by default): one at each step with phi-only passes, whatever the
    batch."""
    import numpy as np

    from osmosis_tpu_torch.config import load_yaml
    from osmosis_tpu_torch.guidance.schedule_masks import pattern_masks

    pattern = load_yaml(os.path.join(ROOT, "configs", "osmosis_sample_config.yaml"))[
        "sample_pattern"]
    masks = pattern_masks(pattern, T)
    n_inner = masks["phi_warmup"] + np.where(masks["freeze_phi"], 0, int(pattern["n_iter"]) - 1)
    return int((n_inner[:T if last is None else last] > 0).sum())  # the chain ends at t = 0


def counters():
    from osmosis_tpu_torch.utils import profiling

    return profiling.counters()


def zero_counts():
    from osmosis_tpu_torch.utils import profiling

    profiling.reset_counters(*(f"{k}.launches" for k in KERNELS),
                             "group_norm_forward.kernel_launches",
                             "group_norm_backward.kernel_launches")


def read_counts():
    c = counters()
    return {name: c[f"{name}.launches"] for name in KERNELS}


def check_counts(what, got, expected):
    for name, n in expected.items():
        if got[name] != n:
            raise AssertionError(f"{what}: {name} launched {got[name]} times, expected {n}")


def write_preset(workdir, preset, checkpoint, name=None, data=None, top=None, **diffusion):
    """A preset with the seeded random-init checkpoint, one image of
    data/underwater (or the ``data`` section's changes) and the run dir under
    ``workdir`` (or ``top``'s ``save_dir``), ``top``'s top-level keys set;
    written as ``name``; returns (path, config)."""
    import yaml

    from osmosis_tpu_torch.config import load_yaml

    cfg = load_yaml(os.path.join(ROOT, "configs", preset))
    cfg["unet_model"]["model_path"] = checkpoint
    if "data" in cfg:
        cfg["data"]["root"] = os.path.join(ROOT, "data", "underwater")
        cfg["data"]["stop_after"] = 1
        cfg["data"].update(data or {})
    cfg["diffusion"].update(diffusion)
    cfg["save_dir"] = os.path.join(workdir, "results")
    cfg.update(top or {})
    path = os.path.join(workdir, name or preset)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg


def check_run_dir(out, files):
    for rel in files:
        if not os.path.exists(os.path.join(out, rel)):
            raise AssertionError(f"run dir {out} lacks {rel}")
    with open(os.path.join(out, "progress.json")) as f:
        return json.loads(f.readline())


def time_unet(model, x, tt, peak_flops, what):
    """A UNet forward and forward + x-pullback at (x, tt): the time per call by
    CUDA events over back-to-back calls (what the guided loop sees; where the
    host launches slower than the card runs, the host's time), the device's
    kernel time from ``torch.profiler``, and the work, counted by PyTorch from
    the shapes of the convolutions and matrix products that ran."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from osmosis_tpu_torch.tools.unet_profile import profile_pass
    from osmosis_tpu_torch.utils.timing import cuda_time_ms

    x = x.detach().requires_grad_(True)
    y = model(x, tt)
    (dx,) = torch.autograd.grad(y[..., :4], x, torch.ones_like(y[..., :4]))
    if not (torch.isfinite(y).all() and torch.isfinite(dx).all()):
        raise AssertionError(f"{what}: the UNet output or pullback is not finite")

    def fwd_bwd():
        yy = model(x, tt)
        torch.autograd.grad(yy[..., :4], x, torch.ones_like(yy[..., :4]))

    with FlopCounterMode(display=False) as fc:
        yy = model(x, tt)
    fwd_flop = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(yy[..., :4], x, torch.ones_like(yy[..., :4]))
    bwd_flop = fc.get_total_flops()
    out = dict(unet_fwd_flop=fwd_flop, unet_pullback_flop=bwd_flop)
    for key, label, fn, work in (("unet_fwd", "forward", lambda: model(x, tt), fwd_flop),
                                 ("unet_fwd_pullback", "forward + pullback", fwd_bwd,
                                  fwd_flop + bwd_flop)):
        ms = cuda_time_ms(fn, iters=5)
        dev_ms, _, host = profile_pass(fn)
        out.update({f"{key}_ms": ms, f"{key}_device_ms": dev_ms,
                    f"{key}_host_ms_profiled": sum(host.values())})
        log(f"  {what}, {label}: {ms:.1f} ms a call by CUDA events ({work / ms / 1e9:.1f} TFLOP/s), {dev_ms:.1f} ms "
            f"of device kernels ({work / dev_ms / 1e9:.1f} TFLOP/s, peak {peak_flops / 1e12:.0f}); "
            f"host {sum(host.values()):.1f} ms a call with the profiler on")
    log(f"  {what}: UNet output {tuple(y.shape)} and pullback finite; work forward "
        f"{fwd_flop / 1e12:.3f} TFLOP, x-pullback {bwd_flop / 1e12:.3f} TFLOP")
    return out


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

RESTORE_FILES = ("configurations.txt", "log.txt", "progress.json",
                 *(os.path.join("single_images", d, "uw_0.png")
                   for d in ("input", "rgb", "depth_color", "depth_raw")))


def run_main_path(workdir):
    import torch

    from osmosis_tpu_torch.config import load_yaml
    from osmosis_tpu_torch.models.unet import unet_config_from_yaml
    from osmosis_tpu_torch.pipelines.restore import run_restoration
    from osmosis_tpu_torch.tools.runbook_rehearsal import seeded_checkpoint

    cfg_yaml = load_yaml(os.path.join(ROOT, "configs", "osmosis_sample_config.yaml"))
    ucfg = unet_config_from_yaml(cfg_yaml["unet_model"])
    t0 = time.perf_counter()
    pt = os.path.join(workdir, "random_init.pt")
    n_params = seeded_checkpoint(pt)
    log(f"  seeded random-init checkpoint: {n_params / 1e6:.1f}M params, "
        f"{time.perf_counter() - t0:.1f} s")

    cfg_path, cfg_yaml = write_preset(workdir, "osmosis_sample_config.yaml", pt,
                                      timestep_respacing=STEPS)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = run_restoration(cfg_path, device="cuda:0")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    gn_kernels = {k: counters()[f"{k}.kernel_launches"]
                  for k in ("group_norm_forward", "group_norm_backward")}
    peak = torch.cuda.max_memory_allocated()
    log(f"  run_restoration: {wall:.1f} s, run dir {out}")
    log(f"  launches on the main path: {launches}; GroupNorm device kernels: {gn_kernels}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")
    row = check_run_dir(out, RESTORE_FILES)
    log(f"  chain_finite: {row['chain_finite']} (random weights at guidance scale 7 may "
        f"diverge), final_loss {row['final_loss']}, chain {row['sample_seconds']:.2f} s")

    # the first step's UNet forward and pullback, at the chain's x_start and t
    from osmosis_tpu_torch.diffusion.schedules import make_schedule
    from osmosis_tpu_torch.models.convert import load_unet

    model = load_unet(pt, ucfg, "cuda")
    t_first = float(make_schedule("linear", 1000, STEPS).model_timesteps()[-1])
    gen = torch.Generator(device="cuda").manual_seed(cfg_yaml["manual_seed"])
    x = torch.randn((1, 256, 256, 4), generator=gen, device="cuda")
    unet = time_unet(model, x, torch.full((1,), t_first, device="cuda"), FP32_FLOPS,
                     "first step, fp32 (TF32 off)")
    return dict(launches=launches, gn_kernel_launches=gn_kernels, peak_bytes=peak, wall_s=wall,
                run=row, seconds_per_step=row["sample_seconds"] / STEPS, n_params=n_params,
                checkpoint=pt, **unet)


def time_guided_steps(workdir, n_steps=5):
    """Seconds per guided step, warm: a short chain at full width on the
    preset's settings, after the main path has compiled every kernel."""
    import torch

    from osmosis_tpu_torch.config import load_yaml
    from osmosis_tpu_torch.diffusion.guided import GuidanceConfig, guided_sample_loop
    from osmosis_tpu_torch.diffusion.sampler import SamplerConfig
    from osmosis_tpu_torch.diffusion.schedules import make_schedule
    from osmosis_tpu_torch.guidance.operators import get_operator
    from osmosis_tpu_torch.models.convert import load_unet
    from osmosis_tpu_torch.models.unet import unet_config_from_yaml

    cfg = load_yaml(os.path.join(ROOT, "configs", "osmosis_sample_config.yaml"))
    model = load_unet(os.path.join(workdir, "random_init.pt"),
                      unet_config_from_yaml(cfg["unet_model"]), "cuda")
    op_kw = {k: v for k, v in cfg["measurement"]["operator"].items() if k != "name"}
    op = get_operator(cfg["measurement"]["operator"]["name"], batch_size=1, **op_kw)
    gcfg = GuidanceConfig.from_config("osmosis", cfg["conditioning"]["params"],
                                      cfg["sample_pattern"], cfg["aux_loss"])
    # phi unfrozen at every step, so each one runs the full 19-iteration loop
    pattern = dict(cfg["sample_pattern"], update_start=1.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, 256, 256, 4), generator=gen, device="cuda")
    y = torch.rand((1, 256, 256, 3), generator=gen, device="cuda") * 2 - 1
    sch = make_schedule("linear", 1000, str(n_steps))

    def chain():
        return guided_sample_loop(model, sch, x, y, op, gcfg, SamplerConfig(),
                                  sample_pattern=pattern, seed=0)

    chain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain()
    torch.cuda.synchronize()
    s = (time.perf_counter() - t0) / n_steps
    log(f"  warm guided step (n_iter {gcfg.n_iter}, phi updated every step): {s * 1e3:.1f} ms")
    return s, device_busy_share(chain, n_steps)


def device_busy_share(chain, n_steps, what="warm guided steps"):
    """Kernel time on the device over the wall time of one warm chain of
    ``n_steps`` guided steps, from torch.profiler (the profiler's own cost is
    in the wall time). None where the profiler shows no CUDA time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain()
    torch.cuda.synchronize()
    wall_off = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us, gn_us = 0.0, 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
            dev_us += us
            gn_us += us if "gn_kernel" in e.key else 0.0
    if dev_us <= 0:
        log(f"  device busy share over {what}: not measured (no CUDA time in the profile)")
        return None
    # the union of the device's activity intervals: kernels that overlap (on
    # other streams) count once, so this share cannot pass 1
    dev = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    union_us, end = 0.0, -math.inf
    for t0_us, t1_us in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if t1_us > end:
            union_us += t1_us - max(t0_us, end)
            end = t1_us
    streams = len({getattr(e, "device_resource_id", 0) for e in dev})
    share = dev_us / 1e6 / wall
    log(f"  device busy share over {n_steps} {what} (torch.profiler): {share:.3f} "
        f"({dev_us / 1e3 / n_steps:.1f} ms of kernels per step over {wall * 1e3 / n_steps:.1f} "
        f"ms wall, profiler on); GroupNorm kernels {gn_us / 1e3 / n_steps:.2f} ms per step; "
        f"the same kernel time over the unprofiled wall of {wall_off * 1e3 / n_steps:.1f} ms "
        f"a step: {dev_us / 1e6 / wall_off:.3f}; the device active (union of its intervals, "
        f"{streams} stream(s)) {union_us / 1e3 / n_steps:.1f} ms per step, "
        f"{union_us / 1e6 / wall:.3f} of the profiled wall")
    return dict(busy_share=share, device_ms_per_step=dev_us / 1e3 / n_steps,
                wall_ms_per_step=wall * 1e3 / n_steps, gn_ms_per_step=gn_us / 1e3 / n_steps,
                unprofiled_wall_ms_per_step=wall_off * 1e3 / n_steps,
                busy_share_unprofiled_wall=dev_us / 1e6 / wall_off,
                active_ms_per_step=union_us / 1e3 / n_steps,
                active_share=union_us / 1e6 / wall, streams=streams)


# ---------------------------------------------------------------------------
# phases 6-7: the bf16 fast path (the hybrid preset) at full width
# ---------------------------------------------------------------------------

def run_bf16_hybrid(workdir, checkpoint, gn_sites, ups, pools):
    """The hybrid preset (bf16 torso, x_prev every k-th step, x0 between)
    through ``run_restoration`` with ddim20, launch counts asserted per step
    kind. Returns the phase's numbers and the model ``run_restoration`` loaded."""
    import torch

    import osmosis_tpu_torch.models.preset as MP
    import osmosis_tpu_torch.pipelines.restore as R

    path, cfg = write_preset(workdir, "osmosis_sample_hybrid_config.yaml", checkpoint,
                             timestep_respacing=f"ddim{STEPS}")
    k = int(cfg["conditioning"]["params"]["x_prev_every"])
    full = len(range(0, STEPS, k))  # x_prev steps: chain positions 0, k, 2k, ...
    loaded = []
    load_unet = MP.load_unet  # the preset's loader, which run_restoration calls
    MP.load_unet = lambda *a, **kw: loaded.append(load_unet(*a, **kw)) or loaded[-1]
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        out = R.run_restoration(path, device="cuda:0")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        MP.load_unet = load_unet
    peak = torch.cuda.max_memory_allocated()
    expected = {"group_norm_forward": len(gn_sites) * STEPS,
                "group_norm_backward": len(gn_sites) * full,
                "upsample_nearest_2x": len(ups) * STEPS + len(pools) * full,
                "box_sum_2x": len(pools) * STEPS + len(ups) * full, "phi_fit": phi_fit_steps(STEPS)}
    log(f"  run_restoration: {wall:.1f} s; {STEPS} steps, {full} of them x_prev (k = {k}); "
        f"launches {launches}")
    check_counts("bf16 hybrid path", launches, expected)
    model = loaded[0]
    conv_dtype = model.input_blocks[0][0].weight.dtype
    gn_dtype = model.out[0].weight.dtype
    log(f"  loaded torso: conv weights {conv_dtype}, GroupNorm affines {gn_dtype}, "
        f"output conv weights {model.out[2].weight.dtype} (computed in fp32)")
    if conv_dtype != torch.bfloat16 or gn_dtype != torch.float32:
        raise AssertionError("the hybrid preset did not load a bf16 torso with fp32 GroupNorm")
    row = check_run_dir(out, RESTORE_FILES)
    log(f"  chain_finite: {row['chain_finite']}, final_loss {row['final_loss']}, chain "
        f"{row['sample_seconds']:.2f} s ({row['sample_seconds'] / STEPS * 1e3:.1f} ms a step); "
        f"peak memory {peak / 2 ** 30:.2f} GiB")
    return dict(launches=launches, expected=expected, k=k, full_steps=full, wall_s=wall,
                run=row, peak_bytes=peak, seconds_per_step=row["sample_seconds"] / STEPS,
                conv_dtype=str(conv_dtype), gn_dtype=str(gn_dtype)), model, cfg


def time_bf16_steps(model, cfg, n_steps=4):
    """Seconds per warm bf16 guided step, an x_prev chain and an x0 chain of
    ``n_steps`` each, phi updated at every step; then the device's busy share
    over a warm hybrid chain of 2k steps, and the bf16 UNet forward and
    forward + pullback."""
    import torch

    from osmosis_tpu_torch.diffusion.guided import GuidanceConfig, guided_sample_loop
    from osmosis_tpu_torch.diffusion.sampler import SamplerConfig
    from osmosis_tpu_torch.diffusion.schedules import make_schedule
    from osmosis_tpu_torch.guidance.operators import get_operator

    op_kw = {k: v for k, v in cfg["measurement"]["operator"].items() if k != "name"}
    op = get_operator(cfg["measurement"]["operator"]["name"], batch_size=1, **op_kw)
    pattern = dict(cfg["sample_pattern"], update_start=1.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, 256, 256, 4), generator=gen, device="cuda")
    y = torch.rand((1, 256, 256, 3), generator=gen, device="cuda") * 2 - 1
    params = cfg["conditioning"]["params"]

    def make_chain(n, **change):
        gcfg = GuidanceConfig.from_config("osmosis", dict(params, **change), pattern,
                                          cfg["aux_loss"])
        sch = make_schedule("linear", 1000, str(n))
        return lambda: guided_sample_loop(model, sch, x, y, op, gcfg, SamplerConfig(),
                                          sample_pattern=pattern, seed=0)

    out = {}
    for kind, change in (("x_prev", dict(x_prev_every=1)),
                         ("x0", dict(x_prev_every=1, gradient_x_prev=False))):
        chain = make_chain(n_steps, **change)
        chain()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain()
        torch.cuda.synchronize()
        out[f"{kind}_seconds_per_step"] = (time.perf_counter() - t0) / n_steps
        log(f"  warm bf16 {kind} step (n_iter {params.get('n_iter', pattern['n_iter'])}, phi "
            f"updated every step): {out[f'{kind}_seconds_per_step'] * 1e3:.1f} ms")
    k = int(params["x_prev_every"])
    hybrid = make_chain(2 * k)
    hybrid()
    out["busy"] = device_busy_share(hybrid, 2 * k, f"warm bf16 hybrid steps (k = {k})")
    t_first = float(make_schedule("linear", 1000, STEPS).model_timesteps()[-1])
    out.update(time_unet(model, x, torch.full((1,), t_first, device="cuda"), BF16_FLOPS,
                         "bf16 torso"))
    return out


# ---------------------------------------------------------------------------
# phase 8: the RGBD prior sampler; phase 9: rgb_guidance
# ---------------------------------------------------------------------------

def run_prior(workdir, checkpoint, gn_sites, ups, pools, steps=20):
    """RGBD_sample_config.yaml through ``run_prior_sampling`` at full width,
    fp32, one image, the last ``steps`` steps: forwards only, so no K4."""
    import yaml

    from osmosis_tpu_torch.pipelines.prior import run_prior_sampling

    path, cfg = write_preset(workdir, "RGBD_sample_config.yaml", checkpoint,
                             timestep_respacing=steps)
    cfg["number_of_images"] = 1
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    zero_counts()
    t0 = time.perf_counter()
    out = run_prior_sampling(path, device="cuda:0")
    wall = time.perf_counter() - t0
    launches = read_counts()
    log(f"  run_prior_sampling: {wall:.1f} s; launches {launches}")
    check_counts("prior sampler", launches, {
        "group_norm_forward": len(gn_sites) * steps, "group_norm_backward": 0,
        "upsample_nearest_2x": len(ups) * steps, "box_sum_2x": len(pools) * steps,
        "phi_fit": 0})
    row = check_run_dir(out, ("configurations.txt", "log.txt", "progress.json",
                              "single_images/rgb/image_0.png",
                              "single_images/depth_color/image_0.png",
                              "grid_results/image_0.png", "grid_results/image_0_process.png"))
    s = row["sample_seconds"] / steps
    log(f"  prior: {steps} steps in {row['sample_seconds']:.2f} s, {s * 1e3:.1f} ms a step "
        f"(fp32, TF32 off, forward only); sample finite: {row['sample_finite']}")
    return dict(launches=launches, wall_s=wall, run=row, seconds_per_step=s)


def run_rgb_guidance(workdir, checkpoint, gn_sites, ups, pools, steps=10):
    """rgb_guidance_sample_config.yaml ('ps', fp32) through ``run_restoration``:
    one image of data/underwater, ``steps`` steps, the UNet pullback at each."""
    from osmosis_tpu_torch.pipelines.restore import run_restoration

    path, _ = write_preset(workdir, "rgb_guidance_sample_config.yaml", checkpoint,
                           timestep_respacing=steps)
    zero_counts()
    t0 = time.perf_counter()
    out = run_restoration(path, device="cuda:0")
    wall = time.perf_counter() - t0
    launches = read_counts()
    log(f"  run_restoration (rgb_guidance): {wall:.1f} s; launches {launches}")
    check_counts("rgb_guidance", launches, {
        "group_norm_forward": len(gn_sites) * steps, "group_norm_backward": len(gn_sites) * steps,
        "upsample_nearest_2x": (len(ups) + len(pools)) * steps,
        "box_sum_2x": (len(ups) + len(pools)) * steps, "phi_fit": 0})
    row = check_run_dir(out, RESTORE_FILES + ("grid_results/uw_0.png",
                                              "grid_results/uw_0_process.png"))
    log(f"  rgb_guidance run dir complete; chain_finite {row['chain_finite']}, "
        f"{row['sample_seconds'] / steps * 1e3:.1f} ms a step")
    return dict(launches=launches, wall_s=wall, run=row,
                seconds_per_step=row["sample_seconds"] / steps)


# ---------------------------------------------------------------------------
# phase 10: the haze and simulation presets
# ---------------------------------------------------------------------------

def write_images(root, n, seed, prefix, size=(256, 320)):
    """``n`` seeded RGB PNGs: smooth colour fields plus noise, ``prefix_i.png``."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    yy, xx = np.mgrid[0:size[0], 0:size[1]] / max(size)
    for i in range(n):
        base = np.stack([np.sin(2 * np.pi * (rng.uniform(0.5, 2) * xx + rng.uniform(0, 1)
                                             * yy + rng.uniform())) for _ in range(3)], -1)
        img = 0.5 + 0.35 * base + 0.1 * rng.standard_normal(base.shape)
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(root, f"{prefix}_{i}.png"))


def write_depth(root, n, seed, prefix, size=(256, 320)):
    """``n`` seeded uint16 depth PNGs (a ramp plus noise), as NYUv2's GT is stored."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    ramp = np.linspace(0.1, 0.9, size[0])[:, None] * np.ones(size)
    for i in range(n):
        d = np.clip(ramp + 0.05 * rng.standard_normal(size), 0, 1)
        Image.fromarray((d * 65535).astype(np.uint16)).save(
            os.path.join(root, f"{prefix}_{i}.png"))


def preset_counts(gn_sites, ups, pools, steps, full_steps, phi_fits):
    """Launches of a run: K3 and the forward resampling at every step, K4 and
    the backward resampling at the ``full_steps`` x_prev steps, K5 at the
    ``phi_fits`` steps with phi-only passes."""
    return {"group_norm_forward": len(gn_sites) * steps,
            "group_norm_backward": len(gn_sites) * full_steps,
            "upsample_nearest_2x": len(ups) * steps + len(pools) * full_steps,
            "box_sum_2x": len(pools) * steps + len(ups) * full_steps, "phi_fit": phi_fits}


def run_counted(path, what, expected, **kw):
    """``run_restoration`` on ``path`` with the launch counts zeroed before
    and asserted after; returns (run dir, wall seconds, counts, peak bytes)."""
    import torch

    from osmosis_tpu_torch.pipelines.restore import run_restoration

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = run_restoration(path, device="cuda:0", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    check_counts(what, launches, expected)
    return out, wall, launches, torch.cuda.max_memory_allocated()


def run_haze_and_simulation(workdir, checkpoint, gn_sites, ups, pools):
    """osmosis_haze_sample_config.yaml (haze_physical, degamma) and
    osmosis_simulation_sample_config.yaml (underwater_physical, GT grids)
    through ``run_restoration`` at full width, fp32, STEPS steps, one seeded
    image each (with seeded GT RGB and uint16 depth for the simulation)."""
    import numpy as np
    from PIL import Image

    out = {}
    write_images(os.path.join(workdir, "haze"), 1, 10, "haze")
    sim = os.path.join(workdir, "simulation")
    write_images(os.path.join(sim, "input"), 1, 11, "sim")
    write_images(os.path.join(sim, "gt_rgb"), 1, 12, "sim")
    write_depth(os.path.join(sim, "gt_depth"), 1, 13, "sim")
    for key, preset, data, img in (
            ("haze", "osmosis_haze_sample_config.yaml",
             dict(root=os.path.join(workdir, "haze")), "haze_0"),
            ("simulation", "osmosis_simulation_sample_config.yaml",
             dict(root=os.path.join(sim, "input"), gt_rgb=os.path.join(sim, "gt_rgb"),
                  gt_depth=os.path.join(sim, "gt_depth")), "sim_0")):
        path, cfg = write_preset(workdir, preset, checkpoint, data=data,
                                 timestep_respacing=STEPS)
        rd, wall, launches, peak = run_counted(
            path, key, preset_counts(gn_sites, ups, pools, STEPS, STEPS, phi_fit_steps(STEPS)))
        files = [os.path.join("single_images", d, f"{img}.png")
                 for d in ("input", "rgb", "depth_color", "depth_raw")]
        files += [f"grid_results/{img}_g0_grid.png", f"grid_results/{img}_process.png"]
        row = check_run_dir(rd, ("configurations.txt", "log.txt", "progress.json", *files))
        grid = np.asarray(Image.open(os.path.join(rd, "grid_results", f"{img}_g0_grid.png")))
        rows = 2 if cfg["data"]["ground_truth"] else 1  # outputs, then the GT row
        if (grid.shape[0] > grid.shape[1] / 2) != (rows == 2):
            raise AssertionError(f"{key}: grid {grid.shape} should hold {rows} row(s)")
        with open(os.path.join(rd, "log.txt")) as f:
            if "phase timings:" not in f.read():
                raise AssertionError(f"{key}: no phase summary in the log")
        s = row["sample_seconds"] / STEPS
        log(f"  {key} ({cfg['measurement']['operator']['name']}): {wall:.1f} s, {s * 1e3:.1f} ms "
            f"a step, launches {launches}, grid {grid.shape[:2]} ({rows} row(s)), chain_finite "
            f"{row['chain_finite']}, peak {peak / 2 ** 30:.2f} GiB")
        out[key] = dict(launches=launches, wall_s=wall, run=row, seconds_per_step=s,
                        peak_bytes=peak)
    return out


# ---------------------------------------------------------------------------
# phase 12: the batch-4 fleet at full width
# ---------------------------------------------------------------------------

FLEET = 4
LANE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # of max|batch-1 value|


def run_fleet(workdir, checkpoint, gn_sites, ups, pools, k_hybrid):
    """data.batch_size: 4 with 4 seeded images through ``run_restoration``:
    the fp32 preset (STEPS steps) and the bf16 hybrid preset (ddim STEPS),
    both with clip_denoised. One call per kernel site whatever the batch, so
    the launch counts per step are batch 1's."""
    write_images(os.path.join(workdir, "fleet"), FLEET, 20, "fl")
    data = dict(root=os.path.join(workdir, "fleet"), batch_size=FLEET, stop_after=-1)
    out = {}
    full = len(range(0, STEPS, k_hybrid))
    for key, preset, resp, n_full in (
            ("float32", "osmosis_sample_config.yaml", STEPS, STEPS),
            ("bfloat16", "osmosis_sample_hybrid_config.yaml", f"ddim{STEPS}", full)):
        path, _ = write_preset(workdir, preset, checkpoint, name=f"fleet_{key}.yaml", data=data,
                               timestep_respacing=resp, clip_denoised=True)
        rd, wall, launches, peak = run_counted(
            path, f"fleet {key}", preset_counts(gn_sites, ups, pools, STEPS, n_full,
                                                phi_fit_steps(STEPS)))
        with open(os.path.join(rd, "progress.json")) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        if sorted(r["image"] for r in rows) != [f"fl_{i}.png" for i in range(FLEET)] or any(
                r["batch"] != FLEET for r in rows):
            raise AssertionError(f"fleet {key}: rows {rows}")
        check_run_dir(rd, [os.path.join("single_images", "rgb", f"fl_{i}.png")
                           for i in range(FLEET)])
        s = rows[0]["sample_seconds"] / STEPS
        log(f"  fleet {key}, batch {FLEET}: {wall:.1f} s, {s * 1e3:.1f} ms a step, "
            f"{s / FLEET * 1e3:.1f} ms an image-step; launches {launches} (batch 1's per step); "
            f"chains finite {[r['chain_finite'] for r in rows]}; peak {peak / 2 ** 30:.2f} GiB")
        out[key] = dict(launches=launches, wall_s=wall, seconds_per_step=s,
                        seconds_per_image_step=s / FLEET, peak_bytes=peak,
                        chain_finite=[r["chain_finite"] for r in rows])
    return out


def check_lane_parity(models):
    """The first guided step's UNet output and x-pullback at batch 4 against
    the batch-1 call of each lane (its own x_t and cotangent), per dtype."""
    import torch

    from osmosis_tpu_torch.diffusion.schedules import make_schedule

    t_first = float(make_schedule("linear", 1000, STEPS).model_timesteps()[-1])
    gen = torch.Generator(device="cuda").manual_seed(30)
    x = torch.randn((FLEET, 256, 256, 4), generator=gen, device="cuda")
    g = torch.randn((FLEET, 256, 256, 4), generator=gen, device="cuda")
    out = {}
    for key, model in models.items():
        def fwd_vjp(xx, gg):
            xx = xx.detach().requires_grad_(True)
            y = model(xx, torch.full((xx.shape[0],), t_first, device="cuda"))
            (dx,) = torch.autograd.grad(y[..., :4], xx, gg)
            return y.detach(), dx

        y4, dx4 = fwd_vjp(x, g)
        errs = dict(unet=0.0, pullback=0.0)
        for j in range(FLEET):
            y1, dx1 = fwd_vjp(x[j:j + 1], g[j:j + 1])
            for what, a, b in (("unet", y4[j:j + 1], y1), ("pullback", dx4[j:j + 1], dx1)):
                err = ((a - b).abs().max() / b.abs().max()).item()
                if not (math.isfinite(err) and err <= LANE_TOL[key]):
                    raise AssertionError(f"lane {j} {key} {what}: batch 4 vs batch 1 "
                                         f"{err:.2e} of max|value| > {LANE_TOL[key]}")
                errs[what] = max(errs[what], err)
        log(f"  lane parity {key}, batch {FLEET} vs batch 1 (first step, t={t_first:.0f}): UNet "
            f"output {errs['unet']:.2e}, pullback {errs['pullback']:.2e} of max|value| "
            f"(limit {LANE_TOL[key]})")
        out[key] = errs
    return out


def kernel_profile(chain, n_steps, top=8):
    """Device time per kernel over one warm chain of ``n_steps`` steps, from
    torch.profiler: the total and the ``top`` largest, in ms and calls per
    step. None where the profiler shows no CUDA time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chain()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
            rows.append((us / 1e3 / n_steps, e.count / n_steps, e.key))
    if not rows:
        return None
    rows.sort(reverse=True)
    return dict(total_ms_per_step=sum(r[0] for r in rows),
                top=[dict(ms_per_step=ms, calls_per_step=c, kernel=k) for ms, c, k in rows[:top]])


def time_fleet(models, cfgs):
    """Seconds per warm step and per image-step at batch 1, 2 and 4 through
    the fleet runner (fp32: x_prev steps; bf16: hybrid chains of 2k steps),
    phi updated at every step; the fp32 step's largest kernels at each batch;
    then the busy share over warm batch-4 steps."""
    import torch

    from osmosis_tpu_torch.diffusion.guided import GuidanceConfig
    from osmosis_tpu_torch.diffusion.sampler import SamplerConfig
    from osmosis_tpu_torch.diffusion.schedules import make_schedule
    from osmosis_tpu_torch.guidance.operators import get_operator
    from osmosis_tpu_torch.parallel.runner import make_batched_guided_runner

    out = {}
    for key, model in models.items():
        cfg = cfgs[key]
        op_kw = {k: v for k, v in cfg["measurement"]["operator"].items() if k != "name"}
        op = get_operator(cfg["measurement"]["operator"]["name"], batch_size=1, **op_kw)
        pattern = dict(cfg["sample_pattern"], update_start=1.0)
        params = cfg["conditioning"]["params"]
        gcfg = GuidanceConfig.from_config("osmosis", params, pattern, cfg["aux_loss"])
        n_steps = 3 if key == "float32" else 2 * int(params.get("x_prev_every", 1))
        run = make_batched_guided_runner(model, make_schedule("linear", 1000, str(n_steps)), op,
                                         gcfg, SamplerConfig(clip_denoised=True),
                                         sample_pattern=pattern)
        gen = torch.Generator(device="cuda").manual_seed(40)
        x1 = torch.randn((1, 256, 256, 4), generator=gen, device="cuda")
        ys = torch.rand((FLEET, 256, 256, 3), generator=gen, device="cuda") * 2 - 1
        rows = {}
        for n in (1, 2, FLEET):
            xs = x1.expand((n, 256, 256, 4)).contiguous()

            def chain(xs=xs, n=n):
                return run(xs, ys[:n], seed=0)

            chain()
            runs = []
            for _ in range(2):  # two warm chains: their spread
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                chain()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) / n_steps)
            rows[n] = dict(seconds_per_step=runs, seconds_per_image_step=[s / n for s in runs])
            log(f"  warm {key} fleet step at batch {n}: "
                + " and ".join(f"{s * 1e3:.1f} ms ({s / n * 1e3:.1f} an image-step)"
                               for s in runs))
            if key == "float32":  # where a step's device time goes, batch by batch
                prof = rows[n]["kernels"] = kernel_profile(chain, n_steps)
                if prof is None:
                    log("    kernels: not measured (no CUDA time in the profile)")
                    continue
                log(f"    kernels, {prof['total_ms_per_step']:.1f} ms a step in all; the largest "
                    "(ms and calls a step):")
                for r in prof["top"]:
                    log(f"      {r['ms_per_step']:8.2f} ms {r['calls_per_step']:6.1f}x "
                        f"{r['kernel'][:110]}")
        busy = device_busy_share(chain, n_steps, f"warm {key} steps at batch {FLEET}")
        out[key] = dict(batches=rows, busy=busy, steps=n_steps)
    return out


# ---------------------------------------------------------------------------
# phases 13-14: segments, crash and resume; restarts, global chains, async save
# ---------------------------------------------------------------------------

def png_bytes(run_dir):
    files = {}
    for d, _, fs in os.walk(run_dir):
        for f in fs:
            if f.endswith(".png"):
                with open(os.path.join(d, f), "rb") as fh:
                    files[os.path.relpath(os.path.join(d, f), run_dir)] = fh.read()
    return files


def run_segments_and_resume(workdir, checkpoint, gn_sites, ups, pools, k_hybrid):
    """The bf16 hybrid preset, ddim STEPS, one image, progress_segments 4:
    two uninterrupted runs without chain_checkpoint (do two runs on this card
    give the same bits? cuDNN may pick nondeterministic algorithms), one with
    it, and one killed after its first boundary save
    (OSMOSIS_TPU_CRASH_AFTER_SEGMENTS) and resumed: its PNGs must equal the
    uninterrupted chain_checkpoint run's byte for byte. Then the fp32 preset
    (ddim STEPS, clip_denoised) with chain_checkpoint, which takes cuDNN's
    deterministic algorithms: uninterrupted, and killed after its first
    boundary and resumed, byte for byte."""
    full = len(range(0, STEPS, k_hybrid))
    counts = preset_counts(gn_sites, ups, pools, STEPS, full, phi_fit_steps(STEPS))
    out, runs = {}, {}
    for key, top in (("plain_a", {}), ("plain_b", {}), ("checkpoint", dict(chain_checkpoint=True))):
        path, _ = write_preset(workdir, "osmosis_sample_hybrid_config.yaml", checkpoint,
                               name=f"seg_{key}.yaml", timestep_respacing=f"ddim{STEPS}",
                               clip_denoised=True, top=dict(
                                   progress_segments=4,
                                   save_dir=os.path.join(workdir, f"seg_{key}"), **top))
        rd, wall, _, _ = run_counted(path, f"segments {key}", counts)
        with open(os.path.join(rd, "log.txt")) as f:
            n_rows = f.read().count("  progress ")
        if n_rows != 5:  # segments of 4 steps: 5 rows for 20 steps
            raise AssertionError(f"segments {key}: {n_rows} progress rows, expected 5")
        runs[key] = png_bytes(rd)
        out[key + "_seconds_per_step"] = check_run_dir(rd, ())["sample_seconds"] / STEPS
    same_plain = runs["plain_a"] == runs["plain_b"]
    ms = {k: out[k + "_seconds_per_step"] * 1e3 for k in runs}
    log(f"  two uninterrupted runs without chain_checkpoint give "
        f"{'the same' if same_plain else 'DIFFERENT'} PNG bytes; with chain_checkpoint the "
        f"same as them: {runs['checkpoint'] == runs['plain_a']}; ms a step: plain "
        f"{ms['plain_a']:.1f} / {ms['plain_b']:.1f}, chain_checkpoint {ms['checkpoint']:.1f}")

    resumed = crash_then_resume(workdir, "osmosis_sample_hybrid_config.yaml", "seg", checkpoint,
                                preset_counts(gn_sites, ups, pools, STEPS - 4, full - 1,
                                              phi_fit_steps(STEPS, STEPS - 4)),
                                runs["checkpoint"], 4, "cuDNN default")
    log(f"  bf16: crash after the first boundary, resume from step 4/{STEPS}: the {len(resumed)} "
        "PNGs equal the uninterrupted run's byte for byte")

    # fp32: the chain_checkpoint run takes cuDNN's deterministic algorithms,
    # without which its pullback gives other bits from call to call
    path, _ = write_preset(workdir, "osmosis_sample_config.yaml", checkpoint,
                           name="seg32_checkpoint.yaml", sampler="ddim",
                           timestep_respacing=f"ddim{STEPS}", clip_denoised=True, top=dict(
                               progress_segments=4, chain_checkpoint=True,
                               save_dir=os.path.join(workdir, "seg32_checkpoint")))
    rd, _, _, _ = run_counted(path, "fp32 chain_checkpoint",
                              preset_counts(gn_sites, ups, pools, STEPS, STEPS,
                                            phi_fit_steps(STEPS)))
    fp32 = png_bytes(rd)
    out["fp32_checkpoint_seconds_per_step"] = check_run_dir(rd, ())["sample_seconds"] / STEPS
    resumed32 = crash_then_resume(workdir, "osmosis_sample_config.yaml", "seg32", checkpoint,
                                  preset_counts(gn_sites, ups, pools, STEPS - 5, STEPS - 5,
                                                phi_fit_steps(STEPS, STEPS - 5)),
                                  fp32, 5, "cuDNN deterministic", sampler="ddim")
    log(f"  fp32 preset, ddim{STEPS}, chain_checkpoint (cuDNN deterministic, "
        f"{out['fp32_checkpoint_seconds_per_step'] * 1e3:.1f} ms a step): crash after the first "
        f"boundary, resume from step 5/{STEPS}: the {len(resumed32)} PNGs equal the "
        "uninterrupted run's byte for byte")
    out.update(same_without_deterministic=same_plain,
               checkpoint_equals_plain=runs["checkpoint"] == runs["plain_a"],
               resumed_bitwise=True, fp32_resumed_bitwise=True)
    return out


def crash_then_resume(workdir, preset, tag, checkpoint, resumed_counts, want, boundary,
                      algorithms, **diffusion):
    """``preset`` (ddim STEPS, clip_denoised, progress_segments 4,
    chain_checkpoint) killed after its first boundary save
    (OSMOSIS_TPU_CRASH_AFTER_SEGMENTS), then resumed with the launch counts
    asserted: it must continue from step ``boundary``, log ``algorithms``,
    and write ``want``'s PNGs byte for byte. Returns the resumed PNGs."""
    import osmosis_tpu_torch.pipelines.restore as R

    def preset_path(name, **top):
        return write_preset(workdir, preset, checkpoint, name=f"{tag}_{name}.yaml",
                            timestep_respacing=f"ddim{STEPS}", clip_denoised=True,
                            top=dict(progress_segments=4, chain_checkpoint=True,
                                     save_dir=os.path.join(workdir, f"{tag}_crash"), **top),
                            **diffusion)[0]

    os.environ["OSMOSIS_TPU_CRASH_AFTER_SEGMENTS"] = str(R._CRASH_SAVES["n"] + 1)
    try:
        R.run_restoration(preset_path("crash"), device="cuda:0")
        raise AssertionError(f"{tag}: the crash hook did not fire")
    except RuntimeError as e:
        if "injected crash" not in str(e):
            raise
        log(f"  {tag}: crashed as injected: {e}")
    finally:
        del os.environ["OSMOSIS_TPU_CRASH_AFTER_SEGMENTS"]
    rd, _, _, _ = run_counted(preset_path("resume", resume=True), f"{tag} resume",
                              resumed_counts)
    with open(os.path.join(rd, "log.txt")) as f:
        text = f.read()
    if f"resuming chain at step {boundary}/{STEPS}" not in text:
        raise AssertionError(f"{tag}: the resumed run did not continue from step {boundary}")
    if f"Convolution algorithms: {algorithms}" not in text:
        raise AssertionError(f"{tag}: the run did not take {algorithms} algorithms")
    resumed = png_bytes(rd)
    if resumed != want or len(resumed) != 6:
        raise AssertionError(f"{tag}: the resumed run's PNGs differ from the uninterrupted "
                             f"run's: {png_differences_bytes(resumed, want)}")
    return resumed


def png_differences_bytes(got, want):
    """{name: the largest difference in uint8 levels, or 'missing'} over the
    PNGs ({name: bytes}) that differ between two sets."""
    import io

    import numpy as np
    from PIL import Image

    out = {}
    for name in sorted(set(got) | set(want)):
        if name not in got or name not in want:
            out[name] = "missing"
        elif got[name] != want[name]:
            a, b = (np.asarray(Image.open(io.BytesIO(d[name])), np.int64) for d in (got, want))
            out[name] = int(np.abs(a - b).max())
    return out


def run_restarts(workdir, checkpoint, gn_sites, ups, pools, k_hybrid, steps=10):
    """best_of 2 with phi_jitter, global_N 2 with global_eta_scale 0.5 and
    async_save: the bf16 hybrid preset, ddim ``steps``, one image."""
    path, cfg = write_preset(workdir, "osmosis_sample_hybrid_config.yaml", checkpoint,
                             name="restarts.yaml", timestep_respacing=f"ddim{steps}",
                             clip_denoised=True, top=dict(
                                 best_of=2, phi_jitter=0.01, perf=dict(async_save=True)))
    import yaml

    cfg["sample_pattern"].update(global_N=2, global_eta_scale=0.5)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    chains = 4  # 2 restarts x 2 global chains
    rd, wall, launches, _ = run_counted(path, "restarts", preset_counts(
        gn_sites, ups, pools, chains * steps, chains * len(range(0, steps, k_hybrid)),
        chains * phi_fit_steps(steps)))
    with open(os.path.join(rd, "log.txt")) as f:
        text = f.read()
    for line in ("restart 0: final loss", "restart 1: final loss", "kept restart with final loss",
                 "global iteration: 1", "phase timings:"):
        if line not in text:
            raise AssertionError(f"restarts: the log lacks {line!r}")
    with open(os.path.join(rd, "configurations.txt")) as f:
        if "perf.async_save: True" not in f.read():
            raise AssertionError("restarts: async_save is not in configurations.txt")
    check_run_dir(rd, RESTORE_FILES + ("grid_results/uw_0_g1_grid.png",))
    kept = [ln for ln in text.splitlines() if "restart" in ln and "final loss" in ln]
    log(f"  restarts run: {wall:.1f} s, launches {launches}; " + "; ".join(kept))
    return dict(launches=launches, wall_s=wall, log_lines=kept)


# ---------------------------------------------------------------------------
# phases 15-16: training
# ---------------------------------------------------------------------------

TRAIN_BATCH = FLEET  # K4's times with the parameter sums are phase 11's at this batch
TRAIN_WARM, TRAIN_TIMED = 2, 5
# a train step on the card (kernels) against the CPU (plain versions): the
# loss within 1e-4 relative; each gradient within 1e-3 of its leaf's largest
# magnitude plus 1e-5 of the largest gradient anywhere (convolutions and
# sums in another order; TF32 off)
TRAIN_TOL = (1e-4, 1e-3, 1e-5)


def train_counts(gn_sites, ups, pools, steps, remat=False):
    """Launches of ``steps`` train steps: K3 and the forward resampling at
    every site, K4 (with its parameter sums) and the backward resampling too.
    With remat the forward runs again inside each ResBlock and AttentionBlock
    during the backward: every site but the output norm."""
    again = int(remat)
    return {"group_norm_forward": (len(gn_sites) + again * (len(gn_sites) - 1)) * steps,
            "group_norm_backward": len(gn_sites) * steps,
            "upsample_nearest_2x": ((1 + again) * len(ups) + len(pools)) * steps,
            "box_sum_2x": ((1 + again) * len(pools) + len(ups)) * steps, "phi_fit": 0}


def run_training(n_params_preset, gn_sites, ups, pools):
    """The trainer's step (``ToyTrainer``, what ``python -m
    osmosis_tpu_torch.tools.train_toy_prior`` runs) at the preset model's
    width, batch 4, fp32: TRAIN_WARM warm steps, then TRAIN_TIMED timed ones
    with the launch counts zeroed before and asserted after; the busy share
    over two more; then one step without and one with remat, each from a
    reset memory peak."""
    import dataclasses

    import torch

    from osmosis_tpu_torch.tools import train_toy_prior as P
    from osmosis_tpu_torch.utils import profiling

    args = P.build_parser().parse_args(["--arch", "production", "--size", "256", "--channels",
                                        "256", "--batch", str(TRAIN_BATCH)])
    t0 = time.perf_counter()
    tr = P.ToyTrainer(args, "cuda:0")
    log(f"  toy_unet_config(256, 256, 'production'): {tr.n_params / 1e6:.1f}M params (the preset "
        f"UNet: {n_params_preset / 1e6:.1f}M); built in {time.perf_counter() - t0:.1f} s")
    if tr.n_params != n_params_preset:
        raise AssertionError(f"the production toy config has {tr.n_params} params, the preset "
                             f"{n_params_preset}")
    film = sum(1 for site in gn_sites if site[3] == "film")
    ema_before = torch.stack([e.norm() for e in tr.ema])
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_WARM):
        tr.step()
    torch.cuda.synchronize()
    zero_counts()
    profiling.reset_counters("group_norm_backward.param_sum_launches",
                             "group_norm_backward.film_sum_launches")
    t0 = time.perf_counter()
    losses = torch.stack([tr.step() for _ in range(TRAIN_TIMED)])
    torch.cuda.synchronize()
    s = (time.perf_counter() - t0) / TRAIN_TIMED
    launches = read_counts()
    c = counters()
    sums = (c["group_norm_backward.param_sum_launches"], c["group_norm_backward.film_sum_launches"])
    peak = torch.cuda.max_memory_allocated()
    check_counts("train steps", launches, train_counts(gn_sites, ups, pools, TRAIN_TIMED))
    if sums != (len(gn_sites) * TRAIN_TIMED, film * TRAIN_TIMED):
        raise AssertionError(f"K4 computed its parameter sums {sums[0]} times and the FiLM sums "
                             f"{sums[1]} times over {TRAIN_TIMED} steps, expected "
                             f"{len(gn_sites)} and {film} a step")
    finite = bool(torch.isfinite(losses).all()) and all(
        bool(torch.isfinite(p.grad).all()) for p in tr.params)
    moved = not torch.equal(torch.stack([e.norm() for e in tr.ema]), ema_before)
    if not (finite and moved):
        raise AssertionError(f"train steps: losses and gradients finite {finite}, EMA moved {moved}")
    log(f"  train step, batch {TRAIN_BATCH}: {s:.4f} s a step, {s / TRAIN_BATCH:.4f} s an image "
        f"({TRAIN_TIMED} timed after {TRAIN_WARM} warm); losses {[round(v, 4) for v in losses.tolist()]};"
        f" peak memory {peak / 2 ** 30:.2f} GiB; launches {launches}, K4 with parameter sums "
        f"{sums[0]} (FiLM sums {sums[1]}); loss and gradients finite, the EMA moved")
    busy = device_busy_share(lambda: [tr.step() for _ in range(2)], 2, "train steps")
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        tr.step()
    flop = fc.get_total_flops()
    log(f"  work of a train step (convolutions and matrix products, counted by PyTorch): "
        f"{flop / 1e12:.3f} TFLOP, {flop / s / 1e12:.1f} TFLOP/s at {s:.4f} s a step (peak "
        f"{FP32_FLOPS / 1e12:.0f})")

    remat = {}
    for on in (False, True):
        tr.model.cfg = dataclasses.replace(tr.cfg, remat=on)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        tr.step()
        torch.cuda.synchronize()
        remat[on] = dict(seconds=time.perf_counter() - t0, peak_bytes=torch.cuda.max_memory_allocated(),
                         launches=read_counts())
        check_counts(f"train step, remat {on}", remat[on]["launches"],
                     train_counts(gn_sites, ups, pools, 1, on))
    tr.model.cfg = tr.cfg
    log(f"  one train step without remat: {remat[False]['seconds']:.4f} s, peak "
        f"{remat[False]['peak_bytes'] / 2 ** 30:.2f} GiB; with remat: {remat[True]['seconds']:.4f} s, "
        f"peak {remat[True]['peak_bytes'] / 2 ** 30:.2f} GiB, launches {remat[True]['launches']}")
    if not remat[True]["peak_bytes"] < remat[False]["peak_bytes"]:
        raise AssertionError("remat did not lower the peak memory of a train step")
    return dict(n_params=tr.n_params, seconds_per_step=s, seconds_per_image=s / TRAIN_BATCH,
                losses=losses.tolist(), peak_bytes=peak, launches=launches,
                param_sum_launches=sums[0], film_sum_launches=sums[1], busy=busy, flop=flop,
                remat={str(k): v for k, v in remat.items()})


def check_train_step_card_vs_cpu():
    """One toy-prior train step from the same weights and batch on the card
    (kernels) and on the CPU (plain versions): the loss and every weight
    gradient within TRAIN_TOL."""
    import torch

    from osmosis_tpu_torch.diffusion.schedules import make_schedule
    from osmosis_tpu_torch.models.convert import init_unet
    from osmosis_tpu_torch.tools import train_toy_prior as P

    cfg = P.toy_unet_config(32, 64, "toy")
    ref = randomize_zero_inits(init_unet(cfg, seed=1), seed=2)
    gen = torch.Generator().manual_seed(3)
    batch = P.draw_batch(gen, P.build_parser().parse_args(["--batch", "8", "--size", "32"]), "cpu")
    consts = make_schedule("linear", 1000).device_constants()
    out = {}
    before = read_counts()
    for dev in ("cpu", "cuda"):
        m = init_unet(cfg, seed=1)
        m.load_state_dict(ref.state_dict())
        m = m.to(device=dev, memory_format=torch.channels_last)
        loss = P.diffusion_loss(m, P.Batch(*(v.to(dev) for v in batch)),
                                torch.as_tensor(consts["sqrt_alphas_cumprod"], device=dev),
                                torch.as_tensor(consts["sqrt_one_minus_alphas_cumprod"], device=dev))
        loss.backward()
        out[dev] = (loss.item(), {n: p.grad.cpu() for n, p in m.named_parameters()})
    after = read_counts()
    if not all(after[k] > before[k] for k in UNET_KERNELS) or after["phi_fit"] != before["phi_fit"]:
        raise AssertionError(f"the card's train step did not launch every kernel: {before} -> {after}")
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    tol_loss, tol_rel, tol_top = TRAIN_TOL
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    top = max(g.abs().max().item() for g in g_cpu.values())
    worst = 0.0
    for n, g in g_cpu.items():
        err = (g_gpu[n] - g).abs().max().item()
        limit = tol_rel * g.abs().max().item() + tol_top * top
        if not err <= limit:
            raise AssertionError(f"train step card vs CPU: {n} gradient off by {err:.3e} > {limit:.3e}")
        worst = max(worst, err / limit)
    if not loss_err <= tol_loss:
        raise AssertionError(f"train step card vs CPU: loss {l_gpu} against {l_cpu}")
    log(f"  toy train step card vs CPU (batch 8, 32x32): loss {l_gpu:.6f} / {l_cpu:.6f} "
        f"({loss_err:.2e} relative, limit {tol_loss}); {len(g_cpu)} gradients, the worst at "
        f"{worst:.3f} of its limit ({tol_rel} of its leaf's largest + {tol_top} of the largest)")
    return dict(loss_rel_err=loss_err, worst_grad_share_of_limit=worst)


TOY_UNET = dict(image_size=32, num_channels=64, channel_mult="1,2", attention_resolutions="8",
                num_res_blocks=2, num_head_channels=32)  # toy_unet_config(32, 64, "toy")


def run_toy_loop(workdir):
    """The trainer's CLI at the toy size, in-process (``train`` is what
    ``main`` runs): 300 steps at batch 128, health check on; the last chunk's
    mean loss must fall under 0.8 of the first's. Then a restore run of the
    preset at toy size (10 steps, clip_denoised: 300 steps leave the EMA
    mostly at its initial weights, on which an unclipped guided chain goes to
    NaN) whose ``model_path`` is the EMA checkpoint: it must load it, with no
    random-init fallback."""
    import contextlib
    import io

    import torch
    import yaml

    import osmosis_tpu_torch.models.preset as MP
    import osmosis_tpu_torch.pipelines.restore as R
    from osmosis_tpu_torch.models.convert import load_params_msgpack, state_dict_from_jax
    from osmosis_tpu_torch.models.unet import unet_config_from_yaml
    from osmosis_tpu_torch.tools import train_toy_prior as P

    out = os.path.join(workdir, "toy", "toy_prior.msgpack")
    argv = ["--size", "32", "--channels", "64", "--batch", "128", "--steps", "300", "--chunk",
            "50", "--out", out]
    zero_counts()
    t0 = time.perf_counter()
    report, chunks = P.train(P.build_parser().parse_args(argv))
    wall = time.perf_counter() - t0
    launches = read_counts()
    log(f"  train_toy_prior {' '.join(argv[:-2])}: {wall:.1f} s, "
        f"{report['train_steps_per_sec']} steps/s; chunk mean losses "
        f"{[round(c, 4) for c in chunks]}; launches {launches}")
    log(f"  report: {json.dumps(report)}")
    if not all(launches[k] for k in UNET_KERNELS) or launches["phi_fit"]:
        raise AssertionError(f"the toy run did not launch every kernel of the UNet: {launches}")
    if not chunks[-1] < 0.8 * chunks[0]:
        raise AssertionError(f"the toy loss did not fall: {chunks[0]:.4f} -> {chunks[-1]:.4f}")

    path, cfg = write_preset(workdir, "osmosis_sample_config.yaml", out, name="toy_restore.yaml",
                             timestep_respacing=10, clip_denoised=True)
    cfg["unet_model"].update(TOY_UNET)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    loaded = []
    load_unet = MP.load_unet  # the preset's loader, which run_restoration calls
    MP.load_unet = lambda *a, **kw: loaded.append(load_unet(*a, **kw)) or loaded[-1]
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            rd = R.run_restoration(path, device="cuda:0")
    finally:
        MP.load_unet = load_unet
    if "Randomly initialize" in printed.getvalue():
        raise AssertionError("the restore run fell back to random weights: "
                             + printed.getvalue()[-2000:])
    want = state_dict_from_jax(load_params_msgpack(out), unet_config_from_yaml(cfg["unet_model"]))
    for name, v in loaded[0].state_dict().items():
        if not torch.equal(v.cpu(), want[name]):
            raise AssertionError(f"the restore run's {name} is not the EMA checkpoint's")
    row = check_run_dir(rd, RESTORE_FILES)
    log(f"  restore at 32x32 from the EMA checkpoint: loaded ({len(want)} tensors equal the "
        f"file's), run dir complete, chain_finite {row['chain_finite']}, final_loss "
        f"{row['final_loss']}")
    return dict(report=report, chunk_losses=chunks, wall_s=wall, launches=launches,
                restore_chain_finite=row["chain_finite"], checkpoint=out)


# ---------------------------------------------------------------------------
# phase 17: the warm-model server; phase 18: the quality tools
# ---------------------------------------------------------------------------

def _http(url, data=None):
    """(status, JSON body) of a GET, or of a POST of ``data``."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def run_serve(workdir, checkpoint, gn_sites, ups, pools):
    """The fast preset (bf16 torso, x_prev at every step, 20 phi iterations)
    behind the port's HTTP server at full width, with the seeded random-init
    checkpoint, ddim STEPS for ddim200 and clip_denoised (random weights turn
    an unclipped chain to NaN): /healthz 503 before the warmup and 200 after
    it; three restores of a data/underwater image (seeds 0, 0, 1: the same
    bytes twice, other bytes for the other seed), each with its launch counts
    zeroed before and asserted after; a bad payload (400) and an unknown
    route (404); ms per request and per step, the busy share over one
    request, the peak memory."""
    import base64
    import socket
    import threading
    from http.server import HTTPServer

    import torch

    from osmosis_tpu_torch.tools import serve

    path, cfg = write_preset(workdir, "osmosis_sample_fast_config.yaml", checkpoint,
                             name="serve.yaml", timestep_respacing=f"ddim{STEPS}",
                             clip_denoised=True)
    log(f"  cuts: timestep_respacing ddim{STEPS} (the preset: ddim200), clip_denoised True "
        f"(the preset: False); width, dtype, n_iter {cfg['sample_pattern']['n_iter']} and "
        "guidance as the preset")
    t0 = time.perf_counter()
    restorer = serve.Restorer(path, device="cuda:0", warmup=False)
    load_s = time.perf_counter() - t0
    if restorer.model.input_blocks[0][0].weight.dtype != torch.bfloat16:
        raise AssertionError("the server did not load the preset's bf16 torso")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    httpd = HTTPServer(("127.0.0.1", port), serve.make_handler(restorer))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{port}"
    try:
        before = _http(f"{url}/healthz")
        t0 = time.perf_counter()
        restorer.warmup()
        warm_s = time.perf_counter() - t0
        after = _http(f"{url}/healthz")
        if before != (503, {"warm": False}) or after != (200, {"warm": True}):
            raise AssertionError(f"/healthz before and after the warmup: {before}, {after}")
        log(f"  model loaded in {load_s:.1f} s, warm in {warm_s:.1f} s; /healthz {before[0]} "
            f"before the warmup, {after[0]} after")
        with open(os.path.join(ROOT, "data", "underwater", "uw_0.png"), "rb") as f:
            img = f.read()
        expected = preset_counts(gn_sites, ups, pools, STEPS, STEPS, phi_fit_steps(STEPS))
        torch.cuda.reset_peak_memory_stats()
        requests = []
        for seed in (0, 0, 1):
            zero_counts()
            t0 = time.perf_counter()
            code, out = _http(f"{url}/restore?seed={seed}", img)
            wall = time.perf_counter() - t0
            launches = read_counts()
            if code != 200:
                raise AssertionError(f"/restore?seed={seed}: {code} {out}")
            check_counts(f"serve, seed {seed}", launches, expected)
            if not math.isfinite(out["final_loss"]):
                raise AssertionError(f"/restore?seed={seed}: final loss {out['final_loss']}")
            for key in ("rgb_png", "depth_png"):
                if not base64.b64decode(out[key]).startswith(b"\x89PNG"):
                    raise AssertionError(f"/restore?seed={seed}: {key} is not a PNG")
            requests.append(dict(seed=seed, ms=out["ms"], wall_ms=wall * 1e3,
                                 final_loss=out["final_loss"], phi=out["phi"],
                                 launches=launches, rgb=out["rgb_png"], depth=out["depth_png"]))
            log(f"  POST /restore?seed={seed}: 200 in {wall * 1e3:.1f} ms ({out['ms']} ms in "
                f"restore, {out['ms'] / STEPS:.1f} ms a step); final loss "
                f"{out['final_loss']:.4f}; launches {launches}")
        peak = torch.cuda.max_memory_allocated()
        same = (requests[0]["rgb"], requests[0]["depth"]) == (requests[1]["rgb"],
                                                             requests[1]["depth"])
        other = requests[2]["rgb"] != requests[0]["rgb"]
        if not (same and other):
            raise AssertionError(f"seed 0 twice gave the same bytes: {same}; seed 1 other "
                                 f"bytes: {other}")
        bad = _http(f"{url}/restore", b"not an image")
        unknown = _http(f"{url}/nope")
        if bad[0] != 400 or unknown[0] != 404:
            raise AssertionError(f"a bad payload got {bad}, an unknown route {unknown}")
        log(f"  seed 0 twice: the same PNG bytes; seed 1: other bytes; a bad payload: "
            f"{bad[0]}; an unknown route: {unknown[0]}; peak memory {peak / 2 ** 30:.2f} GiB")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    busy = device_busy_share(lambda: restorer.restore(img, seed=0), STEPS,
                             "steps of one request (restore, seed 0)")
    ms = [r["ms"] for r in requests]
    for r in requests:
        del r["rgb"], r["depth"]
    return dict(load_s=load_s, warm_s=warm_s, requests=requests, peak_bytes=peak, busy=busy,
                launches_per_request=requests[0]["launches"], ms_per_request=ms,
                ms_per_step=[m / STEPS for m in ms])


def run_quality_tools(workdir, toy_checkpoint):
    """The quality tools on the card at toy size: ``simulate_degraded`` on four
    seeded scenes (its PNGs against the same run on the CPU, within one
    level), ``validate_toy_e2e`` on phase 16's EMA checkpoint (4 scenes, 50
    respaced steps; the 300-step EMA is mostly its initial weights, so its
    ``pass`` is reported, not asserted), ``demo_toy_restore`` (the simulated
    PNG set through ``run_restoration``, scored by ``evaluate``) and
    ``validate_checkpoint --tiny``."""
    import contextlib
    import io

    import numpy as np
    from PIL import Image

    from osmosis_tpu_torch.tools import demo_toy_restore as D
    from osmosis_tpu_torch.tools import simulate_degraded as S
    from osmosis_tpu_torch.tools import validate_checkpoint as VC
    from osmosis_tpu_torch.tools import validate_toy_e2e as V

    out = {}
    sim = os.path.join(workdir, "sim_tool")
    argv = ["--synth", "4", "--size", "32", "--seed", "123", "--noise", "gaussian",
            "--phi-jitter", "0.1"]
    t0 = time.perf_counter()
    manifest = S.main(["--out", os.path.join(sim, "cuda")] + argv)
    S.main(["--out", os.path.join(sim, "cpu"), "--cpu"] + argv)
    worst = 0
    for name in manifest["images"]:
        for sub in ("input", "gt_rgb", "gt_depth"):
            a, b = (np.asarray(Image.open(os.path.join(sim, d, sub, f"{name}.png")), np.int64)
                    for d in ("cuda", "cpu"))
            worst = max(worst, int(np.abs(a - b).max()))
    if manifest["count"] != 4 or worst > 1:
        raise AssertionError(f"simulate_degraded: {manifest['count']} images, card vs CPU "
                             f"{worst} levels apart")
    out["simulate"] = dict(count=manifest["count"], card_vs_cpu_max_levels=worst,
                           wall_s=time.perf_counter() - t0)
    log(f"  simulate_degraded {' '.join(argv)}: {manifest['count']} images; card vs CPU at "
        f"most {worst} uint8 level(s) apart")

    printed = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = V.main(["--checkpoint", toy_checkpoint, "--scenes", "4", "--respacing", "50"])
    wall = time.perf_counter() - t0
    launches = read_counts()
    report = json.loads(printed.getvalue().strip().splitlines()[-1])
    finite = all(math.isfinite(r[k]) for r in report["scenes"]
                 for k in ("psnr_degraded", "psnr_restored", "depth_corr", "phi_mae"))
    if len(report["scenes"]) != 4 or not finite or not all(launches.values()):
        raise AssertionError(f"validate_toy_e2e: {report}; launches {launches}")
    out["validate_toy_e2e"] = dict(report=report, rc=rc, wall_s=wall, launches=launches)
    log(f"  validate_toy_e2e (phase 16's 300-step EMA, 4 scenes, 50 steps): {wall:.1f} s "
        f"({wall / 200 * 1e3:.1f} ms a step), exit {rc}; {json.dumps(report)}")

    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        demo = D.main(["--checkpoint", toy_checkpoint, "--size", "32", "--channels", "64",
                       "--scenes", "2", "--respacing", "10",
                       "--workdir", os.path.join(workdir, "toy_demo")])
    if "Randomly initialize" in printed.getvalue() or not math.isfinite(demo["psnr_restored"]):
        raise AssertionError(f"demo_toy_restore: {demo}")
    out["demo_toy_restore"] = dict(report=demo, wall_s=time.perf_counter() - t0)
    log(f"  demo_toy_restore (2 scenes, 10 steps): {json.dumps(demo)}")

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = VC.main(["--tiny", "--stop-after", "1",
                      "--out", os.path.join(workdir, "selftest.msgpack")])
    summary = json.loads(printed.getvalue().strip().splitlines()[-1])
    if rc != 0 or not summary["parity_ok"] or "run_dir" not in summary:
        raise AssertionError(f"validate_checkpoint --tiny: exit {rc}, {summary}")
    out["validate_checkpoint"] = summary
    log(f"  validate_checkpoint --tiny: parity {summary['parity_rel_err']:.2e} of the "
        f"output's largest value, stages 2-3 ran (PSNR {summary.get('psnr_mean')})")
    return out


# ---------------------------------------------------------------------------
# phase 19: two ranks on one card (parallel/multihost over gloo)
# ---------------------------------------------------------------------------

MH_RANKS = 2
MH_STEPS = 10
MH_TIMING_IMAGES = 4


def rank_worker(argv):
    """One rank of phase 19: ``chip_smoke.py --rank-worker <tasks.json> <k>``
    runs each task of the file in turn through the port's CLI (``sample`` or
    ``prior_sample``'s ``main``, with the task's arguments and the cluster
    flags; the first call joins the group, the later ones keep it), with
    cuDNN's deterministic algorithms where the task asks, the launch counts
    zeroed and the peak memory reset before it; after each it writes its
    counts, its peak, its progress rows and the ranks it gathered to
    ``<tag>_rank<k>.json`` beside the file."""
    import torch

    from osmosis_tpu_torch import prior_sample, sample
    from osmosis_tpu_torch.parallel import multihost as MH

    with open(argv[0]) as f:
        spec = json.load(f)
    k = int(argv[1])
    cluster = ["-d", "0", "--coordinator", spec["coordinator"], "--num-processes",
               str(MH_RANKS), "--process-id", str(k)]
    for task in spec["tasks"]:
        torch.backends.cudnn.deterministic = task["deterministic"]
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        main = prior_sample.main if task["kind"] == "prior" else sample.main
        run_dir = main(["-c", task["config"], *cluster])
        torch.cuda.synchronize()
        rows = read_rows(run_dir, f"progress{MH.rank_suffix()}.json")
        gathered = MH.gather_scalars({"rank": MH.process_index()})
        report = os.path.join(os.path.dirname(argv[0]), f"{task['tag']}_rank{k}.json")
        with open(report, "w") as f:
            json.dump(dict(rank=MH.process_index(), count=MH.process_count(), run_dir=run_dir,
                           launches=read_counts(), peak_bytes=torch.cuda.max_memory_allocated(),
                           rows=rows, gathered_ranks=gathered["rank"].tolist()), f)
    MH.barrier("tasks_done")
    return 0


def launch_ranks(workdir, tasks, timeout=300):
    """MH_RANKS processes of ``rank_worker`` over ``tasks`` (dicts of tag,
    kind, config, deterministic), all on cuda:0, joined by gloo at a free
    local port; each is killed if it outlives ``timeout``. Returns ({tag: the
    ranks' reports}, wall seconds)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    spec = os.path.join(workdir, "mh_tasks.json")
    with open(spec, "w") as f:
        json.dump(dict(coordinator=f"127.0.0.1:{port}", tasks=tasks), f)
    procs = []
    t0 = time.perf_counter()
    try:
        for k in range(MH_RANKS):
            out = open(os.path.join(workdir, f"mh_rank{k}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--rank-worker", spec,
                 str(k)], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), stdout=out,
                stderr=subprocess.STDOUT), out))
        deadline = time.time() + timeout
        for p, out in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    wall = time.perf_counter() - t0
    for k, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(workdir, f"mh_rank{k}.log")) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"rank {k} exited {p.returncode}:\n{tail}")
    reports = {}
    for task in tasks:
        reports[task["tag"]] = []
        for k in range(MH_RANKS):
            with open(os.path.join(workdir, f"{task['tag']}_rank{k}.json")) as f:
                reports[task["tag"]].append(json.load(f))
        rs = reports[task["tag"]]
        if len({r["run_dir"] for r in rs}) != 1 or any(
                r["gathered_ranks"] != list(map(float, range(MH_RANKS))) for r in rs):
            raise AssertionError(f"{task['tag']}: the ranks did not share one run dir and one "
                                 f"group: {[(r['run_dir'], r['gathered_ranks']) for r in rs]}")
    return reports, wall


def check_rank_counts(what, reports, per_image):
    """Each rank's launches: the one-process run's per image times its images."""
    for r in reports:
        n = len(r["rows"])
        check_counts(f"{what}, rank {r['rank']} ({n} images)", r["launches"],
                     {k: v * n for k, v in per_image.items()})


def png_differences(dir_a, dir_b):
    """{relative path: the largest difference in uint8 levels} over the PNGs
    whose bytes differ between two run dirs with the same files."""
    a, b = png_bytes(dir_a), png_bytes(dir_b)
    if sorted(a) != sorted(b):
        raise AssertionError(f"the runs wrote other PNGs: {sorted(a)} against {sorted(b)}")
    return png_differences_bytes(a, b)


def fp32_repeats(checkpoint):
    """The fp32 UNet's forward and x-pullback at a seeded 256x256 input and
    t = 999, three times, with cuDNN's default algorithms and with its
    deterministic ones: does each call give the first call's bits?"""
    from osmosis_tpu_torch.config import load_yaml
    from osmosis_tpu_torch.models.convert import load_unet
    from osmosis_tpu_torch.models.unet import unet_config_from_yaml
    from osmosis_tpu_torch.tools.cudnn_determinism import unet_repeats

    ucfg = unet_config_from_yaml(load_yaml(os.path.join(
        ROOT, "configs", "osmosis_sample_config.yaml"))["unet_model"])
    return unet_repeats(load_unet(checkpoint, ucfg, "cuda"))


def read_rows(run_dir, name="progress.json"):
    with open(os.path.join(run_dir, name)) as f:
        return [json.loads(line) for line in f if line.strip()]


def run_multihost(workdir, checkpoint, gn_sites, ups, pools, k_hybrid):
    """Two ranks on one card through the port's CLI (``--coordinator
    127.0.0.1:<port> --num-processes 2 --process-id k -d 0``), two processes
    that run every task below in turn, after the one-process runs here:
    (a) the fp32 preset, MH_STEPS steps, clip_denoised, on uw_0, uw_1 and a
        seeded 256x256 image: one run dir, image i on rank i % 2, both ranks'
        logs, each rank's K1-K4 launches the one-process run's per image
        times its images, and every PNG the one-process run's byte for byte.
        Both runs take cuDNN's deterministic algorithms: its default fp32
        backward-data algorithm gives other bits from run to run, in one
        process too, which the chain amplifies to a few uint8 levels. The
        one-process run with the default algorithms, and three calls of the
        UNet with each, measure that;
    (b) the RGBD prior, 2 indices, MH_STEPS steps: one run dir, both images;
    (c) the fp32 preset (MH_STEPS steps) and the bf16 hybrid preset (ddim
        STEPS), MH_TIMING_IMAGES seeded images each, in one process and in
        two: seconds per image-step and each rank's peak."""
    import shutil

    import torch
    import yaml

    out = {}
    imgs = os.path.join(workdir, "mh_images")
    os.makedirs(imgs)
    for i in (0, 1):
        shutil.copy(os.path.join(ROOT, "data", "underwater", f"uw_{i}.png"), imgs)
    write_images(os.path.join(workdir, "mh_seeded"), 1, 30, "uw", size=(256, 256))
    os.replace(os.path.join(workdir, "mh_seeded", "uw_0.png"), os.path.join(imgs, "uw_2.png"))
    write_images(os.path.join(workdir, "mh_timing"), MH_TIMING_IMAGES, 31, "tm", size=(256, 256))
    timing_data = dict(root=os.path.join(workdir, "mh_timing"), stop_after=-1)
    cases = {  # tag: preset, data, respacing, steps, x_prev steps, deterministic
        "preset": ("osmosis_sample_config.yaml", dict(root=imgs, stop_after=-1), MH_STEPS,
                   MH_STEPS, MH_STEPS, True),
        "float32": ("osmosis_sample_config.yaml", timing_data, MH_STEPS, MH_STEPS, MH_STEPS,
                    False),
        "bfloat16": ("osmosis_sample_hybrid_config.yaml", timing_data, f"ddim{STEPS}", STEPS,
                     len(range(0, STEPS, k_hybrid)), False),
    }
    paths, per_image, one = {}, {}, {}
    for tag, (preset, data, resp, steps, n_full, det) in cases.items():
        per_image[tag] = preset_counts(gn_sites, ups, pools, steps, n_full,
                                       phi_fit_steps(steps))
        for n in ("one", "two"):
            paths[tag, n], _ = write_preset(workdir, preset, checkpoint, name=f"mh_{tag}_{n}.yaml",
                                            data=data, timestep_respacing=resp, clip_denoised=True,
                                            top=dict(save_dir=os.path.join(workdir, f"mh_{tag}_{n}")))
        n_images = len(os.listdir(data["root"]))
        saved, torch.backends.cudnn.deterministic = torch.backends.cudnn.deterministic, det
        held = torch.cuda.memory_allocated()  # this process's tensors from earlier phases
        try:
            run_dir, wall, _, peak = run_counted(paths[tag, "one"], f"{tag}, one process", {
                k: n_images * v for k, v in per_image[tag].items()})
        finally:
            torch.backends.cudnn.deterministic = saved
        one[tag] = dict(run_dir=run_dir, wall_s=wall, peak_bytes=peak - held,
                        rows=read_rows(run_dir))
    # why (a) takes the deterministic algorithms: the same one-process run
    # with cuDNN's default ones, and the UNet's repeats with each
    default_dir = run_counted(paths["preset", "one"], "preset, default cuDNN", {
        k: 3 * v for k, v in per_image["preset"].items()})[0]
    det_vs_default = png_differences(one["preset"]["run_dir"], default_dir)
    repeats = fp32_repeats(checkpoint)
    log(f"  fp32 preset, one process, cuDNN's default algorithms against its deterministic ones: "
        f"{len(det_vs_default)} of {len(png_bytes(default_dir))} PNGs differ, by up to "
        f"{max(det_vs_default.values(), default=0)} uint8 levels; the fp32 UNet called "
        f"3 times: {repeats}")
    if not (repeats["deterministic"]["forward_repeats"]
            and repeats["deterministic"]["pullback_repeats"]):
        raise AssertionError("with cuDNN's deterministic algorithms the fp32 UNet does not "
                             "repeat its bits")
    out["determinism"] = dict(default_vs_deterministic_pngs=det_vs_default, unet=repeats)
    path, cfg = write_preset(workdir, "RGBD_sample_config.yaml", checkpoint, name="mh_prior.yaml",
                             timestep_respacing=MH_STEPS,
                             top=dict(save_dir=os.path.join(workdir, "mh_prior")))
    cfg["number_of_images"] = MH_RANKS
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    tasks = [dict(tag="preset", kind="sample", config=paths["preset", "two"], deterministic=True),
             dict(tag="prior", kind="prior", config=path, deterministic=False)]
    tasks += [dict(tag=tag, kind="sample", config=paths[tag, "two"], deterministic=False)
              for tag in ("float32", "bfloat16")]
    reports, wall = launch_ranks(workdir, tasks)
    log(f"  two ranks ran their {len(tasks)} tasks in {wall:.1f} s, their start included")

    rs = reports["preset"]
    run_dir = rs[0]["run_dir"]
    owned = [[row["image"] for row in r["rows"]] for r in rs]
    if owned != [["uw_0.png", "uw_2.png"], ["uw_1.png"]]:
        raise AssertionError(f"the ranks restored {owned}, expected uw_0 and uw_2 on rank 0, "
                             "uw_1 on rank 1")
    check_run_dir(run_dir, ("log.txt", "log-rank001.txt", "progress-rank001.json"))
    check_rank_counts("fp32 preset", rs, per_image["preset"])
    n_png = len(png_bytes(run_dir))
    differ = png_differences(one["preset"]["run_dir"], run_dir)
    if differ or n_png < 12:
        raise AssertionError(f"{len(differ)} of {n_png} PNGs differ from the one-process run's; "
                             f"the largest difference per file, in uint8 levels: {differ}")
    log(f"  (a) fp32 preset, {MH_STEPS} steps, 3 images, cuDNN deterministic: one run dir, rank 0 "
        f"{owned[0]}, rank 1 {owned[1]}; launches per rank {[r['launches'] for r in rs]}; the "
        f"{n_png} PNGs equal the one-process run's byte for byte; peaks "
        f"{[round(r['peak_bytes'] / 2 ** 30, 2) for r in rs]} GiB per rank, "
        f"{one['preset']['peak_bytes'] / 2 ** 30:.2f} in one process (above what it held before)")
    out["preset"] = dict(owned=owned, pngs=n_png, bitwise=True,
                         launches=[r["launches"] for r in rs],
                         peak_bytes=[r["peak_bytes"] for r in rs],
                         one_peak_bytes=one["preset"]["peak_bytes"])

    rs = reports["prior"]
    owned = [[row["image"] for row in r["rows"]] for r in rs]
    check_run_dir(rs[0]["run_dir"], ["log-rank001.txt"] + [
        f"single_images/rgb/image_{i}.png" for i in range(MH_RANKS)])
    if owned != [[0], [1]]:
        raise AssertionError(f"prior: the ranks sampled {owned}")
    check_rank_counts("prior", rs, {
        "group_norm_forward": len(gn_sites) * MH_STEPS, "group_norm_backward": 0,
        "upsample_nearest_2x": len(ups) * MH_STEPS, "box_sum_2x": len(pools) * MH_STEPS,
        "phi_fit": 0})
    log(f"  (b) prior, {MH_STEPS} steps, 2 indices on two ranks: one run dir, launches per rank "
        f"{[r['launches'] for r in rs]}")
    out["prior"] = dict(owned=owned, launches=[r["launches"] for r in rs])

    out["timing"] = {}
    for tag in ("float32", "bfloat16"):
        preset, _, resp, steps, _, _ = cases[tag]
        rs = reports[tag]
        check_rank_counts(f"{tag} timing", rs, per_image[tag])
        t1 = image_step_seconds([one[tag]["rows"]], steps)
        t2 = image_step_seconds([r["rows"] for r in rs], steps)
        t = dict(one=t1, two=t2, speedup=t1["seconds"] / t2["seconds"],
                 warm_speedup=t1["warm_seconds"] / t2["warm_seconds"],
                 one_peak_bytes=one[tag]["peak_bytes"], rank_peak_bytes=[r["peak_bytes"] for r in rs],
                 images=MH_TIMING_IMAGES, steps=steps)
        out["timing"][tag] = t
        log(f"  (c) {tag} ({preset}, {resp} steps, {MH_TIMING_IMAGES} images), seconds per "
            f"image-step, all images / without each process's first (images with their "
            f"post-processing; chains only): one process {t1['seconds']:.5f} / "
            f"{t1['warm_seconds']:.5f} ({t1['sample_seconds']:.5f} / "
            f"{t1['warm_sample_seconds']:.5f}), two ranks {t2['seconds']:.5f} / "
            f"{t2['warm_seconds']:.5f} ({t2['sample_seconds']:.5f} / "
            f"{t2['warm_sample_seconds']:.5f}): {t['speedup']:.3f}x / {t['warm_speedup']:.3f}x "
            f"the image-steps a second; peak {one[tag]['peak_bytes'] / 2 ** 30:.2f} GiB in one "
            f"process (above what it held before), {[round(r['peak_bytes'] / 2 ** 30, 2) for r in rs]} GiB per rank")
    return out


# ---------------------------------------------------------------------------
# phase 20: the day-one runbook, seed_replicate and the native host ops
# ---------------------------------------------------------------------------

RUNBOOK_PRESETS = ("reference", "x0_turbo", "hybrid_turbo", "haze", "rgb", "prior")
RUNBOOK_STEPS = 10  # --smoke-steps: every chain at ddim10 (the prior: its last 10 steps)
RUNBOOK_PRIOR_IMAGES = 2


def runbook_counts(name, entry, gn_sites, ups, pools):
    """A runbook preset's launches: RUNBOOK_STEPS steps of one image (the
    prior: RUNBOOK_PRIOR_IMAGES images, forwards only), K4 and the backward
    resampling at the x_prev steps only (x0_turbo: none; hybrid_turbo:
    every 4th), twice where a phi stall retried the preset with adam; K5 at
    the osmosis presets' steps with phi-only passes, in the SGD run alone
    (adam keeps the eager loop; rgb is 'ps', with no phi fit)."""
    steps = RUNBOOK_STEPS
    if name == "prior":
        return preset_counts(gn_sites, ups, pools, steps * RUNBOOK_PRIOR_IMAGES, 0, 0)
    full = {"x0_turbo": 0, "hybrid_turbo": len(range(0, steps, 4))}.get(name, steps)
    runs = 2 if entry.get("phi_stall_sgd") else 1
    counts = preset_counts(gn_sites, ups, pools, steps, full, 0)
    counts = {k: v * runs for k, v in counts.items()}
    counts["phi_fit"] = 0 if name == "rgb" else phi_fit_steps(steps)
    return counts


def run_runbook(workdir, checkpoint, gn_sites, ups, pools):
    """``real_weights_runbook.main`` in this process on the card, through
    every stage: stage 1 converts the seeded random-init ``.pt`` (552.8M
    parameters, 256²) and checks its parity, stage 2 simulates the
    underwater and haze sets from one seeded GT scene, then the presets
    RUNBOOK_PRESETS, each with the launch counts zeroed before and read after,
    scored by ``evaluate`` and gated. The cuts, each printed by the runbook:
    ``--smoke-steps 10`` (ddim10, clip_denoised; the prior's last 10 steps,
    2 images), ``--stop-after 1``; n_iter and the widths as each preset has
    them. Random weights restore nothing, so the gates' verdicts are reported,
    not asserted."""
    import torch

    from osmosis_tpu_torch.tools import real_weights_runbook as RB

    gt = os.path.join(workdir, "rb_gt")
    write_images(os.path.join(gt, "rgb"), 1, 40, "scene")
    write_depth(os.path.join(gt, "depth"), 1, 41, "scene")
    out_dir = os.path.join(workdir, "runbook")
    counts, run_preset = {}, RB.run_preset

    def counted(name, ctx, report):
        zero_counts()
        try:
            return run_preset(name, ctx, report)
        finally:
            torch.cuda.synchronize()
            counts[name] = read_counts()

    argv = ["--checkpoint", checkpoint, "--gt-rgb", os.path.join(gt, "rgb"),
            "--gt-depth", os.path.join(gt, "depth"), "--out", out_dir, "--stop-after", "1",
            "--presets", ",".join(RUNBOOK_PRESETS), "--smoke-steps", str(RUNBOOK_STEPS),
            "--rehearsal-json", os.path.join(out_dir, "rehearsal.json"), "-d", "0"]
    log(f"  real_weights_runbook {' '.join(argv)}")
    RB.run_preset = counted
    t0 = time.perf_counter()
    try:
        report = RB.main(argv)
    finally:
        RB.run_preset = run_preset
    wall = time.perf_counter() - t0
    for name in RUNBOOK_PRESETS:
        entry = report["presets"].get(name)
        if entry is None or "error" in entry:
            raise AssertionError(f"runbook: preset {name}: {entry}")
        check_counts(f"runbook {name}", counts[name],
                     runbook_counts(name, entry, gn_sites, ups, pools))
    failed = [s for s in report["stage_seconds"] if s["stage"].endswith(":error")]
    if failed:
        raise AssertionError(f"runbook: a preset failed on its first attempt: {failed}")
    for f in ("RUNBOOK_REPORT.md", "RUNBOOK_REPORT.json", "rehearsal.json"):
        if not os.path.exists(os.path.join(out_dir, f)):
            raise AssertionError(f"runbook: {f} was not written")
    for s in report["stage_seconds"]:
        log(f"  stage {s['stage']}: {s['seconds']} s")
    gates = {}
    for name in RUNBOOK_PRESETS:
        e = report["presets"][name]
        gates[name] = dict(score=e.get("score"), x0_std_contraction=e["x0_std_contraction"],
                           phi_stall_sgd=bool(e.get("phi_stall_sgd")), kept=e.get("kept"))
        log(f"  {name}: launches {counts[name]}; score {e.get('score')}; phi stall on sgd "
            f"{bool(e.get('phi_stall_sgd'))} (kept {e.get('kept', '-')}); x0_std contracts "
            f"{e['x0_std_contraction']['ok']} ({e['x0_std_contraction']['detail']})")
    log(f"  the runbook took {wall:.1f} s; RUNBOOK_REPORT.md, RUNBOOK_REPORT.json and the "
        "rehearsal record written")
    return dict(wall_s=wall, stages=report["stage_seconds"], launches=counts, gates=gates)


def run_seed_replicate(workdir, toy_checkpoint):
    """``seed_replicate.main`` on one cell (r128_s50_x0, sampling seed 1)
    through the port's ``validate_toy_e2e`` on the card, the cell's flags
    overridden to phase 16's 32x32 toy EMA and 2 scenes; its row must land in
    a grid in the workdir with its seed."""
    from osmosis_tpu_torch.tools import seed_replicate as SR

    d = os.path.join(workdir, "seed_replicate")
    grid, summary = os.path.join(d, "grid.jsonl"), os.path.join(d, "summary.json")
    override = f"--checkpoint {toy_checkpoint} --size 32 --channels 64 --arch toy --scenes 2"
    t0 = time.perf_counter()
    SR.main(["--cells", "r128_s50_x0", "--seeds", "1", "--grid", grid, "--summary", summary,
             "--override", override, "-d", "0"])
    wall = time.perf_counter() - t0
    rows = SR.load_grid(grid)
    if [(r.get("row"), r.get("seed")) for r in rows] != [("r128_s50_x0", 1)]:
        raise AssertionError(f"seed_replicate: the grid holds {rows}")
    if not os.path.exists(summary):
        raise AssertionError("seed_replicate: no summary written")
    log(f"  seed_replicate r128_s50_x0 seed 1 (override: {override}): {wall:.1f} s, row "
        f"{json.dumps(rows[0])}")
    return dict(wall_s=wall, row=rows[0])


def run_native_host_ops(workdir, reps=20):
    """The native host ops against their numpy paths on this machine's host:
    preprocessing of a data/underwater image and the RGB PNG writer, each
    ``reps`` times; the same values (preprocessing bit for bit, the PNG's
    pixels), and host ms per image."""
    import numpy as np
    from PIL import Image

    from osmosis_tpu_torch.data import postprocess as P
    from osmosis_tpu_torch.data import transforms as T
    from osmosis_tpu_torch.utils import native

    if not native.available():
        raise AssertionError(f"the native host ops are not in use: {native.status()}")
    img = Image.open(os.path.join(ROOT, "data", "underwater", "uw_0.png")).convert("RGB")
    rgb = np.random.default_rng(0).random((256, 256, 3)).astype(np.float32)
    out, results = {}, {}
    for path in ("native", "numpy"):
        if path == "numpy":
            os.environ[native.NO_NATIVE_ENV] = "1"
        try:
            t0 = time.perf_counter()
            for _ in range(reps):
                x = T.preprocess_image(img, 256)
            pre = (time.perf_counter() - t0) / reps
            png = os.path.join(workdir, f"native_{path}.png")
            t0 = time.perf_counter()
            for _ in range(reps):
                P.save_png(rgb, png)
            save = (time.perf_counter() - t0) / reps
        finally:
            os.environ.pop(native.NO_NATIVE_ENV, None)
        results[path] = (x, np.asarray(Image.open(png)))
        out[path] = dict(preprocess_ms=pre * 1e3, png_ms=save * 1e3)
    if not np.array_equal(results["native"][0], results["numpy"][0]):
        raise AssertionError("native preprocessing differs from the numpy path")
    if not np.array_equal(results["native"][1], results["numpy"][1]):
        raise AssertionError("the native PNG decodes to other pixels than PIL's")
    log(f"  native host ops ({native.status()}), host ms per image, native / numpy: "
        f"preprocess {img.size[0]}x{img.size[1]} -> 256x256 {out['native']['preprocess_ms']:.3f} / "
        f"{out['numpy']['preprocess_ms']:.3f}, PNG 256x256 RGB {out['native']['png_ms']:.3f} / "
        f"{out['numpy']['png_ms']:.3f}; the same values")
    return out


# ---------------------------------------------------------------------------
# phase 21: the (dp, tp) mesh on one card, and the orbax fixture
# ---------------------------------------------------------------------------

MESH_STEPS = 2  # the dryrun's production-width chain: 2 steps, n_iter 1, update_start 1
MESH_LANES = 2
ORBAX_FIXTURE = os.path.join(ROOT, "tests", "data", "orbax_tiny_unet")


def run_mesh(workdir, checkpoint, gn_sites, ups, pools):
    """Two ranks share cuda:0 over gloo (``tools.mesh_check``), fp32, TF32
    off, cuDNN deterministic, the preset's 552.8M UNet at 256² from the
    seeded checkpoint: tp=2 (mesh 1x2: the UNet forward and x-pullback, the
    2-step guided chain at batch 1) and dp=2 (mesh 2x1: the joint-loss chain
    at batch 2, its loss reduced over dp, and the fleet runner at N=2, both
    with ``mesh=``), each rank against the one-process run of the same
    check in this process at rtol/atol 5e-4 (1e-3 on the loss trace; under
    dp the one process calls its UNet on each rank's images) with
    ``mesh_check``'s clamp-flip excuse, whose counts :func:`log_bar` prints;
    each rank's peak beside the one process's at the rank's batch; each rank's
    K1-K4 launches equal the one process's (tp: every rank runs every site;
    dp: the launches of its own images, the same count at any batch); under
    tp=2 a rank holds the replicated bytes and half the sharded ones. Then
    the committed orbax fixture read by ``load_unet`` onto the card, its
    forward against the recorded one at the UNet parity bar; then the
    seeded tree through ``save_params_orbax`` (:func:`orbax_full_width`)."""
    import numpy as np
    import torch

    from osmosis_tpu_torch.tools import mesh_check

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()  # this process's tensors from earlier phases
    argv = ["--checkpoint", checkpoint, "--out", os.path.join(workdir, "mesh"), "--size", "256",
            "--ranks", "2", "--backend", "gloo", "--meshes", "1x2,2x1", "--steps",
            str(MESH_STEPS), "--n-iter", "1", "--update-start", "1", "--lanes",
            str(MESH_LANES), "-d", "0"]
    args = mesh_check.parse(argv)
    t0 = time.perf_counter()
    summary = mesh_check.launch(args, timeout=400)
    wall = time.perf_counter() - t0
    per_step = {"upsample_nearest_2x": len(ups) + len(pools), "box_sum_2x": len(ups) + len(pools),
                "group_norm_forward": len(gn_sites), "group_norm_backward": len(gn_sites)}
    steps = {"unet": 1, "chain": MESH_STEPS, "joint": MESH_STEPS, "fleet": MESH_STEPS}
    ref = summary["reference"]
    for check, n in steps.items():
        check_counts(f"mesh reference {check}", ref[check]["launches"],
                     {k: v * n for k, v in per_step.items()})
    out = dict(reference=ref, held_bytes=held, wall_seconds=wall,
               ranks_seconds=summary["ranks_seconds"], meshes={})
    for mesh_name, ranks in summary["meshes"].items():
        rows = []
        for r in ranks:
            for check, c in r["checks"].items():
                check_counts(f"mesh {mesh_name} rank {r['rank']} {check}", c["launches"],
                             ref[check]["launches"])
            half = r["full_parameter_bytes"] - r["sharded_parameter_bytes"] + \
                r["sharded_parameter_bytes"] // r["mesh"]["tp"]
            if r["local_parameter_bytes"] != half:
                raise AssertionError(f"mesh {mesh_name} rank {r['rank']}: holds "
                                     f"{r['local_parameter_bytes']} parameter bytes, the layout "
                                     f"predicts {half}")
            rows.append(r)
            diffs = "; ".join(f"{check} " + ", ".join(
                f"{k} {d['max_abs']:.2e}/{d['max_rel']:.2e}" for k, d in dd.items())
                for check, dd in r["differences"].items())
            whole = "; ".join(f"{check} " + ", ".join(
                f"{k} {d['max_abs']:.2e}" for k, d in r[f"whole_batch_{check}_differences"].items())
                for check in r["differences"] if f"whole_batch_{check}_differences" in r)
            dp = r["mesh"]["dp"]
            alone = {c: (ref[c]["peak_bytes"] if dp == 1 else
                         max(ref[f"fleet/{dp}"]["group_peak_bytes"])) - held for c in r["checks"]}
            log(f"  mesh {mesh_name} rank {r['rank']}: parameters {r['local_parameter_bytes'] / 2 ** 30:.3f}"
                f" of {r['full_parameter_bytes'] / 2 ** 30:.3f} GiB; peaks "
                f"{ {c: round(v['peak_bytes'] / 2 ** 30, 2) for c, v in r['checks'].items()} } GiB "
                f"(one process at the rank's batch: "
                f"{ {c: round(v / 2 ** 30, 2) for c, v in alone.items()} } GiB);"
                f" seconds { {c: round(v['seconds'], 2) for c, v in r['checks'].items()} }; "
                f"launches {r['checks'][next(iter(r['checks']))]['launches']}; max abs / rel "
                f"differences from one process: {diffs}"
                + (f"; max abs from the whole batch in one call (reported): {whole}" if whole
                   else ""))
        out["meshes"][mesh_name] = rows
    out["bar"] = summary["bar"]
    log_bar(summary["bar"])
    log(f"  one process: seconds { {c: round(v['seconds'], 2) for c, v in ref.items()} }, peaks "
        f"{ {c: round((v['peak_bytes'] - held) / 2 ** 30, 2) for c, v in ref.items()} } GiB "
        f"(above the {held / 2 ** 30:.2f} GiB it held before); the ranks "
        f"took {summary['ranks_seconds']:.1f} s (start, load and shard included); gloo moves "
        "the collectives through host memory, so these times are the one-card check's, not tp's")

    from osmosis_tpu_torch.models.convert import load_unet
    from osmosis_tpu_torch.models.unet import UNetConfig
    from osmosis_tpu_torch.utils import zstd

    rec = np.load(ORBAX_FIXTURE + "_forward.npz")
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in json.loads(str(rec["config"])).items()}
    t0 = time.perf_counter()
    model = load_unet(ORBAX_FIXTURE, UNetConfig(**kw), "cuda")
    read_s = time.perf_counter() - t0
    with torch.no_grad():
        got = model(torch.from_numpy(rec["x"]).cuda(), torch.from_numpy(rec["t"]).cuda())
    err = check_close("orbax fixture forward on the card", got.cpu(), torch.from_numpy(rec["out"]),
                      "orbax", "float32")
    decoder = zstd.decoder()
    if not decoder.startswith("native"):
        raise AssertionError(f"the orbax fixture was read by the {decoder} zstd decoder")
    log(f"  orbax fixture {os.path.relpath(ORBAX_FIXTURE, ROOT)} read by load_unet in {read_s:.2f} s"
        f" (zstd decoder: {decoder}); its forward on the card against the recorded one: max abs "
        f"{err:.2e} (rtol 1e-3, atol 5e-4)")
    out["orbax"] = dict(read_seconds=read_s, max_abs_err=err, decoder=decoder)
    del model
    out["orbax_full_width"] = orbax_full_width(workdir, checkpoint)
    return out


def log_bar(bar):
    """One line for each mesh and chain check of ``tools.mesh_check``'s
    excuse (``summary["bar"]``): the UNet's measured relative difference,
    the EPS of the perturbed one-process runs and what they moved (run only
    where a value is to be excused), and each
    rank's clamp flips, sample values past 5e-4, excused values and x0-hat
    values past 5e-4 (never excused)."""
    for mesh_name, checks in bar.items():
        for check, b in checks.items():
            moved = "not run, nothing to excuse" if b["perturbed"] is None else "; ".join(
                f"{p['clamp_flips']} flips, {p['sample_misses']} misses, {p['sample_max_abs']:.2e}"
                for p in b["perturbed"])
            ranks = ", ".join(f"rank {k}: {r['clamp_flips']} flips, {r['sample_misses']} misses, "
                              f"{r['excused']} excused, x0-hat {r['x0_misses']} misses"
                              for k, r in b["ranks"].items())
            log(f"  bar {mesh_name} {check}: UNet {b['measured']:.2e} relative, EPS {b['eps']:.1e}"
                f" (perturbed runs: {moved}); {ranks}")


def orbax_full_width(workdir, checkpoint):
    """The seeded 552.8M tree (the checkpoint of phase 5) written by
    ``save_params_orbax`` and read back by ``load_unet`` onto the card: its
    forward on a seeded input bit for bit the one of the model loaded from
    the checkpoint itself. Write and read seconds are host numbers."""
    import shutil

    import torch

    from osmosis_tpu_torch.config import load_yaml
    from osmosis_tpu_torch.models.convert import (
        load_unet, params_from_state_dict, save_params_orbax,
    )
    from osmosis_tpu_torch.models.unet import unet_config_from_yaml

    cfg = unet_config_from_yaml(load_yaml(os.path.join(
        ROOT, "configs", "osmosis_sample_config.yaml"))["unet_model"])
    params = params_from_state_dict(torch.load(checkpoint, map_location="cpu",
                                               weights_only=True), cfg)
    path = os.path.join(workdir, "seeded.orbax")
    t0 = time.perf_counter()
    save_params_orbax(params, path)
    write_s = time.perf_counter() - t0
    del params
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
    t0 = time.perf_counter()
    back = load_unet(path, cfg, "cuda")
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    model = load_unet(checkpoint, cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((1, 256, 256, 4), generator=gen, device="cuda")
    t = torch.tensor([500.0], device="cuda")
    with torch.no_grad():
        a, b = model(x, t), back(x, t)
    if not torch.equal(a, b):
        raise AssertionError(f"the seeded tree through orbax: forward off by "
                             f"{float((a - b).abs().max()):.3e}")
    shutil.rmtree(path)
    log(f"  the seeded 552.8M tree written by save_params_orbax ({size / 1e9:.3f} GB) in "
        f"{write_s:.2f} s and read back by load_unet onto the card in {read_s:.2f} s (host "
        f"seconds); its forward equals the in-memory model's bit for bit")
    return dict(write_seconds=write_s, read_seconds=read_s, bytes=size)


def image_step_seconds(per_rank, steps):
    """Seconds per image-step of a run whose ranks (a list of progress rows
    each) start their image loops together, after the run dir's barrier: the
    slowest rank's sum over its images, of ``seconds`` (each image with its
    post-processing) and of ``sample_seconds`` (its chain), over the
    image-steps of all ranks; the ``warm_`` keys leave each rank's first
    image (its warm-up) out."""
    out = {}
    for tag, skip in (("", 0), ("warm_", 1)):
        n = sum(len(rows) - skip for rows in per_rank) * steps
        for field in ("seconds", "sample_seconds"):
            out[tag + field] = max(sum(r[field] for r in rows[skip:]) for rows in per_rank) / n
    return out


def train_row(name, training, report):
    """What the training path adds to a kernel's numbers: its launches over
    the timed train steps, and for K4 its phase-11 times with the parameter
    sums (per train step at batch TRAIN_BATCH). K1-K3 run there at the sites
    and shapes of the batch-4 guided step, whose times are the b4_* keys."""
    row = dict(train_launches=training["launches"][name])
    if name == "group_norm_backward":
        t = report["group_norm_backward_train_b4"]
        row.update(train_param_sums_max_abs_err=t["max_abs_err"], train_param_sums_ms=t["ms"],
                   train_param_sums_eager_ms=t["eager_ms"], train_param_sums_plain_ms=t["plain_ms"],
                   train_param_sums_bound_ms=t["bound_ms"],
                   train_param_sums_library_ms=t["library_ms"])
    return row


def phi_fit_row(phi_fit, main_path, hybrid, fleet, served, multihost, runbook):
    """K5's row of the ``kernels`` line: phase 3's times a step (a step's
    phi-only passes at 256x256; ``library_ms`` is the eager autograd loop it
    replaces) and its launches in the phases that count them."""
    b1, b4 = phi_fit["b1"], phi_fit["b4"]
    return dict(name="phi_fit", route="cuda", source="osmosis_tpu_torch/ops/csrc/phi_fit.cu",
                replaces="osmosis_tpu/diffusion/guided.py:397-425", passes=b1["passes"],
                launches=main_path["launches"]["phi_fit"], max_abs_err=b1["max_abs_err"],
                library_max_abs_err=b1["library_max_abs_err"], ms=b1["ms"],
                eager_ms=b1["eager_ms"], plain_ms=b1["plain_ms"], bound_ms=b1["bound_ms"],
                bound_by="bytes", library_ms=b1["library_ms"],
                bf16_hybrid_launches=hybrid["launches"]["phi_fit"],
                b4_max_abs_err=b4["max_abs_err"], b4_ms=b4["ms"], b4_eager_ms=b4["eager_ms"],
                b4_plain_ms=b4["plain_ms"], b4_bound_ms=b4["bound_ms"],
                b4_library_ms=b4["library_ms"],
                fleet_fp32_launches=fleet["float32"]["launches"]["phi_fit"],
                fleet_bf16_launches=fleet["bfloat16"]["launches"]["phi_fit"],
                serve_launches_per_request=served["launches_per_request"]["phi_fit"],
                multihost_launches_per_rank=[c["phi_fit"] for c in multihost["preset"]["launches"]],
                runbook_launches_per_preset={p: runbook["launches"][p]["phi_fit"]
                                             for p in RUNBOOK_PRESETS},
                segment_launches=hybrid["phi_fit_segment"]["counts"]["phi_fit.launches"])


def check_native_crc32c():
    """The native CRC-32C against its Python twin (and the CRC's check
    value), on buffers of every length class."""
    import numpy as np

    from osmosis_tpu_torch.utils import native, ocdbt

    if native.crc32c(b"123456789") != 0xE3069283:
        raise AssertionError("native CRC-32C: wrong check value")
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 4096, 131071, 131072, 131073, 1 << 20):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        if native.crc32c(data) != ocdbt.crc32c_py(data):
            raise AssertionError(f"native CRC-32C differs from the Python twin at {n} bytes")
    big = rng.integers(0, 256, 1 << 28, dtype=np.uint8)
    t0 = time.perf_counter()
    native.crc32c(big)
    crc_s = time.perf_counter() - t0
    log(f"  native CRC-32C equals its Python twin; CRC-32C of 256 MiB in {crc_s:.3f} s "
        f"({(1 << 28) / crc_s / 1e9:.2f} GB/s, host CPU)")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "osmosis_tpu_torch")):
        print("chip_smoke: the osmosis_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--rank-worker"]:
        return rank_worker(sys.argv[2:])
    import tempfile

    from osmosis_tpu_torch.config import load_yaml
    from osmosis_tpu_torch.models.convert import load_unet
    from osmosis_tpu_torch.models.unet import UNetConfig, unet_config_from_yaml
    from osmosis_tpu_torch.ops import _build

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1/21] device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[2/21] built CUDA kernels {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    from osmosis_tpu_torch.utils import native

    t0 = time.perf_counter()
    lib = native.build()  # raises with the compiler's output where it fails
    if not native.available():
        raise AssertionError(f"the native host ops built but are not in use: {native.status()}")
    log(f"  built the native host ops {os.path.basename(lib)} in {time.perf_counter() - t0:.1f} s"
        f" (g++ {' '.join(native.CXX_FLAGS)}, zlib)")
    check_native_crc32c()

    log("[3/21] kernels against their plain versions at the main path's shapes")
    gn_sites, ups, pools = main_path_sites(UNetConfig())
    k_hybrid = int(load_yaml(os.path.join(ROOT, "configs", "osmosis_sample_hybrid_config.yaml"))[
        "conditioning"]["params"]["x_prev_every"])
    report = {}
    rows = check_resample_kernels(ups, pools, report, k_hybrid)
    rows += check_norm_kernels(gn_sites, report, k_hybrid)
    phi_fit = check_phi_fit_kernel(
        load_yaml(os.path.join(ROOT, "configs", "osmosis_sample_hybrid_config.yaml")), report)

    log("[4/21] tiny UNet: card (kernels) against CPU (plain versions), TF32 off")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = check_tiny_unet()

    log(f"[5/21] main path at full width: preset, {STEPS} respaced steps, one image")
    build_dir = os.path.join(ROOT, "osmosis_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as workdir:
        main_path = run_main_path(workdir)
        main_path["warm_seconds_per_step"], main_path["busy"] = time_guided_steps(workdir)
        log(f"  seconds per guided step: {main_path['seconds_per_step']:.4f} over the main "
            f"path's {STEPS}-step chain, {main_path['warm_seconds_per_step']:.4f} warm; peak "
            f"memory {main_path['peak_bytes'] / 2 ** 30:.2f} GiB (max_memory_allocated over the "
            f"main path); {smi}")
        check_counts("main path", main_path["launches"], {
            "upsample_nearest_2x": (len(ups) + len(pools)) * STEPS,
            "box_sum_2x": (len(ups) + len(pools)) * STEPS,
            "group_norm_forward": len(gn_sites) * STEPS,
            "group_norm_backward": len(gn_sites) * STEPS, "phi_fit": phi_fit_steps(STEPS)})
        ckpt = main_path["checkpoint"]

        log(f"[6/21] bf16 fast path at full width: the hybrid preset, ddim{STEPS}, one image")
        hybrid, model, hybrid_cfg = run_bf16_hybrid(workdir, ckpt, gn_sites, ups, pools)
        log("[7/21] bf16 timing by step kind, busy share, UNet rate")
        hybrid.update(time_bf16_steps(model, hybrid_cfg))
        hybrid["phi_fit_segment"] = check_phi_fit_segment(model, hybrid_cfg)
        del model
        log(f"  bf16 seconds per warm step: x_prev {hybrid['x_prev_seconds_per_step']:.4f}, x0 "
            f"{hybrid['x0_seconds_per_step']:.4f}; {smi}")

        log(f"[8/21] RGBD prior sampler at full width: {STEPS} steps, one image, fp32")
        prior = run_prior(workdir, ckpt, gn_sites, ups, pools, steps=STEPS)
        log(f"  seconds per prior step: {prior['seconds_per_step']:.4f}; {smi}")

        log("[9/21] rgb_guidance at full width: 10 steps, one image, fp32")
        rgb = run_rgb_guidance(workdir, ckpt, gn_sites, ups, pools, steps=10)

        log(f"[10/21] haze and simulation presets at full width: {STEPS} steps, one image each, "
            "fp32")
        presets = run_haze_and_simulation(workdir, ckpt, gn_sites, ups, pools)

        log(f"[11/21] kernels at batch {FLEET} against their plain versions at the main path's "
            "shapes")
        gn4, ups4, pools4 = main_path_sites(UNetConfig(), batch=FLEET)
        rows += check_resample_kernels(ups4, pools4, report, k_hybrid, suffix="_b4")
        rows += check_norm_kernels(gn4, report, k_hybrid, batch=FLEET, suffix="_b4")

        log(f"[12/21] the batch-{FLEET} fleet at full width: fp32 preset ({STEPS} steps) and bf16 "
            f"hybrid preset (ddim{STEPS}), {FLEET} seeded images, clip_denoised")
        fleet = run_fleet(workdir, ckpt, gn_sites, ups, pools, k_hybrid)
        ucfg = unet_config_from_yaml(load_yaml(os.path.join(
            ROOT, "configs", "osmosis_sample_config.yaml"))["unet_model"])
        models = {"float32": load_unet(ckpt, ucfg, "cuda"),
                  "bfloat16": load_unet(ckpt, ucfg, "cuda", dtype=torch.bfloat16)}
        fleet["lane_parity"] = check_lane_parity(models)
        fleet["timing"] = time_fleet(models, {
            "float32": load_yaml(os.path.join(ROOT, "configs", "osmosis_sample_config.yaml")),
            "bfloat16": hybrid_cfg})
        del models
        log(f"  {smi}")

        log(f"[13/21] segments and resume: bf16 hybrid preset, ddim{STEPS}, progress_segments 4, "
            "chain_checkpoint, a crash after the first boundary; then the fp32 preset, likewise")
        segments = run_segments_and_resume(workdir, ckpt, gn_sites, ups, pools, k_hybrid)

        log("[14/21] best_of 2 with phi_jitter, global_N 2 with global_eta_scale 0.5, async_save:"
            " bf16 hybrid preset, ddim10, one image")
        restarts = run_restarts(workdir, ckpt, gn_sites, ups, pools, k_hybrid)

        log(f"[15/21] training at full width: toy_unet_config(256, 256, 'production'), batch "
            f"{TRAIN_BATCH}, fp32, Adam and the EMA")
        training = run_training(main_path["n_params"], gn_sites, ups, pools)
        log(f"  seconds per train step {training['seconds_per_step']:.4f} (batch {TRAIN_BATCH}), "
            f"per image {training['seconds_per_image']:.4f}; peak {training['peak_bytes'] / 2 ** 30:.2f}"
            f" GiB; {smi}")

        log("[16/21] the toy loop: train_toy_prior at 32x32, 300 steps at batch 128, then a "
            "restore run from its EMA checkpoint; a tiny train step card vs CPU")
        toy = run_toy_loop(workdir)
        toy["card_vs_cpu"] = check_train_step_card_vs_cpu()

        log(f"[17/21] the server at full width: the fast preset (bf16, x_prev every step), "
            f"ddim{STEPS}, three requests")
        served = run_serve(workdir, ckpt, gn_sites, ups, pools)
        log(f"  ms per request {served['ms_per_request']}, per step "
            f"{[round(m, 1) for m in served['ms_per_step']]}; {smi}")

        log("[18/21] the quality tools at toy size: simulate_degraded, validate_toy_e2e, "
            "demo_toy_restore, validate_checkpoint --tiny")
        quality = run_quality_tools(workdir, toy["checkpoint"])

        log(f"[19/21] two ranks on one card through the CLI: the fp32 preset ({MH_STEPS} steps, 3 "
            f"images) against one process, the prior, the fp32 and bf16 hybrid presets timed")
        t0 = time.perf_counter()
        multihost = run_multihost(workdir, ckpt, gn_sites, ups, pools, k_hybrid)
        log(f"  phase 19 took {time.perf_counter() - t0:.1f} s; {smi}")

        log(f"[20/21] the day-one runbook at full width ({','.join(RUNBOOK_PRESETS)}; ddim"
            f"{RUNBOOK_STEPS}, one image), seed_replicate on phase 16's toy EMA, the native "
            "host ops")
        t0 = time.perf_counter()
        runbook = run_runbook(workdir, ckpt, gn_sites, ups, pools)
        runbook["seed_replicate"] = run_seed_replicate(workdir, toy["checkpoint"])
        runbook["native"] = run_native_host_ops(workdir)
        log(f"  phase 20 took {time.perf_counter() - t0:.1f} s; {smi}")

        log(f"[21/21] the (dp, tp) mesh on one card: two ranks over gloo, tp=2 (UNet forward and "
            f"x-pullback, the {MESH_STEPS}-step chain) and dp=2 (the joint-loss chain at batch "
            f"{MESH_LANES}, the fleet at N={MESH_LANES}) against one process at full width; the "
            "orbax fixture on the card; the seeded tree written and read as orbax")
        t0 = time.perf_counter()
        mesh = run_mesh(workdir, ckpt, gn_sites, ups, pools)
        log(f"  phase 21 took {time.perf_counter() - t0:.1f} s; {smi}")

    meta = {
        "upsample_nearest_2x": ("cuda", "osmosis_tpu_torch/ops/csrc/upsample.cu",
                                "osmosis_tpu/ops/upsample.py:55"),
        "box_sum_2x": ("cuda", "osmosis_tpu_torch/ops/csrc/upsample.cu",
                       "osmosis_tpu/ops/upsample.py:70"),
        "group_norm_forward": ("cuda", "osmosis_tpu_torch/ops/csrc/group_norm.cu",
                               "osmosis_tpu/models/nn.py:72"),
        "group_norm_backward": ("cuda", "osmosis_tpu_torch/ops/csrc/group_norm.cu",
                                "osmosis_tpu/models/nn.py:98"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        agg = report[name]
        hyb = report[name + "_bf16_hybrid"]
        b4, hyb4 = report[name + "_b4"], report[name + "_bf16_hybrid_b4"]
        kernels.append(dict(name=name, route=route, source=source, replaces=replaces,
                            launches=main_path["launches"][name],
                            max_abs_err=agg["max_abs_err"], ms=agg["ms"],
                            plain_ms=agg["plain_ms"], bound_ms=agg["bound_ms"],
                            bound_by="bytes", library_ms=agg["library_ms"],
                            bf16_hybrid_launches=hybrid["launches"][name],
                            bf16_hybrid_max_abs_err=hyb["max_abs_err"],
                            bf16_hybrid_ms_per_step=hyb["ms"],
                            bf16_hybrid_eager_ms_per_step=hyb["eager_ms"],
                            bf16_hybrid_plain_ms_per_step=hyb["plain_ms"],
                            bf16_hybrid_bound_ms_per_step=hyb["bound_ms"],
                            bf16_hybrid_library_ms_per_step=hyb["library_ms"],
                            b4_max_abs_err=b4["max_abs_err"], b4_ms=b4["ms"],
                            b4_eager_ms=b4["eager_ms"], b4_plain_ms=b4["plain_ms"],
                            b4_bound_ms=b4["bound_ms"], b4_library_ms=b4["library_ms"],
                            b4_bf16_hybrid_ms_per_step=hyb4["ms"],
                            b4_bf16_hybrid_eager_ms_per_step=hyb4["eager_ms"],
                            b4_bf16_hybrid_plain_ms_per_step=hyb4["plain_ms"],
                            b4_bf16_hybrid_bound_ms_per_step=hyb4["bound_ms"],
                            b4_bf16_hybrid_library_ms_per_step=hyb4["library_ms"],
                            b4_bf16_hybrid_max_abs_err=hyb4["max_abs_err"],
                            fleet_fp32_launches=fleet["float32"]["launches"][name],
                            fleet_bf16_launches=fleet["bfloat16"]["launches"][name],
                            serve_launches_per_request=served["launches_per_request"][name],
                            multihost_launches_per_rank=[
                                c[name] for c in multihost["preset"]["launches"]],
                            runbook_launches_per_preset={
                                p: runbook["launches"][p][name] for p in RUNBOOK_PRESETS},
                            mesh_launches_per_rank={
                                f"{m}_{check}": [r["checks"][check]["launches"][name]
                                                 for r in ranks]
                                for m, ranks in mesh["meshes"].items()
                                for check in ranks[0]["checks"]},
                            **train_row(name, training, report)))
    k5 = phi_fit_row(phi_fit, main_path, hybrid, fleet, served, multihost, runbook)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(dict(device=kind, nvidia_smi=smi, kernels=kernels + [k5], rows=rows,
                       tiny_unet=tiny,
                       main_path=main_path, bf16_hybrid=hybrid, prior=prior, rgb_guidance=rgb,
                       phi_fit=phi_fit, presets=presets, fleet=fleet, segments=segments,
                       restarts=restarts,
                       training=training, toy=toy, serve=served, quality=quality,
                       multihost=multihost, runbook=runbook, mesh=mesh,
                       seconds=time.perf_counter() - t_start), f, indent=1, default=str)
    log(f"  per-shape rows in results/chip_smoke_report.json; "
        f"total {time.perf_counter() - t_start:.1f} s")
    log("  kernel ms / plain_ms / bound_ms / library_ms: fp32 device times (ten calls a "
        "CUDA graph, replayed), summed over one guided step's call sites")
    for k in kernels:
        log(f"    {k['name']}: {k['ms']:.3f} ms (eager calls {report[k['name']]['eager_ms']:.3f})"
            f" plain {k['plain_ms']:.3f} library {k['library_ms']:.3f} bound "
            f"{k['bound_ms']:.3f} launches {k['launches']}")
    log(f"  bf16 hybrid path (k = {k_hybrid}), device ms per step on average (kernel / eager / "
        "plain / library / bound), launches over its run:")
    for k in kernels:
        log(f"    {k['name']}: {k['bf16_hybrid_ms_per_step']:.3f} / "
            f"{k['bf16_hybrid_eager_ms_per_step']:.3f} / "
            f"{k['bf16_hybrid_plain_ms_per_step']:.3f} / {k['bf16_hybrid_library_ms_per_step']:.3f}"
            f" / {k['bf16_hybrid_bound_ms_per_step']:.3f}; launches {k['bf16_hybrid_launches']}")
    log(f"  batch {FLEET}, device ms per step (fp32 kernel / plain / library / bound; bf16 hybrid "
        "kernel / library / bound), launches over the fleet runs (fp32, bf16):")
    for k in kernels:
        log(f"    {k['name']}: {k['b4_ms']:.3f} / {k['b4_plain_ms']:.3f} / {k['b4_library_ms']:.3f}"
            f" / {k['b4_bound_ms']:.3f}; {k['b4_bf16_hybrid_ms_per_step']:.3f} / "
            f"{k['b4_bf16_hybrid_library_ms_per_step']:.3f} / "
            f"{k['b4_bf16_hybrid_bound_ms_per_step']:.3f}; launches {k['fleet_fp32_launches']}, "
            f"{k['fleet_bf16_launches']}")
    log(f"  training, batch {TRAIN_BATCH}: launches over {TRAIN_TIMED} timed steps (K1-K3 run "
        f"at the batch-{FLEET} sites above); K4 with the parameter sums, device ms per train "
        "step (kernel / plain / library / bound):")
    for k in kernels:
        sums = "" if "train_param_sums_ms" not in k else (
            f"; {k['train_param_sums_ms']:.3f} / {k['train_param_sums_plain_ms']:.3f} / "
            f"{k['train_param_sums_library_ms']:.3f} / {k['train_param_sums_bound_ms']:.3f}")
        log(f"    {k['name']}: launches {k['train_launches']}{sums}")
    log(f"  phi_fit (K5), {k5['passes']} passes at 256x256, device ms a step (kernel / plain / "
        f"the eager loop it replaces / bound), batch 1: {k5['ms']:.3f} / {k5['plain_ms']:.3f} / "
        f"{k5['library_ms']:.3f} / {k5['bound_ms']:.4f}; batch {FLEET}: {k5['b4_ms']:.3f} / "
        f"{k5['b4_plain_ms']:.3f} / {k5['b4_library_ms']:.3f} / {k5['b4_bound_ms']:.4f}; launches "
        f"main path {k5['launches']}, bf16 hybrid {k5['bf16_hybrid_launches']}, fleet "
        f"{k5['fleet_fp32_launches']} / {k5['fleet_bf16_launches']}, serve "
        f"{k5['serve_launches_per_request']} a request, runbook "
        f"{k5['runbook_launches_per_preset']}")
    print(json.dumps({"kernels": kernels + [k5]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
