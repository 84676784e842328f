#!/usr/bin/env python3
"""Smoke run of osmosis_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failed check:
  1. device: the card's name and power limit;
  2. build: the CUDA C++ kernels (K1-K4) from osmosis_tpu_torch/ops/csrc with
     nvcc for sm_90a, one nvcc per source, all started together;
  3. kernels: every kernel (K1-K4) against its plain PyTorch version at every
     shape the main path gives it, fp32 and bf16, forward and backward (K4
     with and without its parameter sums), timed
     on the device (ten calls captured in one CUDA graph, replayed) and
     eagerly, beside its
     plain version, its byte bound and one PyTorch library call that
     computes the same function; K3/K4 also give the same bits on a second
     call and launch the device kernels their geometry plans (1 or 2);
  4. a tiny UNet, forward and x-VJP, through the kernels on the card against
     the plain versions on the CPU;
  5. the main path at full width: the reference preset through
     ``run_restoration`` (the CLI's entry point) with a seeded random-init
     checkpoint, 20 respaced steps, one image; the kernels' launch counts are
     zeroed just before and read just after. Then the first step's UNet
     forward and pullback, timed and FLOP-counted, seconds per warm guided
     step, and the device's busy share over one warm guided step from
     ``torch.profiler``;
  6. the bf16 fast path at full width: the hybrid preset (bf16 torso, the
     UNet pullback at every 4th step, the x0 gradient between) through
     ``run_restoration`` with ddim20, one image, the same checkpoint; the
     launch counts are asserted per step kind (K3 at every step, K4 and the
     backward resampling at the x_prev steps only) and the loaded torso's
     dtypes printed;
  7. bf16 timing: seconds per warm x_prev step and per warm x0 step, the
     busy share over a warm hybrid chain, the bf16 UNet forward and forward +
     pullback against the 989 TFLOP/s bf16 peak;
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
     random-init fallback; one tiny train step on the card against the CPU.
The line before the last gives the card's name and power limit, the one
before it the kernels' JSON summary (each kernel's fp32 numbers on the main
path, its bf16 per-step numbers on the hybrid path, at batch 4, and per train
step); the last line is the result.
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
#   bf16: the output is rounded to bf16 (8 bits of mantissa), and the plain
#   version rounds each intermediate to bf16 where the kernel keeps fp32.
TOL = {
    ("resample", "float32"): (0.0, 0.0),
    ("resample", "bfloat16"): (0.0, 0.0),
    ("norm", "float32"): (1e-4, 1e-5),
    ("norm", "bfloat16"): (3e-2, 3e-2),
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

            k0 = (G.group_norm_forward.kernel_launches, G.group_norm_backward.kernel_launches)
            y, m, i = G.group_norm_forward(x, wgt, bias, fs, ft, silu)
            k1 = G.group_norm_forward.kernel_launches
            grads = G.group_norm_backward(gy, x, wgt, bias, fs, ft, silu, m, i)
            k2 = G.group_norm_backward.kernel_launches
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
    from osmosis_tpu_torch.ops import group_norm as G
    from osmosis_tpu_torch.ops import upsample as U

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
    before = (U.upsample_nearest_2x_kernel.launches, U.box_sum_2x_kernel.launches,
              G.group_norm_forward.launches, G.group_norm_backward.launches)
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        xd = x.to(dev).requires_grad_(True)
        y = model(xd, t.to(dev))
        (dx,) = torch.autograd.grad(y, xd, g.to(dev))
        outs.append((y.detach().cpu(), dx.cpu()))
    after = (U.upsample_nearest_2x_kernel.launches, U.box_sum_2x_kernel.launches,
             G.group_norm_forward.launches, G.group_norm_backward.launches)
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

def kernel_counters():
    from osmosis_tpu_torch.ops import group_norm as G
    from osmosis_tpu_torch.ops import upsample as U

    return {"upsample_nearest_2x": U.upsample_nearest_2x_kernel,
            "box_sum_2x": U.box_sum_2x_kernel,
            "group_norm_forward": G.group_norm_forward,
            "group_norm_backward": G.group_norm_backward}


def zero_counts():
    from osmosis_tpu_torch.ops import group_norm as G

    for fn in kernel_counters().values():
        fn.launches = 0
    G.group_norm_forward.kernel_launches = G.group_norm_backward.kernel_launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


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
    from osmosis_tpu_torch.models.convert import init_unet
    from osmosis_tpu_torch.models.unet import unet_config_from_yaml
    from osmosis_tpu_torch.ops import group_norm as G
    from osmosis_tpu_torch.pipelines.restore import run_restoration

    cfg_yaml = load_yaml(os.path.join(ROOT, "configs", "osmosis_sample_config.yaml"))
    ucfg = unet_config_from_yaml(cfg_yaml["unet_model"])
    t0 = time.perf_counter()
    model = randomize_zero_inits(init_unet(ucfg, seed=0), seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    pt = os.path.join(workdir, "random_init.pt")
    torch.save(model.state_dict(), pt)
    del model
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
    gn_kernels = {"group_norm_forward": G.group_norm_forward.kernel_launches,
                  "group_norm_backward": G.group_norm_backward.kernel_launches}
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

    import osmosis_tpu_torch.pipelines.restore as R

    path, cfg = write_preset(workdir, "osmosis_sample_hybrid_config.yaml", checkpoint,
                             timestep_respacing=f"ddim{STEPS}")
    k = int(cfg["conditioning"]["params"]["x_prev_every"])
    full = len(range(0, STEPS, k))  # x_prev steps: chain positions 0, k, 2k, ...
    loaded = []
    load_unet = R.load_unet
    R.load_unet = lambda *a, **kw: loaded.append(load_unet(*a, **kw)) or loaded[-1]
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        out = R.run_restoration(path, device="cuda:0")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        R.load_unet = load_unet
    peak = torch.cuda.max_memory_allocated()
    expected = {"group_norm_forward": len(gn_sites) * STEPS,
                "group_norm_backward": len(gn_sites) * full,
                "upsample_nearest_2x": len(ups) * STEPS + len(pools) * full,
                "box_sum_2x": len(pools) * STEPS + len(ups) * full}
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
        "upsample_nearest_2x": len(ups) * steps, "box_sum_2x": len(pools) * steps})
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
        "box_sum_2x": (len(ups) + len(pools)) * steps})
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


def preset_counts(gn_sites, ups, pools, steps, full_steps):
    """Launches of a run: K3 and the forward resampling at every step, K4 and
    the backward resampling at the ``full_steps`` x_prev steps."""
    return {"group_norm_forward": len(gn_sites) * steps,
            "group_norm_backward": len(gn_sites) * full_steps,
            "upsample_nearest_2x": len(ups) * steps + len(pools) * full_steps,
            "box_sum_2x": len(pools) * steps + len(ups) * full_steps}


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
            path, key, preset_counts(gn_sites, ups, pools, STEPS, STEPS))
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
            path, f"fleet {key}", preset_counts(gn_sites, ups, pools, STEPS, n_full))
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
    uninterrupted chain_checkpoint run's byte for byte."""
    import osmosis_tpu_torch.pipelines.restore as R

    full = len(range(0, STEPS, k_hybrid))
    counts = preset_counts(gn_sites, ups, pools, STEPS, full)
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

    path, _ = write_preset(workdir, "osmosis_sample_hybrid_config.yaml", checkpoint,
                           name="seg_crash.yaml", timestep_respacing=f"ddim{STEPS}",
                           clip_denoised=True, top=dict(
                               progress_segments=4, chain_checkpoint=True,
                               save_dir=os.path.join(workdir, "seg_crash")))
    os.environ["OSMOSIS_TPU_CRASH_AFTER_SEGMENTS"] = str(R._CRASH_SAVES["n"] + 1)
    try:
        R.run_restoration(path, device="cuda:0")
        raise AssertionError("the crash hook did not fire")
    except RuntimeError as e:
        if "injected crash" not in str(e):
            raise
        log(f"  crashed as injected: {e}")
    finally:
        del os.environ["OSMOSIS_TPU_CRASH_AFTER_SEGMENTS"]
    path, _ = write_preset(workdir, "osmosis_sample_hybrid_config.yaml", checkpoint,
                           name="seg_resume.yaml", timestep_respacing=f"ddim{STEPS}",
                           clip_denoised=True, top=dict(
                               progress_segments=4, chain_checkpoint=True, resume=True,
                               save_dir=os.path.join(workdir, "seg_crash")))
    resumed_counts = preset_counts(gn_sites, ups, pools, STEPS - 4, full - 1)
    rd, _, _, _ = run_counted(path, "resume", resumed_counts)
    with open(os.path.join(rd, "log.txt")) as f:
        if "resuming chain at step 4/20" not in f.read():
            raise AssertionError("the resumed run did not continue from step 4")
    resumed = png_bytes(rd)
    if resumed != runs["checkpoint"] or len(resumed) != 6:
        raise AssertionError("the resumed run's PNGs differ from the uninterrupted run's")
    log(f"  crash after the first boundary, resume from step 4/{STEPS}: the {len(resumed)} PNGs "
        "equal the uninterrupted run's byte for byte")
    out.update(same_without_deterministic=same_plain,
               checkpoint_equals_plain=runs["checkpoint"] == runs["plain_a"],
               resumed_bitwise=True)
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
        gn_sites, ups, pools, chains * steps, chains * len(range(0, steps, k_hybrid))))
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
            "box_sum_2x": ((1 + again) * len(pools) + len(ups)) * steps}


def run_training(n_params_preset, gn_sites, ups, pools):
    """The trainer's step (``ToyTrainer``, what ``python -m
    osmosis_tpu_torch.tools.train_toy_prior`` runs) at the preset model's
    width, batch 4, fp32: TRAIN_WARM warm steps, then TRAIN_TIMED timed ones
    with the launch counts zeroed before and asserted after; the busy share
    over two more; then one step without and one with remat, each from a
    reset memory peak."""
    import dataclasses

    import torch

    from osmosis_tpu_torch.ops import group_norm as G
    from osmosis_tpu_torch.tools import train_toy_prior as P

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
    G.group_norm_backward.param_sum_launches = G.group_norm_backward.film_sum_launches = 0
    t0 = time.perf_counter()
    losses = torch.stack([tr.step() for _ in range(TRAIN_TIMED)])
    torch.cuda.synchronize()
    s = (time.perf_counter() - t0) / TRAIN_TIMED
    launches = read_counts()
    sums = (G.group_norm_backward.param_sum_launches, G.group_norm_backward.film_sum_launches)
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
    if not all(after[k] > before[k] for k in after):
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
    if not all(launches.values()):
        raise AssertionError(f"the toy run did not launch every kernel: {launches}")
    if not chunks[-1] < 0.8 * chunks[0]:
        raise AssertionError(f"the toy loss did not fall: {chunks[0]:.4f} -> {chunks[-1]:.4f}")

    path, cfg = write_preset(workdir, "osmosis_sample_config.yaml", out, name="toy_restore.yaml",
                             timestep_respacing=10, clip_denoised=True)
    cfg["unet_model"].update(TOY_UNET)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    loaded = []
    load_unet = R.load_unet
    R.load_unet = lambda *a, **kw: loaded.append(load_unet(*a, **kw)) or loaded[-1]
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            rd = R.run_restoration(path, device="cuda:0")
    finally:
        R.load_unet = load_unet
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
                restore_chain_finite=row["chain_finite"])


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
    import tempfile

    from osmosis_tpu_torch.config import load_yaml
    from osmosis_tpu_torch.models.convert import load_unet
    from osmosis_tpu_torch.models.unet import UNetConfig, unet_config_from_yaml
    from osmosis_tpu_torch.ops import _build

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1/16] device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[2/16] built CUDA kernels {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    log("[3/16] kernels against their plain versions at the main path's shapes")
    gn_sites, ups, pools = main_path_sites(UNetConfig())
    k_hybrid = int(load_yaml(os.path.join(ROOT, "configs", "osmosis_sample_hybrid_config.yaml"))[
        "conditioning"]["params"]["x_prev_every"])
    report = {}
    rows = check_resample_kernels(ups, pools, report, k_hybrid)
    rows += check_norm_kernels(gn_sites, report, k_hybrid)

    log("[4/16] tiny UNet: card (kernels) against CPU (plain versions), TF32 off")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = check_tiny_unet()

    log(f"[5/16] main path at full width: preset, {STEPS} respaced steps, one image")
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
            "group_norm_backward": len(gn_sites) * STEPS})
        ckpt = main_path["checkpoint"]

        log(f"[6/16] bf16 fast path at full width: the hybrid preset, ddim{STEPS}, one image")
        hybrid, model, hybrid_cfg = run_bf16_hybrid(workdir, ckpt, gn_sites, ups, pools)
        log("[7/16] bf16 timing by step kind, busy share, UNet rate")
        hybrid.update(time_bf16_steps(model, hybrid_cfg))
        del model
        log(f"  bf16 seconds per warm step: x_prev {hybrid['x_prev_seconds_per_step']:.4f}, x0 "
            f"{hybrid['x0_seconds_per_step']:.4f}; {smi}")

        log(f"[8/16] RGBD prior sampler at full width: {STEPS} steps, one image, fp32")
        prior = run_prior(workdir, ckpt, gn_sites, ups, pools, steps=STEPS)
        log(f"  seconds per prior step: {prior['seconds_per_step']:.4f}; {smi}")

        log("[9/16] rgb_guidance at full width: 10 steps, one image, fp32")
        rgb = run_rgb_guidance(workdir, ckpt, gn_sites, ups, pools, steps=10)

        log(f"[10/16] haze and simulation presets at full width: {STEPS} steps, one image each, "
            "fp32")
        presets = run_haze_and_simulation(workdir, ckpt, gn_sites, ups, pools)

        log(f"[11/16] kernels at batch {FLEET} against their plain versions at the main path's "
            "shapes")
        gn4, ups4, pools4 = main_path_sites(UNetConfig(), batch=FLEET)
        rows += check_resample_kernels(ups4, pools4, report, k_hybrid, suffix="_b4")
        rows += check_norm_kernels(gn4, report, k_hybrid, batch=FLEET, suffix="_b4")

        log(f"[12/16] the batch-{FLEET} fleet at full width: fp32 preset ({STEPS} steps) and bf16 "
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

        log(f"[13/16] segments and resume: bf16 hybrid preset, ddim{STEPS}, progress_segments 4, "
            "chain_checkpoint, a crash after the first boundary")
        segments = run_segments_and_resume(workdir, ckpt, gn_sites, ups, pools, k_hybrid)

        log("[14/16] best_of 2 with phi_jitter, global_N 2 with global_eta_scale 0.5, async_save:"
            " bf16 hybrid preset, ddim10, one image")
        restarts = run_restarts(workdir, ckpt, gn_sites, ups, pools, k_hybrid)

        log(f"[15/16] training at full width: toy_unet_config(256, 256, 'production'), batch "
            f"{TRAIN_BATCH}, fp32, Adam and the EMA")
        training = run_training(main_path["n_params"], gn_sites, ups, pools)
        log(f"  seconds per train step {training['seconds_per_step']:.4f} (batch {TRAIN_BATCH}), "
            f"per image {training['seconds_per_image']:.4f}; peak {training['peak_bytes'] / 2 ** 30:.2f}"
            f" GiB; {smi}")

        log("[16/16] the toy loop: train_toy_prior at 32x32, 300 steps at batch 128, then a "
            "restore run from its EMA checkpoint; a tiny train step card vs CPU")
        toy = run_toy_loop(workdir)
        toy["card_vs_cpu"] = check_train_step_card_vs_cpu()

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
                            **train_row(name, training, report)))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(dict(device=kind, nvidia_smi=smi, kernels=kernels, rows=rows, tiny_unet=tiny,
                       main_path=main_path, bf16_hybrid=hybrid, prior=prior, rgb_guidance=rgb,
                       presets=presets, fleet=fleet, segments=segments, restarts=restarts,
                       training=training, toy=toy,
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
