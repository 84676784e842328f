#!/usr/bin/env python3
"""Smoke run of osmosis_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failed check:
  1. device: the card's name and power limit;
  2. build: the CUDA C++ kernels (K1-K4) from osmosis_tpu_torch/ops/csrc with
     nvcc for sm_90a, one nvcc per source, all started together;
  3. kernels: every kernel (K1-K4) against its plain PyTorch version at every
     shape the main path gives it, fp32 and bf16, forward and backward, timed
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
     ``torch.profiler``.
The line before the last gives the card's name and power limit, the one
before it the kernels' JSON summary; the last line is the result.
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

def main_path_sites(cfg):
    """Per UNet forward: GroupNorm sites (C, H, W, mode) and the NHWC input
    shapes of the nearest-2x upsamples and the 2x2 pools."""
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
                pools.extend([(1, res, res, lay["in_ch"])] * 2)
                res //= 2
            elif kind == "res_up":
                ups.extend([(1, res, res, lay["in_ch"])] * 2)
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

def check_resample_kernels(ups, pools, report):
    import torch
    import torch.nn.functional as F

    from osmosis_tpu_torch.utils.timing import cuda_time_ms, graph_time_ms

    from osmosis_tpu_torch.ops import upsample as U

    rows = []
    # per guided step: K1 runs forward at every upsample and backward at every
    # pool (scale 0.25); K2 forward at every pool and backward at every upsample
    k1_sites = [(s, 1.0) for s in ups] + [((b, h // 2, w // 2, c), 0.25) for b, h, w, c in pools]
    k2_sites = [((b, 2 * h, 2 * w, c), 1.0) for b, h, w, c in ups] + [(s, 0.25) for s in pools]
    for name, sites, kernel, plain in (
            ("upsample_nearest_2x", k1_sites, U.upsample_nearest_2x_kernel,
             U.upsample_nearest_2x_plain),
            ("box_sum_2x", k2_sites, U.box_sum_2x_kernel, U.box_sum_2x_plain)):
        agg = dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
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
                rows.append(dict(kernel=name, shape=list(shape), scale=scale, dtype=dn,
                                 per_step=n, max_abs_err=err, ms=t_k, eager_ms=t_e,
                                 plain_ms=t_p, library_ms=t_l, bound_ms=bound))
                log(f"  {name} {shape} x{scale} {dn}: err {err:.2e} kernel {t_k * 1e3:.1f} us"
                    f" (eager {t_e * 1e3:.1f}) plain {t_p * 1e3:.1f} library {t_l * 1e3:.1f}"
                    f" bound {bound * 1e3:.1f} (x{n} per step)")
                if dtype == torch.float32:  # the main path runs fp32
                    for k, v in (("ms", t_k), ("eager_ms", t_e), ("plain_ms", t_p),
                                 ("bound_ms", bound), ("library_ms", t_l)):
                        agg[k] += n * v
                    agg["max_abs_err"] = max(agg["max_abs_err"], err)
        report[name] = agg
    return rows


def check_norm_kernels(gn_sites, report):
    import torch
    import torch.nn.functional as F

    from osmosis_tpu_torch.utils.timing import cuda_time_ms, graph_time_ms

    from osmosis_tpu_torch.ops import group_norm as G

    rows = []
    agg_f = dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                 max_abs_err=0.0)
    agg_b = dict(agg_f)
    classes = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (c, h, w, mode), n in counted(gn_sites).items():
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]

            def rnd(*shape, scale=1.0, shift=0.0, dt=dtype):
                return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(dt)

            x = rnd(1, c, h, w, scale=1.5, shift=0.3).contiguous(memory_format=torch.channels_last)
            wgt, bias = rnd(c, scale=0.1, shift=1.0, dt=torch.float32), rnd(c, scale=0.1,
                                                                             dt=torch.float32)
            fs = rnd(1, c, scale=0.2) if mode == "film" else None
            ft = rnd(1, c, scale=0.2) if mode == "film" else None
            silu = mode != "none"
            gy = rnd(1, c, h, w).contiguous(memory_format=torch.channels_last)
            tag = f"group_norm C={c} {h}x{w} {mode} {dn}"

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
                p = G._device_plan(torch.cuda.current_device(), 1, c, h, w,
                                   G._DTYPE_CODES[dtype], G._mode(fs, silu), bwd, sums,
                                   G.MAX_CLUSTER)
                if k_call != p.kernels or k_call > 2:
                    raise AssertionError(f"{tag}: {k_call} device kernels in one call, "
                                         f"expected {p.kernels} ({p.geometry})")
                geo.append(f"{p.geometry}/{p.cluster}")
            err_f = check_close(tag + " forward", y, yp, "norm", dn)
            check_close(tag + " mean", m, mp, "norm", "float32")
            check_close(tag + " inv", i, ip, "norm", "float32")
            err_b = 0.0
            for gname, a, b in zip(("dx", "dgamma", "dbeta", "ds", "dt"), grads, gradsp):
                if a is not None:
                    e = check_close(f"{tag} backward {gname}", a, b, "norm", dn)
                    err_b = e if gname == "dx" else err_b

            def lib_fwd(xin=x):
                hh = F.group_norm(xin, 32, wgt.to(dtype), bias.to(dtype), 1e-5)
                if fs is not None:
                    hh = hh * (1 + fs[:, :, None, None]) + ft[:, :, None, None]
                return F.silu(hh) if silu else hh

            def lib_fwd_bwd():
                xr = x.detach().requires_grad_(True)
                with torch.enable_grad():
                    return torch.autograd.grad(lib_fwd(xr), xr, gy)

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
            rows.append(dict(kernel="group_norm", C=c, H=h, W=w, mode=mode, dtype=dn,
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
                for agg, vals, e in ((agg_f, (t_f, t_fe, t_fp, bound_f, t_fl), err_f),
                                     (agg_b, (t_b, t_be, t_bp, bound_b, t_bl), err_b)):
                    for k, v in zip(("ms", "eager_ms", "plain_ms", "bound_ms", "library_ms"),
                                    vals):
                        agg[k] += n * v
                    agg["max_abs_err"] = max(agg["max_abs_err"], e)
    report["group_norm_forward"] = agg_f
    report["group_norm_backward"] = agg_b
    report["group_norm_classes"] = classes
    log("  K3/K4 by site class, fp32 device ms per guided step (kernel / library / bound):")
    for name, cls in classes.items():
        log(f"    {name} ({cls['sites']} sites): K3 {cls['k3_ms']:.4f} / {cls['k3_library_ms']:.4f}"
            f" / {cls['k3_bound_ms']:.4f}; K4 {cls['k4_ms']:.4f} / {cls['k4_library_ms']:.4f} / "
            f"{cls['k4_bound_ms']:.4f}")
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
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

def run_main_path(workdir):
    import torch
    import yaml

    from osmosis_tpu_torch.config import load_yaml
    from osmosis_tpu_torch.models.convert import init_unet
    from osmosis_tpu_torch.models.unet import unet_config_from_yaml
    from osmosis_tpu_torch.ops import group_norm as G
    from osmosis_tpu_torch.ops import upsample as U
    from osmosis_tpu_torch.pipelines.restore import run_restoration
    from osmosis_tpu_torch.utils.timing import cuda_time_ms

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

    cfg_yaml["unet_model"]["model_path"] = pt
    cfg_yaml["data"]["root"] = os.path.join(ROOT, "data", "underwater")
    cfg_yaml["data"]["stop_after"] = 1
    cfg_yaml["diffusion"]["timestep_respacing"] = STEPS
    cfg_yaml["save_dir"] = os.path.join(workdir, "results")
    cfg_path = os.path.join(workdir, "preset.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg_yaml, f)

    counters = {"upsample_nearest_2x": U.upsample_nearest_2x_kernel,
                "box_sum_2x": U.box_sum_2x_kernel,
                "group_norm_forward": G.group_norm_forward,
                "group_norm_backward": G.group_norm_backward}
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    G.group_norm_forward.kernel_launches = G.group_norm_backward.kernel_launches = 0
    t0 = time.perf_counter()
    out = run_restoration(cfg_path, device="cuda:0")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    gn_kernels = {"group_norm_forward": G.group_norm_forward.kernel_launches,
                  "group_norm_backward": G.group_norm_backward.kernel_launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"  run_restoration: {wall:.1f} s, run dir {out}")
    log(f"  launches on the main path: {launches}; GroupNorm device kernels: {gn_kernels}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")

    for rel in ("configurations.txt", "log.txt", "progress.json",
                *(os.path.join("single_images", d, "uw_0.png")
                  for d in ("input", "rgb", "depth_color", "depth_raw"))):
        if not os.path.exists(os.path.join(out, rel)):
            raise AssertionError(f"run dir lacks {rel}")
    with open(os.path.join(out, "progress.json")) as f:
        row = json.loads(f.readline())
    log(f"  chain_finite: {row['chain_finite']} (random weights at guidance scale 7 may "
        f"diverge), final_loss {row['final_loss']}, chain {row['sample_seconds']:.2f} s")

    # the first step's UNet forward and pullback, at the chain's x_start and t
    from osmosis_tpu_torch.diffusion.schedules import make_schedule
    from osmosis_tpu_torch.models.convert import load_unet

    model = load_unet(pt, ucfg, "cuda")
    t_first = float(make_schedule("linear", 1000, STEPS).model_timesteps()[-1])
    gen = torch.Generator(device="cuda").manual_seed(cfg_yaml["manual_seed"])
    x = torch.randn((1, 256, 256, 4), generator=gen, device="cuda").requires_grad_(True)
    tt = torch.full((1,), t_first, device="cuda")
    y = model(x, tt)
    (dx,) = torch.autograd.grad(y[..., :4], x, torch.ones_like(y[..., :4]))
    if not (torch.isfinite(y).all() and torch.isfinite(dx).all()):
        raise AssertionError("the first step's UNet output or pullback is not finite")
    fwd_ms = cuda_time_ms(lambda: model(x, tt), iters=5)

    def fwd_bwd():
        yy = model(x, tt)
        torch.autograd.grad(yy[..., :4], x, torch.ones_like(yy[..., :4]))

    fwd_bwd_ms = cuda_time_ms(fwd_bwd, iters=5)
    log(f"  first step: UNet output {tuple(y.shape)} and pullback finite; forward "
        f"{fwd_ms:.1f} ms, forward + pullback {fwd_bwd_ms:.1f} ms")

    # the work of one guided step's UNet passes, counted by PyTorch from the
    # shapes of the convolutions and matrix products that ran
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        yy = model(x, tt)
    fwd_flop = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(yy[..., :4], x, torch.ones_like(yy[..., :4]))
    bwd_flop = fc.get_total_flops()
    log(f"  UNet work: forward {fwd_flop / 1e12:.3f} TFLOP, x-pullback {bwd_flop / 1e12:.3f} "
        f"TFLOP; fp32 (TF32 off) at {fwd_flop / fwd_ms / 1e9:.1f} TFLOP/s forward, "
        f"{(fwd_flop + bwd_flop) / fwd_bwd_ms / 1e9:.1f} TFLOP/s forward + pullback "
        f"(fp32 peak {FP32_FLOPS / 1e12:.0f})")
    return dict(launches=launches, gn_kernel_launches=gn_kernels, peak_bytes=peak, wall_s=wall, run=row,
                unet_fwd_ms=fwd_ms, unet_fwd_pullback_ms=fwd_bwd_ms,
                unet_fwd_flop=fwd_flop, unet_pullback_flop=bwd_flop,
                seconds_per_step=row["sample_seconds"] / STEPS, n_params=n_params)


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
                                  sample_pattern=pattern, generator=gen)

    chain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain()
    torch.cuda.synchronize()
    s = (time.perf_counter() - t0) / n_steps
    log(f"  warm guided step (n_iter {gcfg.n_iter}, phi updated every step): {s * 1e3:.1f} ms")
    return s, device_busy_share(chain, n_steps)


def device_busy_share(chain, n_steps):
    """Kernel time on the device over the wall time of one warm chain of
    ``n_steps`` guided steps, from torch.profiler (the profiler's own cost is
    in the wall time). None where the profiler shows no CUDA time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
        log("  device busy share over a warm guided step: not measured (no CUDA time in the "
            "profile)")
        return None
    share = dev_us / 1e6 / wall
    log(f"  device busy share over {n_steps} warm guided steps (torch.profiler): {share:.3f} "
        f"({dev_us / 1e3 / n_steps:.1f} ms of kernels per step over {wall * 1e3 / n_steps:.1f} "
        f"ms wall, profiler on); GroupNorm kernels {gn_us / 1e3 / n_steps:.2f} ms per step")
    return dict(busy_share=share, device_ms_per_step=dev_us / 1e3 / n_steps,
                wall_ms_per_step=wall * 1e3 / n_steps, gn_ms_per_step=gn_us / 1e3 / n_steps)


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

    from osmosis_tpu_torch.models.unet import UNetConfig
    from osmosis_tpu_torch.ops import _build

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1/5] device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[2/5] built CUDA kernels {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    log("[3/5] kernels against their plain versions at the main path's shapes")
    gn_sites, ups, pools = main_path_sites(UNetConfig())
    report = {}
    rows = check_resample_kernels(ups, pools, report)
    rows += check_norm_kernels(gn_sites, report)

    log("[4/5] tiny UNet: card (kernels) against CPU (plain versions), TF32 off")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = check_tiny_unet()

    log(f"[5/5] main path at full width: preset, {STEPS} respaced steps, one image")
    build_dir = os.path.join(ROOT, "osmosis_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as workdir:
        main_path = run_main_path(workdir)
        main_path["warm_seconds_per_step"], main_path["busy"] = time_guided_steps(workdir)
    log(f"  seconds per guided step: {main_path['seconds_per_step']:.4f} over the main path's "
        f"{STEPS}-step chain, {main_path['warm_seconds_per_step']:.4f} warm; peak memory "
        f"{main_path['peak_bytes'] / 2 ** 30:.2f} GiB (max_memory_allocated over the main path); "
        f"{smi}")

    per_step_expected = {
        "upsample_nearest_2x": 2 * len(ups), "box_sum_2x": 2 * len(pools),
        "group_norm_forward": len(gn_sites), "group_norm_backward": len(gn_sites),
    }
    for name, n in per_step_expected.items():
        got = main_path["launches"][name]
        if got != n * STEPS:
            raise AssertionError(f"{name}: {got} launches on the main path, expected "
                                 f"{n} per step x {STEPS} steps")
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
        kernels.append(dict(name=name, route=route, source=source, replaces=replaces,
                            launches=main_path["launches"][name],
                            max_abs_err=agg["max_abs_err"], ms=agg["ms"],
                            plain_ms=agg["plain_ms"], bound_ms=agg["bound_ms"],
                            bound_by="bytes", library_ms=agg["library_ms"]))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(dict(device=kind, nvidia_smi=smi, kernels=kernels, rows=rows, tiny_unet=tiny,
                       main_path=main_path, seconds=time.perf_counter() - t_start), f, indent=1)
    log(f"  per-shape rows in results/chip_smoke_report.json; "
        f"total {time.perf_counter() - t_start:.1f} s")
    log("  kernel ms / plain_ms / bound_ms / library_ms: fp32 device times (ten calls a "
        "CUDA graph, replayed), summed over one guided step's call sites")
    for k in kernels:
        log(f"    {k['name']}: {k['ms']:.3f} ms (eager calls {report[k['name']]['eager_ms']:.3f})"
            f" plain {k['plain_ms']:.3f} library {k['library_ms']:.3f} bound "
            f"{k['bound_ms']:.3f} launches {k['launches']}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
