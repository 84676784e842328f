"""Device time of the GroupNorm kernels K3/K4 at every GroupNorm site of the
main path, in each launch geometry, beside the library call and, with
``--parent``, the K3/K4 of another checkout of the repository.

    python -m osmosis_tpu_torch.tools.gn_bench [--parent DIR] [--dtype float32] [--out FILE]
        [--set NAME=VALUE ...] [--quick]

Run from the repository's root on a CUDA card. Every time is the device time
of one call (``utils.timing.graph_time_ms``: ten calls captured in one CUDA
graph, replayed). The backward is timed as the main path calls it, without
the parameter-gradient sums; the other checkout's backward as it is. Per site
the two versions are timed in turns, other, this, this, other, and each is
the mean of its two turns, and their outputs (y and the statistics; dx and
the parameter sums) are compared: ``identical`` where every output has the
same bits, else the largest difference. Beside each kernel: its eager time
(back-to-back calls by CUDA events, ``utils.timing.cuda_time_ms``), its plain
PyTorch version's device time, the library call's and the byte bound.
"split" is this checkout's two-launch geometry
forced with ``MAX_CLUSTER = 0``. ``--set`` overrides a geometry constant of
``ops.group_norm`` (``TILE_BUDGET``, ``MAX_THREADS``, ``MAX_CLUSTER``,
``RESIDENT_ROW_BYTES``, ``SPLIT_THREADS``, ``SPLIT_ROW_BYTES``,
``SPLIT_CTAS_PER_SM``) for the run;
``--quick`` times only the planned geometry, without the eager, plain and
library times; ``--profile`` adds each device
kernel's time per call from ``torch.profiler`` at the sites of 64x64 and up,
and the time of ``x.clone()`` (one read and one write of x, a yardstick of
the card's streaming rate). Prints one table row per site, then the sums
per guided step (each site times its count per UNet pass) by site class, and
writes the rows as JSON to ``--out``.
"""

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def load_other(root):
    """``ops.group_norm`` of the port in another checkout, as its own package."""
    name = "other_osmosis_tpu_torch"
    pkg = os.path.join(os.path.abspath(root), "osmosis_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(name + ".ops.group_norm")


def kernel_times(fn, calls=10):
    """Device time per call of each kernel that ``fn`` launches, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
        if us > 0:
            k = e.key
            name = k[k.find("gn_kernel<"):k.find(">(") + 1] if "gn_kernel<" in k else k[:60]
            out[name] = out.get(name, 0.0) + round(us / calls, 2)
    return out


def site_class(h):
    return "<=32x32" if h <= 32 else "64x64-128x128" if h <= 128 else "256x256"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout whose K3/K4 to time beside")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--out", default=os.path.join("results", "gn_bench.json"))
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("gn_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from chip_smoke import counted, main_path_sites
    from osmosis_tpu_torch.models.unet import UNetConfig
    from osmosis_tpu_torch.ops import group_norm as G
    from osmosis_tpu_torch.utils.timing import cuda_time_ms, graph_time_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"gn_bench on {smi}, {args.dtype}", flush=True)
    for item in args.set:
        name, value = item.split("=")
        if not hasattr(G, name) or not name.isupper():
            raise SystemExit(f"gn_bench: no geometry constant {name}")
        setattr(G, name, int(value))
    print(f"  settings: {args.set or 'defaults'}", flush=True)
    other = load_other(args.parent) if args.parent else None
    dtype = getattr(torch, args.dtype)
    item = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (c, h, w, mode), n in counted(main_path_sites(UNetConfig())[0]).items():
        x = (torch.randn(1, c, h, w, generator=gen, device="cuda") * 1.5 + 0.3).to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        gy = torch.randn(1, c, h, w, generator=gen, device="cuda").to(dtype)
        gy = gy.contiguous(memory_format=torch.channels_last)
        wgt = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        fs = (0.2 * torch.randn(1, c, generator=gen, device="cuda")).to(dtype) \
            if mode == "film" else None
        ft = (0.2 * torch.randn(1, c, generator=gen, device="cuda")).to(dtype) \
            if mode == "film" else None
        silu = mode != "none"
        _, m, i = G.group_norm_forward(x, wgt, bias, fs, ft, silu)

        def fwd(mod=G):
            return lambda: mod.group_norm_forward(x, wgt, bias, fs, ft, silu)

        def bwd(mod=G):
            if mod is G:
                return lambda: G.group_norm_backward(gy, x, wgt, bias, fs, ft, silu, m, i,
                                                     param_grads=False)
            return lambda: mod.group_norm_backward(gy, x, wgt, bias, fs, ft, silu, m, i)

        plain = {"fwd": lambda: G.group_norm_forward_plain(x, wgt, bias, fs, ft, silu),
                 "bwd": lambda: G.group_norm_backward_plain(gy, x, wgt, bias, fs, ft, silu, m, i)}

        def lib_fwd(xin=x):
            hh = F.group_norm(xin, 32, wgt.to(dtype), bias.to(dtype), 1e-5)
            if fs is not None:
                hh = hh * (1 + fs[:, :, None, None]) + ft[:, :, None, None]
            return F.silu(hh) if silu else hh

        def lib_fwd_bwd():
            xr = x.detach().requires_grad_(True)
            with torch.enable_grad():
                return torch.autograd.grad(lib_fwd(xr), xr, gy)

        row = dict(C=c, H=h, W=w, mode=mode, dtype=args.dtype, per_step=n)
        if other is not None:
            for d, call in (("fwd", "group_norm_forward"), ("bwd", "group_norm_backward")):
                args_ = (x, wgt, bias, fs, ft, silu) if d == "fwd" else (
                    gy, x, wgt, bias, fs, ft, silu, m, i)
                pairs = [(a, b) for a, b in zip(getattr(G, call)(*args_), getattr(other, call)(*args_))
                         if a is not None]
                row[f"{d}_vs_other"] = "identical" if all(torch.equal(a, b) for a, b in pairs) \
                    else max((a.float() - b.float()).abs().max().item() for a, b in pairs)
        for d, make, nbytes in (("fwd", fwd, 2), ("bwd", bwd, 3)):
            p = G._device_plan(torch.cuda.current_device(), 1, c, h, w, G._DTYPE_CODES[dtype],
                               G._mode(fs, silu), d == "bwd", 2, G.MAX_CLUSTER)
            if other is not None:
                t = [graph_time_ms(make(other)), graph_time_ms(make()), graph_time_ms(make()),
                     graph_time_ms(make(other))]
                row[f"{d}_other_us"] = (t[0] + t[3]) / 2 * 1e3
                row[f"{d}_us"] = (t[1] + t[2]) / 2 * 1e3
            else:
                row[f"{d}_us"] = graph_time_ms(make()) * 1e3
            row[f"{d}_geometry"] = (f"{p.geometry}/{p.cluster}" if p.geometry == "resident"
                                    else f"split/{p.chunks}x{p.n_cblk}")
            if args.quick:
                row[f"{d}_split_us"] = float("nan")
            elif p.geometry == "resident":
                saved, G.MAX_CLUSTER = G.MAX_CLUSTER, 0
                try:
                    row[f"{d}_split_us"] = graph_time_ms(make()) * 1e3
                finally:
                    G.MAX_CLUSTER = saved
            else:
                row[f"{d}_split_us"] = row[f"{d}_us"]
            row[f"{d}_bound_us"] = nbytes * x.numel() * item / HBM_BYTES_PER_S * 1e6
        if args.profile and h >= 64:
            row["copy_us"] = graph_time_ms(lambda: x.clone()) * 1e3
            row["kernels_us"] = {d: kernel_times(make()) for d, make in (("fwd", fwd), ("bwd", bwd))}
            print(f"    copy {row['copy_us']:.1f} us; kernels {row['kernels_us']}", flush=True)
        if args.quick:
            for d in ("fwd", "bwd"):
                row[f"{d}_library_us"] = row[f"{d}_eager_us"] = row[f"{d}_plain_us"] = float("nan")
        else:
            row["fwd_library_us"] = graph_time_ms(lib_fwd) * 1e3
            row["bwd_library_us"] = max(graph_time_ms(lib_fwd_bwd) * 1e3
                                        - row["fwd_library_us"], 0)
            for d, make in (("fwd", fwd), ("bwd", bwd)):
                row[f"{d}_eager_us"] = cuda_time_ms(make()) * 1e3
                row[f"{d}_plain_us"] = graph_time_ms(plain[d]) * 1e3
        rows.append(row)
        print(f"C={c:5d} {h:3d}x{w:<3d} {mode:4s} x{n:<2d} " + " | ".join(
            f"{d} {row[f'{d}_geometry']:11s} {row[f'{d}_us']:7.1f}"
            + (f" other {row[f'{d}_other_us']:7.1f} ({row[f'{d}_vs_other']})"
               if other is not None else "")
            + f" split {row[f'{d}_split_us']:7.1f} eager {row[f'{d}_eager_us']:7.1f}"
            f" plain {row[f'{d}_plain_us']:7.1f} lib {row[f'{d}_library_us']:7.1f}"
            f" bound {row[f'{d}_bound_us']:6.1f}" for d in ("fwd", "bwd")), flush=True)

    keys = ["us", "split_us", "eager_us", "plain_us", "library_us", "bound_us"] + (
        ["other_us"] if other else [])
    classes = {}
    for row in rows:
        for cls in (site_class(row["H"]), "all"):
            agg = classes.setdefault(cls, {})
            for d in ("fwd", "bwd"):
                for k in keys:
                    agg[f"{d}_{k}"] = agg.get(f"{d}_{k}", 0.0) + row["per_step"] * row[f"{d}_{k}"]
    print("per guided step, ms (sites x their count):")
    for cls, agg in classes.items():
        print(f"  {cls}: " + "; ".join(
            f"{d} " + " ".join(f"{k.replace('_us', '')} {agg[f'{d}_{k}'] / 1e3:.4f}" for k in keys)
            for d in ("fwd", "bwd")))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, dtype=args.dtype, rows=rows, per_step_us=classes), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
