"""Where the time of one full-width UNet pass goes: the device's kernels and
the host's operators, in fp32 (TF32 off) and in the bf16 torso.

    python -m osmosis_tpu_torch.tools.unet_profile [--dtype bfloat16 float32] [--top 12]
        [--out FILE]

Run from the repository's root on a CUDA card. The UNet is the preset's
(``configs/osmosis_sample_config.yaml``, 552.8M parameters at 256²) with
seeded random weights. For each dtype it times a forward, and a forward plus
the x-pullback, three ways: the wall time by CUDA events over back-to-back
calls (what the guided loop sees), the device's kernel time from
``torch.profiler``, and the host time the profiler gives each operator. It
prints the FLOP rate against both times and the operators that take the most
host time, and writes the numbers as JSON to ``--out``.
"""

import argparse
import json
import os
import sys
import time


def profile_pass(fn, iters=3):
    """(device ms per call, wall ms per call, {operator: host ms per call})
    over ``iters`` calls under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    dev_us, host = 0.0, {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            dev_us += getattr(e, "self_cuda_time_total", 0.0) if us is None else us
        else:
            host[e.key] = e.self_cpu_time_total / 1e3 / iters
    return dev_us / 1e3 / iters, wall, host


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtype", nargs="+", default=["bfloat16", "float32"])
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    if not torch.cuda.is_available():
        raise RuntimeError("unet_profile needs a CUDA card")
    sys.path.insert(0, os.getcwd())
    from osmosis_tpu_torch.config import load_yaml
    from osmosis_tpu_torch.models.convert import cast_params_half, init_unet
    from osmosis_tpu_torch.models.unet import unet_config_from_yaml
    from osmosis_tpu_torch.utils.timing import cuda_time_ms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    um = load_yaml(os.path.join("configs", "osmosis_sample_config.yaml"))["unet_model"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, 256, 256, 4), generator=gen, device="cuda")
    tt = torch.full((1,), 999.0, device="cuda")
    rows = {}
    for name in args.dtype:
        dtype = getattr(torch, name)
        cfg = unet_config_from_yaml(um, dtype=dtype)
        model = init_unet(cfg, seed=0)
        if dtype != torch.float32:
            cast_params_half(model, dtype)
        model = model.requires_grad_(False).to(device="cuda", memory_format=torch.channels_last)
        xg = x.clone().requires_grad_(True)

        def fwd():
            return model(xg, tt)

        def fwd_bwd():
            y = model(xg, tt)
            torch.autograd.grad(y[..., :4], xg, torch.ones_like(y[..., :4]))

        with FlopCounterMode(display=False) as fc:
            y = fwd()
        flop_f = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            torch.autograd.grad(y[..., :4], xg, torch.ones_like(y[..., :4]))
        flop = flop_f + fc.get_total_flops()
        row = dict(forward_tflop=flop_f / 1e12, forward_pullback_tflop=flop / 1e12)
        for what, fn, work in (("forward", fwd, flop_f), ("forward_pullback", fwd_bwd, flop)):
            event_ms = cuda_time_ms(fn, iters=5)
            dev_ms, wall_ms, host = profile_pass(fn)
            top = sorted(host.items(), key=lambda kv: -kv[1])[:args.top]
            row[what] = dict(event_ms=event_ms, device_ms=dev_ms, profiled_wall_ms=wall_ms,
                             host_ms=sum(host.values()), tflops_event=work / event_ms / 1e9,
                             tflops_device=work / dev_ms / 1e9, top_host_ops=top)
            print(f"{name} {what}: {event_ms:.1f} ms by CUDA events ({work / event_ms / 1e9:.1f} "
                  f"TFLOP/s), {dev_ms:.1f} ms of device kernels ({work / dev_ms / 1e9:.1f} "
                  f"TFLOP/s), profiled wall {wall_ms:.1f} ms; host self time "
                  f"{sum(host.values()):.1f} ms per call, most in:")
            for op, ms in top:
                print(f"    {op}: {ms:.2f} ms")
        rows[name] = row
        del model
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=torch.cuda.get_device_name(0), rows=rows), f, indent=1)


if __name__ == "__main__":
    main()
