"""What cuDNN's deterministic algorithms cost the fp32 chain on the card, and
whether they make it repeat its bits.

    python -m osmosis_tpu_torch.tools.cudnn_determinism [--steps 5] [--rounds 2] [--out FILE]

Run from the repository's root on a CUDA card. The UNet is the preset's
(``configs/osmosis_sample_config.yaml``, 552.8M parameters at 256²) with
seeded random weights, its zero-initialized convolutions set to
0.02·N(0, 1). cuDNN's default algorithms and its deterministic ones
(``torch.backends.cudnn.deterministic``, ``benchmark`` off) take turns in
one process, default, deterministic, deterministic, default in each round,
each after a warm-up call of its own:
  * seconds per warm fp32 guided step of the preset (the UNet forward and
    x-pullback, phi updated at every step, clip_denoised) at batch 1
    (``guided_sample_loop``) and at batch 4 (the fleet runner);
  * seconds per fp32 train step of the toy-prior trainer at the preset's
    width, batch 4 (the trainer runs the same convolutions);
  * whether three calls of the UNet's forward and x-pullback repeat the first
    call's bits, and by how much the pullbacks differ.
It prints one JSON object, and writes it to ``--out`` too.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

MODES = {"default": False, "deterministic": True}


def _set(mode: str) -> None:
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = MODES[mode]


def _timed(fn, n_units: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_units


def alternate(fn, n_units: int, rounds: int) -> dict:
    """Seconds per unit of ``fn`` (which runs ``n_units`` units) under each
    mode, in the order default, deterministic, deterministic, default per
    round, each mode warmed by one call first; the deterministic mode's cost
    over the default's, from the means."""
    times = {m: [] for m in MODES}
    for mode in MODES:
        _set(mode)
        fn()
    for _ in range(rounds):
        for mode in ("default", "deterministic", "deterministic", "default"):
            _set(mode)
            times[mode].append(_timed(fn, n_units))
    mean = {m: sum(v) / len(v) for m, v in times.items()}
    return dict(seconds=times, mean=mean, cost=mean["deterministic"] / mean["default"] - 1.0)


def unet_repeats(model, calls: int = 3) -> dict:
    """Under each mode: do ``calls`` forwards and x-pullbacks of the fp32 UNet
    ``model`` (on the card) at a seeded 256x256 input and t = 999 repeat the
    first call's bits? The process's cuDNN settings again afterwards."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, 256, 256, 4), generator=gen, device="cuda").requires_grad_(True)
    tt = torch.full((1,), 999.0, device="cuda")
    out = {}
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        for mode in MODES:
            _set(mode)
            runs = []
            for _ in range(calls):
                y = model(x, tt)
                (dx,) = torch.autograd.grad(y[..., :4].sum(), x)
                runs.append((y.detach(), dx))
            out[mode] = dict(
                forward_repeats=all(torch.equal(runs[0][0], r[0]) for r in runs[1:]),
                pullback_repeats=all(torch.equal(runs[0][1], r[1]) for r in runs[1:]),
                pullback_max_abs_diff=max((runs[0][1] - r[1]).abs().max().item()
                                          for r in runs[1:]))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5, help="guided steps a timed chain")
    ap.add_argument("--train-steps", type=int, default=3, help="train steps a timed run")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("cudnn_determinism needs a CUDA card")
    from ..config import load_yaml
    from ..diffusion.guided import GuidanceConfig, guided_sample_loop
    from ..diffusion.sampler import SamplerConfig
    from ..diffusion.schedules import make_schedule
    from ..guidance.operators import get_operator
    from ..parallel.runner import make_batched_guided_runner
    from . import train_toy_prior as TP
    from .real_weights_runbook import device_description
    from .validate_checkpoint import build_reference_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    cfg = load_yaml(os.path.join("configs", "osmosis_sample_config.yaml"))
    model, _, _ = build_reference_model(cfg["unet_model"], None, "cuda")
    model = model.to(memory_format=torch.channels_last)
    op_kw = {k: v for k, v in cfg["measurement"]["operator"].items() if k != "name"}
    op = get_operator(cfg["measurement"]["operator"]["name"], batch_size=1, **op_kw)
    pattern = dict(cfg["sample_pattern"], update_start=1.0)
    gcfg = GuidanceConfig.from_config("osmosis", cfg["conditioning"]["params"], pattern,
                                      cfg["aux_loss"])
    sch = make_schedule("linear", 1000, str(args.steps))
    scfg = SamplerConfig(clip_denoised=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = torch.randn((4, 256, 256, 4), generator=gen, device="cuda")
    ys = torch.rand((4, 256, 256, 3), generator=gen, device="cuda") * 2 - 1
    fleet = make_batched_guided_runner(model, sch, op, gcfg, scfg, sample_pattern=pattern)
    result = dict(device=torch.cuda.get_device_name(0),
                  nvidia_smi=device_description(torch.device("cuda", 0)),
                  torch=torch.__version__, cuda=torch.version.cuda, steps=args.steps,
                  rounds=args.rounds)
    try:
        result["unet_repeats"] = unet_repeats(model)
        result["guided_step_batch1"] = alternate(
            lambda: guided_sample_loop(model, sch, xs[:1], ys[:1], op, gcfg, scfg,
                                       sample_pattern=pattern, seed=0), args.steps, args.rounds)
        result["guided_step_batch4"] = alternate(
            lambda: fleet(xs, ys, seed=0), args.steps, args.rounds)
        del model, fleet
        torch.cuda.empty_cache()
        tr = TP.ToyTrainer(TP.build_parser().parse_args(
            ["--arch", "production", "--size", "256", "--channels", "256", "--batch", "4"]),
            "cuda:0")
        result["train_step_batch4"] = alternate(
            lambda: [tr.step() for _ in range(args.train_steps)], args.train_steps, args.rounds)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    for key in ("guided_step_batch1", "guided_step_batch4", "train_step_batch4"):
        r = result[key]
        print(f"{key}: default {r['mean']['default'] * 1e3:.2f} ms, deterministic "
              f"{r['mean']['deterministic'] * 1e3:.2f} ms, cost {r['cost'] * 100:+.2f}%")
    print(f"unet repeats: {result['unet_repeats']}")
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return result


if __name__ == "__main__":
    main()
