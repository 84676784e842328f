"""Prior-health probe: unconditional samples against the training statistics
(the port of the JAX package's ``tools/check_prior_stats.py``).

    python -m osmosis_tpu_torch.tools.check_prior_stats \\
        --checkpoint checkpoints/toy_prior128_prod.msgpack --size 128 --channels 64 \\
        --arch production [--eps-bias | --trajectory] [-d 0 | --cpu]

Samples N images from a toy prior checkpoint (``.msgpack``) and compares the
luminance-depth correlation, per-channel std and total variation with a fresh
batch of the procedural training scenes: it tells a weak prior from a wrong
guidance recipe. ``--eps-bias`` prints the per-t eps accuracy on held-out
scenes, ``--trajectory`` the amplitude statistics along a sampling chain.
Sampling is the port's ``sample_loop`` with ``fixed_small`` variance; random
draws come from ``torch.Generator`` streams, so the bits differ from the JAX
tool's.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..diffusion.sampler import SamplerConfig, sample_loop
from ..diffusion.schedules import make_schedule
from ..models.convert import unet_from_msgpack
from ..models.unet import UNetModel
from ..pipelines.restore import resolve_device


def stats(x: np.ndarray) -> dict:
    """x: [B, H, W, 4] in [-1, 1] -> summary stats dict."""
    rgb, depth = x[..., :3], x[..., 3]
    lum = rgb.mean(axis=-1)
    corrs = []
    for b in range(x.shape[0]):
        l, d = lum[b].ravel(), depth[b].ravel()
        ls, ds = l.std(), d.std()
        corrs.append(float(np.corrcoef(l, d)[0, 1]) if ls > 1e-6 and ds > 1e-6 else 0.0)
    tv = np.mean(np.abs(np.diff(x, axis=1))) + np.mean(np.abs(np.diff(x, axis=2)))
    return {
        "lum_depth_corr": round(float(np.mean(corrs)), 3),
        "rgb_std": round(float(rgb.std()), 3),
        "depth_std": round(float(depth.std()), 3),
        "tv": round(float(tv), 4),
        "rgb_range": [round(float(rgb.min()), 2), round(float(rgb.max()), 2)],
    }


def _stream(device, seed: int, i: int) -> torch.Generator:
    """Generator ``i`` of a probe seeded by ``seed`` (jax.random.fold_in's role)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + i)


def _device(model: UNetModel) -> torch.device:
    return next(model.parameters()).device


def prior_health(model: UNetModel, size: int, n: int = 4, steps: int = 1000, seed: int = 7,
                 init_mode: str = "noise") -> dict:
    """Sample ``n`` unconditional images from ``model`` and return
    ``{'prior_samples': stats, 'train_scenes': stats}``. The trainer calls it
    at the end of a run (``--health-check``).

    ``init_mode='q_sample'`` is a diagnostic: the chain starts from
    q(x_T | x0) of held-out scenes instead of pure N(0, 1). The two differ
    only by the leaked signal sqrt(alphas_cumprod_T)·x0 (~0.0066·x0 for the
    linear-1000 schedule): if q_sample calibrates the amplitude statistics
    and 'noise' does not, the prior learned to read the image mean out of x_T
    (the non-zero-terminal-SNR leak), not too little of the data."""
    from .train_toy_prior import synth_scene_batch

    dev = _device(model)
    schedule = make_schedule("linear", 1000)
    eps_T = torch.randn((n, size, size, 4), generator=_stream(dev, seed, 0), device=dev)
    if init_mode == "q_sample":
        consts = schedule.device_constants()
        x0 = synth_scene_batch(_stream(dev, seed, 3), n, size, dev)
        x_init = (float(consts["sqrt_alphas_cumprod"][-1]) * x0
                  + float(consts["sqrt_one_minus_alphas_cumprod"][-1]) * eps_T)
    else:
        x_init = eps_T
    samples, _ = sample_loop(model, schedule, x_init, SamplerConfig(model_var_type="fixed_small"),
                             start_t=1000, num_steps=steps, generator=_stream(dev, seed, 1))
    train = synth_scene_batch(_stream(dev, seed, 2), n, size, dev)
    return {"prior_samples": stats(np.clip(samples.float().cpu().numpy(), -1, 1)),
            "train_scenes": stats(train.cpu().numpy())}


@torch.no_grad()
def eps_bias_table(model: UNetModel, size: int, batch: int = 8,
                   ts=(25, 100, 300, 500, 700, 850, 950, 999), seed: int = 42) -> list:
    """Per-t eps-prediction accuracy on the training distribution: for each t,
    x_t = q_sample(x0, t, eps) of held-out scenes and eps_hat = model(x_t, t).
    Reports proj = <eps_hat, eps>/||eps||² (energy along the true noise), rel
    = ||eps_hat - eps||/||eps||, the std of the implied x0-hat and the mean
    bias per channel group. Healthy rows with miscalibrated unconditional
    samples point at the trajectory, not at the pointwise training."""
    from .train_toy_prior import synth_scene_batch

    dev = _device(model)
    consts = make_schedule("linear", 1000).device_constants()
    sab = torch.as_tensor(consts["sqrt_alphas_cumprod"], device=dev)
    s1m = torch.as_tensor(consts["sqrt_one_minus_alphas_cumprod"], device=dev)
    x0 = synth_scene_batch(_stream(dev, seed, 0), batch, size, dev)
    eps = torch.randn(x0.shape, generator=_stream(dev, seed, 1), device=dev)
    rows = []
    for t in ts:
        xt = sab[t] * x0 + s1m[t] * eps
        eps_hat = model(xt, torch.full((batch,), float(t), device=dev))[..., :4]
        x0_hat = (xt - s1m[t] * eps_hat) / sab[t]
        r = [float(v) for v in (
            torch.sum(eps_hat * eps) / torch.sum(eps * eps),
            torch.sqrt(torch.sum((eps_hat - eps) ** 2) / torch.sum(eps * eps)),
            x0_hat[..., :3].std(correction=0), x0_hat[..., 3].std(correction=0),
            torch.mean(eps_hat[..., :3] - eps[..., :3]), torch.mean(eps_hat[..., 3] - eps[..., 3]))]
        rows.append({
            "t": int(t), "proj": round(r[0], 4), "rel": round(r[1], 4),
            "x0hat_rgb_std": round(r[2], 3), "x0hat_depth_std": round(r[3], 3),
            "eps_mean_bias_rgb": round(r[4], 5), "eps_mean_bias_depth": round(r[5], 5),
        })
    return rows


def trajectory_table(model: UNetModel, size: int, n: int = 4,
                     ts=(999, 950, 850, 700, 500, 300, 100, 25, 0), seed: int = 7) -> list:
    """Amplitude statistics along a real unconditional chain: x_t and the
    implied x0-hat at the timesteps ``ts``. Where the on-trajectory x0-hat
    energy exceeds :func:`eps_bias_table`'s on-distribution value, the chain
    compounds its errors."""
    dev = _device(model)
    x_init = torch.randn((n, size, size, 4), generator=_stream(dev, seed, 0), device=dev)
    _, snaps = sample_loop(model, make_schedule("linear", 1000), x_init,
                           SamplerConfig(model_var_type="fixed_small"), record_steps=ts,
                           generator=_stream(dev, seed, 1))
    xt = snaps["x_t"].float().cpu().numpy()
    x0h = snaps["x0_hat"].float().cpu().numpy()
    rows = []
    for i, t in enumerate(snaps["steps"]):
        rows.append({
            "t": int(t),
            "xt_std": round(float(xt[i].std()), 3),
            "x0hat_rgb_std": round(float(x0h[i, ..., :3].std()), 3),
            "x0hat_depth_std": round(float(x0h[i, ..., 3].std()), 3),
            "x0hat_rgb_mean": round(float(x0h[i, ..., :3].mean()), 3),
        })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--arch", default="production", choices=["toy", "production"])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--init-mode", default="noise", choices=["noise", "q_sample"],
                    help="'q_sample' starts the chain from q(x_T|x0) of held-out scenes: "
                         "isolates the terminal-SNR mean leak (see prior_health)")
    ap.add_argument("--eps-bias", action="store_true",
                    help="print the per-t eps-accuracy table on held-out scenes instead")
    ap.add_argument("--trajectory", action="store_true",
                    help="print amplitude stats recorded along a sampling chain instead")
    ap.add_argument("-d", "--device", type=int, default=0, help="CUDA device index")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from .train_toy_prior import toy_unet_config

    dev = resolve_device("cpu" if args.cpu else f"cuda:{args.device}")
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = toy_unet_config(args.size, args.channels, args.arch)
    model = unet_from_msgpack(args.checkpoint, cfg).requires_grad_(False).eval().to(
        device=dev, memory_format=torch.channels_last)
    if args.eps_bias:
        for row in eps_bias_table(model, size=args.size, seed=args.seed):
            print(json.dumps(row), flush=True)
        return
    if args.trajectory:
        for row in trajectory_table(model, size=args.size, n=args.n, seed=args.seed):
            print(json.dumps(row), flush=True)
        return
    print(json.dumps(prior_health(model, size=args.size, n=args.n, steps=args.steps,
                                  seed=args.seed, init_mode=args.init_mode), indent=1))


if __name__ == "__main__":
    main()
