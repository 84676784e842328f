"""Train a toy RGBD diffusion prior on synthetic scenes (the port of the JAX
package's ``tools/train_toy_prior.py``).

    python -m osmosis_tpu_torch.tools.train_toy_prior --steps 6000 \\
        --out checkpoints/toy_prior.msgpack [-d 0 | --cpu]

A small RGBD UNet learns epsilon-prediction DDPM (Ho et al.) on procedural
scenes (smooth colour fields and a correlated smooth depth) drawn on the
device, so there is no input pipeline. The learned-variance head stays
untrained; sampling uses ``fixed_small``. Each step is one Adam update
(``optax.adam``'s formula) and an EMA of the parameters. The EMA and the raw
parameters are saved as flax msgpack in the JAX package's layout, so the JAX
package's ``load_params_msgpack`` and tools read them, and
``--init-from`` reads the JAX trainer's files. ``--chunk`` is the logging and
saving period (the JAX trainer's scan length; here every step is its own
call). It runs on CUDA device ``-d`` in fp32 with TF32 off, or on the CPU
with ``--cpu``; without a card and without ``--cpu`` it raises.

``--arch production --channels 256 --size 256`` is the preset model's
geometry (552.8M parameters).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..diffusion.schedules import make_schedule
from ..models.convert import (init_unet, params_from_state_dict, save_params_msgpack,
                              unet_from_msgpack)
from ..models.unet import UNetConfig, UNetModel
from ..pipelines.restore import resolve_device


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def scene_draws(gen: torch.Generator, batch: int, device=None) -> Dict[str, torch.Tensor]:
    """The random inputs of a scene batch, in the JAX trainer's key order:
    the 4x4 and 8x8 RGB lattices, the per-image RGB gain, the 4x4 and 8x8
    depth lattices, all uniform, NHWC."""
    def u(shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    return {"rgb4": u((batch, 4, 4, 3)), "rgb8": u((batch, 8, 8, 3)),
            "gain": u((batch, 1, 1, 3), 0.6, 1.0),
            "depth4": u((batch, 4, 4, 1)), "depth8": u((batch, 8, 8, 1))}


def _field(small: torch.Tensor, size: int) -> torch.Tensor:
    """A lattice [B, l, l, C] bilinearly upsampled to [B, size, size, C]
    (``jax.image.resize(..., "bilinear")``: half-pixel centres; at the edge
    JAX renormalises the triangle kernel over the pixels inside, torch clamps
    the source index, and both give the edge pixel's value)."""
    x = F.interpolate(small.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1)


def compose_scenes(draws: Dict[str, torch.Tensor], size: int) -> torch.Tensor:
    """Procedural RGBD scenes in [-1, 1], NHWC [B, size, size, 4], from
    :func:`scene_draws` (the arithmetic of the JAX ``synth_scene_batch``).

    RGB: two low-frequency fields (4x4 and 8x8 lattices) with a per-image
    gain. Depth: an independent smooth field plus RGB luminance, so that
    depth is largely predictable from appearance."""
    rgb = 0.7 * _field(draws["rgb4"], size) + 0.3 * _field(draws["rgb8"], size)
    rgb = torch.clamp(rgb * draws["gain"], -1.0, 1.0)
    depth = 0.8 * _field(draws["depth4"], size) + 0.2 * _field(draws["depth8"], size)
    lum = rgb.mean(dim=-1, keepdim=True)
    depth = torch.clamp(0.35 * depth + 0.65 * lum, -1.0, 1.0)
    return torch.cat([rgb, depth], dim=-1).contiguous()


def synth_scene_batch(gen: torch.Generator, batch: int, size: int, device=None) -> torch.Tensor:
    return compose_scenes(scene_draws(gen, batch, device), size)


def toy_unet_config(size: int, channels: int, arch: str) -> UNetConfig:
    """UNetConfig of the toy priors. 'production' is the full 6-level plan of
    the preset model (mult (1,1,2,2,4,4), attention at rates 8/16/32,
    resblock_updown, 64 head channels) at ``channels`` width; 'toy' is 2
    levels (1,2) with attention at one rate."""
    if arch == "production":
        return UNetConfig(image_size=size, in_channels=4, out_channels=8,
                          model_channels=channels, num_res_blocks=2,
                          attention_resolutions=(8, 16, 32), channel_mult=(1, 1, 2, 2, 4, 4),
                          num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True)
    return UNetConfig(image_size=size, in_channels=4, out_channels=8, model_channels=channels,
                      num_res_blocks=2, attention_resolutions=(4,), channel_mult=(1, 2),
                      num_head_channels=32, use_scale_shift_norm=True, resblock_updown=True)


# ---------------------------------------------------------------------------
# the loss and one step
# ---------------------------------------------------------------------------

class Batch(NamedTuple):
    x0: torch.Tensor         # [B, H, W, 4] scenes
    t: torch.Tensor          # [B] int64 timesteps
    eps: torch.Tensor        # the target noise (offset noise included)
    eps_input: torch.Tensor  # the noise in x_t (input perturbation included)


def draw_batch(gen: torch.Generator, args, device) -> Batch:
    """A training batch: scenes, timesteps, noise, then the optional offset
    noise (per image and channel) and input perturbation (not in the target,
    arXiv 2301.11706), in the JAX trainer's order."""
    x0 = synth_scene_batch(gen, args.batch, args.size, device)
    t = torch.randint(0, args.T, (args.batch,), generator=gen, device=device)
    eps = torch.randn(x0.shape, generator=gen, device=device)
    if args.offset_noise > 0.0:
        eps = eps + args.offset_noise * torch.randn((args.batch, 1, 1, x0.shape[-1]),
                                                    generator=gen, device=device)
    eps_input = eps
    if args.input_perturb > 0.0:
        eps_input = eps + args.input_perturb * torch.randn(x0.shape, generator=gen, device=device)
    return Batch(x0, t, eps, eps_input)


def diffusion_loss(model: UNetModel, b: Batch, sqrt_ab: torch.Tensor,
                   sqrt_1mab: torch.Tensor) -> torch.Tensor:
    """eps-MSE on the first 4 output channels at x_t = q_sample(x0, t)."""
    xt = sqrt_ab[b.t][:, None, None, None] * b.x0 + sqrt_1mab[b.t][:, None, None, None] * b.eps_input
    out = model(xt, b.t.float())
    return torch.mean((out[..., :4] - b.eps) ** 2)


def make_optimizer(model: UNetModel, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: the same update, rounded in another order."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def update_ema(ema: List[torch.Tensor], params: List[torch.Tensor], decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1.0 - decay)


class ToyTrainer:
    """The model, Adam, the EMA and the data stream of one training run."""

    def __init__(self, args, device):
        self.args = args
        self.device = torch.device(device)
        self.cfg = toy_unet_config(args.size, args.channels, args.arch)
        if args.init_from:
            self.model = unet_from_msgpack(args.init_from, self.cfg, args.seed).to(
                device=self.device, memory_format=torch.channels_last)
            print(f"warm-start from {args.init_from}", file=sys.stderr)
        else:
            self.model = init_unet(self.cfg, args.seed).to(device=self.device,
                                                           memory_format=torch.channels_last)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.n_params = sum(p.numel() for p in self.params)
        consts = make_schedule("linear", args.T).device_constants()
        self.sqrt_ab = torch.as_tensor(consts["sqrt_alphas_cumprod"], device=self.device)
        self.sqrt_1mab = torch.as_tensor(consts["sqrt_one_minus_alphas_cumprod"],
                                         device=self.device)
        self.opt = make_optimizer(self.model, args.lr)
        self.ema = [p.detach().clone() for p in self.params]
        self.gen = torch.Generator(device=self.device).manual_seed(args.seed + 1)

    def step(self) -> torch.Tensor:
        """One Adam step and EMA update on a fresh batch; the loss (on the device)."""
        self.opt.zero_grad(set_to_none=True)  # the last step's gradients free before the forward
        loss = diffusion_loss(self.model, draw_batch(self.gen, self.args, self.device),
                              self.sqrt_ab, self.sqrt_1mab)
        loss.backward()
        self.opt.step()
        update_ema(self.ema, self.params, self.args.ema)
        return loss.detach()

    def ema_model(self) -> UNetModel:
        """A frozen copy of the model holding the EMA weights."""
        model = init_unet(self.cfg, self.args.seed)
        model.load_state_dict(dict(zip(self.names, (e.cpu() for e in self.ema))))
        return model.requires_grad_(False).eval().to(device=self.device,
                                                     memory_format=torch.channels_last)

    def save(self, out: str, raw_out: str) -> None:
        """The EMA to ``out`` and the raw parameters to ``raw_out``, in the JAX
        layout; each written to a temporary file and renamed over the old one,
        so a crash mid-write leaves the previous checkpoint whole."""
        for tensors, path in ((self.ema, out), (self.params, raw_out)):
            sd = {n: t.detach().cpu() for n, t in zip(self.names, tensors)}
            tmp = path + ".tmp"
            save_params_msgpack(params_from_state_dict(sd, self.cfg), tmp)
            os.replace(tmp, path)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--chunk", type=int, default=100,
                    help="steps between the loss lines and --save-every checks")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--ema", type=float, default=0.999)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--offset-noise", type=float, default=0.0,
                    help="sigma of a per-(image, channel) constant noise component added "
                         "to eps (the model predicts the sum): drowns the channel-mean "
                         "signal that the linear schedule leaves in x_T, so the marginal "
                         "amplitude must be learned. 0.0 = off")
    ap.add_argument("--input-perturb", type=float, default=0.0,
                    help="gamma of training-time input perturbation (arXiv 2301.11706): "
                         "x_t is built with eps + gamma*xi while the target stays eps. "
                         "0.0 = off")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="toy", choices=["toy", "production"],
                    help="'toy' = 2 levels, attention at one rate; 'production' = the "
                         "preset model's 6-level plan at --channels width")
    ap.add_argument("--out", default="checkpoints/toy_prior.msgpack")
    ap.add_argument("--init-from", default=None,
                    help="warm-start from a .msgpack checkpoint (use the _raw file): "
                         "fresh Adam moments, the EMA seeded at the loaded weights; "
                         "--steps counts the new steps; pass another --seed than the "
                         "first run, or the data stream repeats")
    ap.add_argument("--save-every", type=int, default=0,
                    help="also save the EMA and raw checkpoints at every N-step boundary "
                         "a chunk crosses (atomic overwrite of --out); 0 = at the end only")
    ap.add_argument("--health-check", type=int, default=1,
                    help="after training, sample 4 unconditional images from the EMA and "
                         "compare their statistics with the training scenes' (0 = off)")
    ap.add_argument("-d", "--device", type=int, default=0, help="CUDA device index")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def train(args) -> Tuple[dict, List[float]]:
    """Run the training loop of ``args`` (see :func:`build_parser`); returns
    the report (the JSON line the CLI prints) and each chunk's mean loss."""
    device = resolve_device("cpu" if args.cpu else f"cuda:{args.device}")
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    tr = ToyTrainer(args, device)
    print(f"toy prior: {tr.n_params / 1e6:.2f}M params", file=sys.stderr)
    raw_out = args.out.replace(".msgpack", "_raw.msgpack")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    chunk_means: List[torch.Tensor] = []
    t0 = time.perf_counter()
    done = 0
    while done < args.steps:
        losses = torch.stack([tr.step() for _ in range(args.chunk)])
        mean_l, last_l = losses.mean(), losses[-1]
        chunk_means.append(mean_l)
        done += args.chunk
        if done % (args.chunk * 5) == 0 or done >= args.steps:
            el = time.perf_counter() - t0
            print(f"step {done:6d}  loss {float(mean_l):.4f} (last {float(last_l):.4f})  "
                  f"{done / el:.1f} steps/s", file=sys.stderr, flush=True)
        # every --save-every boundary crossed in this chunk (done % save_every
        # == 0 alone fires only at lcm(chunk, save_every))
        if (args.save_every and done < args.steps
                and done // args.save_every > (done - args.chunk) // args.save_every):
            tr.save(args.out, raw_out)
            print(f"checkpointed at step {done}", file=sys.stderr, flush=True)

    tr.save(args.out, raw_out)
    report = {
        "steps": args.steps, "params_m": round(tr.n_params / 1e6, 2),
        "final_loss": round(float(mean_l), 4), "ema": args.out, "raw": raw_out,
        "train_steps_per_sec": round(args.steps / (time.perf_counter() - t0), 1),
    }
    if args.health_check:
        from .check_prior_stats import prior_health

        report["health"] = prior_health(tr.ema_model(), size=args.size, n=4, steps=1000,
                                        seed=args.seed + 2)
    return report, [float(m) for m in chunk_means]


def main(argv=None):
    report, _ = train(build_parser().parse_args(argv))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
