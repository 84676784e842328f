"""One guided Osmosis step in plain PyTorch and float32: the reference that
the program's steps are held against.

Written from the published method (Osmosis, ECCV 2024: DDPM posterior
sampling with the physical underwater formation model and an SGD fit of
its water parameters phi inside each step; guided-diffusion's schedule,
respacing and learned-range variance). The preset's YAML, as a dict, is
the only input besides the tensors.

The step, for x_t at respaced index t:
  * the UNet gives eps and the variance channels v;
  * x0-hat = clamp(sqrt(1/abar) x_t - sqrt(1/abar - 1) eps, -1, 1)
    (``clip_denoised``);
  * phi takes ``n_iter - 1`` SGD steps on the guidance loss at a fixed
    x0-hat, then the joint gradient gives g_x0 and one more phi step; the
    loss is ``||(y - (2 A_phi(x0) - 1)) * w(x0)||`` per image plus the
    auxiliary terms, with w the depth weight of a detached x0-hat;
  * an x_prev step pulls g_x0 back through the UNet to x_t and clips it to
    +-``gradient_clip``; an x0 step guides with g_x0 itself;
  * x_{t-1} = posterior mean - scale * guidance + [t > 0] exp(logvar / 2) z.

:func:`check_step` holds one recorded step of the program against this,
stage by stage, each stage from the program's own values at its input: the
chain carries rounding from step to step through the clamp and a guidance
scale of 7, so the reference follows the program rather than running a
chain of its own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

U64 = (1 << 64) - 1


def _floats(spec) -> np.ndarray:
    if isinstance(spec, (int, float)):
        return np.array([float(spec)])
    return np.array([float(s) for s in str(spec).split(",")])


def _flag(spec) -> bool:
    return spec if isinstance(spec, bool) else str(spec).strip().lower() in ("true", "1", "yes")


def space_timesteps(T: int, spec) -> set:
    """guided-diffusion's ``space_timesteps``: "ddimN" (an even stride) or
    section counts."""
    if isinstance(spec, str) and spec.startswith("ddim"):
        n = int(spec[4:])
        for stride in range(1, T):
            if len(range(0, T, stride)) == n:
                return set(range(0, T, stride))
        raise ValueError(spec)
    counts = [int(spec)] if isinstance(spec, int) else [int(s) for s in str(spec).split(",")]
    size, extra, start, kept = T // len(counts), T % len(counts), 0, []
    for i, c in enumerate(counts):
        n = size + (1 if i < extra else 0)
        stride = (n - 1) / (c - 1) if c > 1 else 1.0
        kept += [start + round(stride * j) for j in range(c)]
        start += n
    return set(kept)


@dataclasses.dataclass
class Preset:
    """What the step needs of a preset, parsed from its dict."""

    T: int
    model_t: np.ndarray           # [T] the timestep fed to the UNet
    c: Dict[str, np.ndarray]      # per-step float64 coefficients
    sample_pattern: dict
    n_iter: int
    x_prev_every: int
    gradient_x_prev: bool
    clip: float                   # 0: no clipping
    clip_denoised: bool
    scale: np.ndarray             # [1] or [4]
    phi_cold: Dict[str, np.ndarray]
    etas: Dict[str, float]
    depth_value: np.ndarray
    weight_value: np.ndarray
    aux: Dict[str, float]

    @classmethod
    def from_dict(cls, p: dict) -> "Preset":
        d, cond, op = p["diffusion"], p["conditioning"], p["measurement"]["operator"]
        prm, sp = cond["params"], p["sample_pattern"]
        unsupported = [
            ("sampler", d["sampler"], "ddpm"), ("model_mean_type", d["model_mean_type"], "epsilon"),
            ("model_var_type", d["model_var_type"], "learned_range"),
            ("noise_schedule", d["noise_schedule"], "linear"),
            ("method", cond["method"], "osmosis"), ("loss_function", prm["loss_function"], "norm"),
            ("loss_weight", prm["loss_weight"], "depth"),
            ("operator", op["name"], "underwater_physical_revised"),
            ("optimizer", op.get("optimizer", "sgd"), "sgd"), ("depth_type", op["depth_type"], "gamma"),
            ("pattern", sp["pattern"], "pcgs"), ("local_M", sp["local_M"], 1),
            ("noise", p["measurement"]["noise"]["name"], "clean"),
            ("dynamic_threshold", bool(d.get("dynamic_threshold")), False),
            ("rescale_timesteps", bool(d.get("rescale_timesteps")), False),
            ("phi_warmup_iters", int(sp.get("phi_warmup_iters", 0) or 0), 0),
        ]
        for key, got, want in unsupported:
            if got != want:
                raise NotImplementedError(f"the reference step has {key} = {want!r}, not {got!r}")
        steps = int(d["steps"])
        base = np.linspace(1e-4 * 1000 / steps, 0.02 * 1000 / steps, steps, dtype=np.float64)
        acp_full = np.cumprod(1.0 - base)
        kept = sorted(space_timesteps(steps, d.get("timestep_respacing") or steps))
        last, betas = 1.0, []
        for i in kept:
            betas.append(1.0 - acp_full[i] / last)
            last = acp_full[i]
        betas = np.array(betas)
        acp = np.cumprod(1.0 - betas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        c = dict(
            sqrt_recip=np.sqrt(1.0 / acp), sqrt_recipm1=np.sqrt(1.0 / acp - 1.0),
            coef1=betas * np.sqrt(acp_prev) / (1.0 - acp),
            coef2=(1.0 - acp_prev) * np.sqrt(1.0 - betas) / (1.0 - acp),
            min_log=np.log(np.append(post_var[1], post_var[1:])), max_log=np.log(betas))
        clip_spec = [s.strip() for s in str(prm.get("gradient_clip", "False")).split(",")]
        names = ("phi_a", "phi_b", "phi_inf")
        return cls(
            T=len(kept), model_t=np.array(kept, dtype=np.float32), c=c, sample_pattern=sp,
            n_iter=int(sp["n_iter"]), x_prev_every=int(prm.get("x_prev_every", 1)),
            gradient_x_prev=_flag(prm.get("gradient_x_prev", False)),
            clip=float(clip_spec[1]) if _flag(clip_spec[0]) else 0.0,
            clip_denoised=bool(d.get("clip_denoised", False)),
            scale=_floats(prm.get("scale", 1.0)),
            phi_cold={k: _floats(op[k])[None] for k in names},
            etas={k: float(op.get(f"{k}_eta", 1e-5)) if _flag(op.get(f"{k}_learn_flag", True))
                  else 0.0 for k in names},
            depth_value=_floats(op["value"]),
            weight_value=_floats(prm["weight_function"].split(",", 1)[1]),
            aux=({k: float(v) for k, v in (p.get("aux_loss") or {}).get("aux_loss", {}).items()}
                 if p.get("aux_loss") else {}))

    def frozen(self, t: int) -> bool:
        """pcgs: phi is frozen outside the guidance window and outside
        [update_end T, update_start T]."""
        sp, T = self.sample_pattern, self.T
        return bool(t > sp["start_guidance"] * T or t < sp["stop_guidance"] * T
                    or t > sp["update_start"] * T or t < sp["update_end"] * T)

    def coef(self, name: str, t: int, device) -> torch.Tensor:
        return torch.tensor(np.float32(self.c[name][t]), device=device)


def draw_seed(seed: int, *path: int) -> int:
    """A 63-bit generator seed from ``seed`` and a path of integers (numpy's
    SeedSequence), the rule by which the program keys its chain noise."""
    words = np.random.SeedSequence([int(seed) & U64, *path]).generate_state(2, np.uint32)
    return ((int(words[0]) << 32) | int(words[1])) >> 1


def chain_noise(chain_seed: int, t: int, shape, device) -> torch.Tensor:
    """The step-t noise of a chain keyed on ``chain_seed``: one image's draw,
    shared by the lanes of a batch."""
    gen = torch.Generator(device=device).manual_seed(draw_seed(chain_seed, 1, int(t), 0))
    one = torch.randn((1,) + tuple(shape[1:]), generator=gen, device=device)
    return one.expand(tuple(shape))


def formation(P: Preset, phi: Dict[str, torch.Tensor], x0: torch.Tensor) -> torch.Tensor:
    """The revised underwater image formation, in [0, 1]."""
    a, b, g = (float(v) for v in P.depth_value)
    z = ((x0[..., 3:4] + a) * b) ** g
    bc = lambda k: phi[k][:, None, None, :]  # noqa: E731
    return 0.5 * (x0[..., :3] + 1.0) * torch.exp(-bc("phi_a") * z) + bc("phi_inf") * (
        1.0 - torch.exp(-bc("phi_b") * z))


def losses(P: Preset, phi, x0, y):
    """(total, per-image norm): the images' losses summed, each its norm
    term plus its auxiliary terms."""
    a, b, g = (float(v) for v in P.weight_value)
    w = ((x0.detach()[..., 3:4] + a) * b) ** g
    diff = (y - (2.0 * formation(P, phi, x0) - 1.0)) * w
    sep = torch.sqrt((diff ** 2).sum(dim=(1, 2, 3)))
    total = sep.sum()
    rgb = x0[..., :3]
    for name, weight in P.aux.items():
        if name == "avrg_loss":
            total = total + weight * rgb.mean(dim=(1, 2)).abs().sum()
        elif name == "val_loss":
            total = total + weight * (torch.clamp(rgb.abs() - 0.7, min=0.0) ** 2).mean(
                dim=(1, 2, 3)).sum()
        else:
            raise NotImplementedError(name)
    return total, sep


def phi_fit(P: Preset, phi, x0, y):
    """The step's phi iterations at x0-hat: (phi after, g_x0, per-image loss)."""
    phi = {k: v.detach().float() for k, v in phi.items()}
    for _ in range(P.n_iter - 1):
        leaves = {k: v.clone().requires_grad_(True) for k, v in phi.items()}
        with torch.enable_grad():
            total, _ = losses(P, leaves, x0.detach(), y)
            gs = torch.autograd.grad(total, list(leaves.values()))
        phi = {k: phi[k] - P.etas[k] * g for k, g in zip(phi, gs)}
    leaves = {k: v.clone().requires_grad_(True) for k, v in phi.items()}
    x0_leaf = x0.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        total, sep = losses(P, leaves, x0_leaf, y)
        gs = torch.autograd.grad(total, [x0_leaf] + list(leaves.values()))
    phi = {k: phi[k] - P.etas[k] * g for k, g in zip(phi, gs[1:])}
    return phi, gs[0], sep.detach()


def gap(prog: torch.Tensor, ref: torch.Tensor, norm: Optional[torch.Tensor] = None) -> float:
    """The widest difference over the largest reference value (or the
    largest value of ``norm``); a non-finite program value reads inf."""
    prog, ref = prog.double(), ref.double()
    if not bool(torch.isfinite(prog).all()):
        return math.inf
    den = float((ref if norm is None else norm.double()).abs().max())
    num = float((prog - ref).abs().max())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def check_step(P: Preset, unet, rec: dict, y: torch.Tensor, chain_seed: int) -> Dict[str, float]:
    """The gaps of one recorded program step against the reference.

    ``rec`` holds the program's values at the step (tensors on the
    reference's device): ``t``, ``x`` (x_t), ``out`` (the UNet's output),
    ``phi_before`` / ``phi_after``, ``sep`` and ``x0_std`` (the step's trace
    entries), ``x_next`` (x_{t-1}), on an x_prev step ``u`` (the cotangent
    into the UNet's output) and ``gx`` (the pullback to x_t, before the
    clip), and at a segment's end ``x0`` (its x0-hat).

    Each stage is computed from the program's values at its input and
    compared at its output: the UNet from x_t (``eps``, ``var``); its
    pullback of the program's cotangent (``pullback``); x0-hat from the
    program's eps (``x0_std``, ``x0``); the phi fit and the loss from that
    x0-hat and the program's phi (``phi_step``, ``loss``); the cotangent from
    them (``cotangent``); and x_{t-1} from the program's eps, variance and
    pullback (``sample``). A clamp decided on values that differ by rounding
    then moves neither side alone."""
    t, x, out = int(rec["t"]), rec["x"].float(), rec["out"].float()
    dev = x.device
    if P.frozen(t):
        raise ValueError(f"step t={t} lies outside the phi-update window")
    x_prev = "u" in rec
    mt = torch.full((x.shape[0],), float(P.model_t[t]), device=dev)
    gaps: Dict[str, float] = {}
    # the UNet, and on an x_prev step its pullback of the program's cotangent
    if x_prev:
        xr = x.clone().requires_grad_(True)
        with torch.enable_grad():
            out_r = unet(xr, mt)
            (jtu,) = torch.autograd.grad(out_r, xr, rec["u"].float())
        out_r = out_r.detach()
    else:
        with torch.no_grad():
            out_r = unet(x, mt)
    gaps["eps"] = gap(out[..., :4], out_r[..., :4])
    gaps["var"] = gap(out[..., 4:], out_r[..., 4:])
    sr, srm1 = P.coef("sqrt_recip", t, dev), P.coef("sqrt_recipm1", t, dev)
    if x_prev:
        # x0-hat's own path to x_t: d x0 / d x is sqrt(1/abar) where
        # d x0 / d eps is -sqrt(1/abar - 1)
        gaps["pullback"] = gap(rec["gx"], jtu - (sr / srm1) * rec["u"].float()[..., :4])
    # x0-hat from the program's eps
    eps = out[..., :4].clone().requires_grad_(x_prev)
    with torch.enable_grad():
        x0_graph = sr * x - srm1 * eps
        if P.clip_denoised:
            x0_graph = torch.clamp(x0_graph, -1.0, 1.0)
    x0 = x0_graph.detach()
    gaps["x0_std"] = gap(rec["x0_std"], x0.reshape(x0.shape[0], -1).std(dim=1, unbiased=False))
    if "x0" in rec:
        gaps["x0"] = gap(rec["x0"], x0)
    # the phi fit and the loss
    phi_r, g_x0, sep_r = phi_fit(P, rec["phi_before"], x0, y)
    keys = sorted(phi_r)
    before = torch.cat([rec["phi_before"][k].float() for k in keys], dim=1)
    gaps["phi_step"] = gap(torch.cat([rec["phi_after"][k].float() for k in keys], 1) - before,
                           torch.cat([phi_r[k] for k in keys], 1) - before)
    gaps["loss"] = gap(rec["sep"], sep_r)
    # the guidance
    if x_prev:
        (u_eps,) = torch.autograd.grad(x0_graph, eps, g_x0)
        gaps["cotangent"] = gap(rec["u"], torch.cat([u_eps, torch.zeros_like(u_eps)], dim=-1))
        g = rec["gx"].float()
        if P.clip:
            g = torch.clamp(g, -P.clip, P.clip)
    else:
        g = g_x0
    scale = torch.tensor(P.scale, dtype=torch.float32, device=dev)
    mean = P.coef("coef1", t, dev) * x0 + P.coef("coef2", t, dev) * x
    frac = (out[..., 4:] + 1.0) / 2.0
    logvar = frac * P.coef("max_log", t, dev) + (1.0 - frac) * P.coef("min_log", t, dev)
    x_next = mean - scale * g
    if t > 0:
        x_next = x_next + torch.exp(0.5 * logvar) * chain_noise(chain_seed, t, x.shape, dev)
    gaps["sample"] = gap(rec["x_next"], x_next, norm=x_next - x)
    return gaps
