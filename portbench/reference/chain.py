"""A segment of the guided chain computed by the reference, at a chosen
precision: the control that the comparison has to refuse.

``segment(...)`` takes and returns what a segment of the program's chain
entry does (x_t, y, the chain seed, phi, the timesteps; the sample, x0-hat,
phi and the per-step traces), so it can take the program's place in a run.
The UNet is the caller's (the reference UNet, its products' operands
rounded below the configuration's precision); the stages after it (x0-hat,
the phi fit, the loss and its gradient, the posterior step) are
:mod:`reference.diffusion`'s, computed in ``dtype`` (bfloat16 where the
configuration states float32 for them).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from .diffusion import Preset, chain_noise, losses


def _fit(P: Preset, phi, x0, y):
    """The step's phi iterations in x0's dtype: (phi after, g_x0, loss)."""
    for _ in range(P.n_iter - 1):
        leaves = {k: v.detach().requires_grad_(True) for k, v in phi.items()}
        with torch.enable_grad():
            total, _ = losses(P, leaves, x0, y)
            gs = torch.autograd.grad(total, list(leaves.values()))
        phi = {k: (phi[k] - P.etas[k] * g).detach() for k, g in zip(phi, gs)}
    leaves = {k: v.detach().requires_grad_(True) for k, v in phi.items()}
    x0_leaf = x0.detach().requires_grad_(True)
    with torch.enable_grad():
        total, sep = losses(P, leaves, x0_leaf, y)
        gs = torch.autograd.grad(total, [x0_leaf] + list(leaves.values()))
    phi = {k: (phi[k] - P.etas[k] * g).detach() for k, g in zip(phi, gs[1:])}
    return phi, gs[0], sep.detach()


def segment(P: Preset, unet, x, y, chain_seed: int, phi, ts, buf=None, dtype=torch.bfloat16):
    """The steps ``ts`` from x_t = ``x`` (phi ``phi``; None: the cold phi);
    ``buf``, the program's snapshot buffer, passes through untouched."""
    dev, lanes = x.device, x.shape[0]
    if phi is None:
        phi = {k: torch.tensor(v, dtype=torch.float32, device=dev).expand(lanes, -1)
               for k, v in P.phi_cold.items()}
    phi = {k: v.to(dtype) for k, v in phi.items()}
    y_d = y.to(dtype)
    every = P.x_prev_every if P.x_prev_every > 1 and P.gradient_x_prev else 1
    scale = torch.tensor(P.scale, dtype=dtype, device=dev)
    seps, phis, stds = [], [], []
    x0 = None
    for s, t in enumerate(ts):
        x_prev = P.gradient_x_prev and s % every == 0
        c = lambda name: P.coef(name, t, dev).to(dtype)  # noqa: E731
        mt = torch.full((lanes,), float(P.model_t[t]), device=dev)
        xg = x.detach().requires_grad_(x_prev)
        with torch.set_grad_enabled(x_prev):
            out = unet(xg, mt)
            x0_graph = P.coef("sqrt_recip", t, dev) * xg - P.coef("sqrt_recipm1", t, dev) * out[..., :4]
            if P.clip_denoised:
                x0_graph = torch.clamp(x0_graph, -1.0, 1.0)
        x0 = x0_graph.detach().to(dtype)
        phi, g_x0, sep = _fit(P, phi, x0, y_d)
        if x_prev:
            (g,) = torch.autograd.grad(x0_graph, xg, g_x0.float())
            g = torch.clamp(g, -P.clip, P.clip).to(dtype) if P.clip else g.to(dtype)
        else:
            g = g_x0
        v = out.detach()[..., 4:].to(dtype)
        logvar = (v + 1) / 2 * c("max_log") + (1 - (v + 1) / 2) * c("min_log")
        nxt = c("coef1") * x0 + c("coef2") * x.to(dtype) - scale * g
        if t > 0:
            nxt = nxt + torch.exp(0.5 * logvar) * chain_noise(chain_seed, t, x.shape, dev).to(dtype)
        x = nxt.float()
        seps.append(sep.float())
        phis.append({k: p.float() for k, p in phi.items()})
        stds.append(x0.float().reshape(lanes, -1).std(dim=1, unbiased=False))
    phi32 = {k: p.float() for k, p in phi.items()}
    return SimpleNamespace(sample=x, pred_xstart=x0.float(), phi=phi32, opt_state={},
                           x0_snapshots=buf, sep_loss=torch.stack(seps), x0_std_trace=torch.stack(stds),
                           phi_trace={k: torch.stack([p[k] for p in phis]) for k in phi32})
