"""The (dp, tp) mesh against one process: a sharded UNet, sharded guided
chains and a sharded fleet must compute what the unsharded ones compute.

    python -m osmosis_tpu_torch.tools.mesh_check --checkpoint CKPT --out DIR \\
        [--ranks 2] [--backend gloo] [--meshes 1x2,2x1] [--size 256] [--cpu | -d 0]

Run from the repository's root. It writes a seeded input (or copies
``--inputs``), runs every check in this process without a mesh (the
reference), then starts ``--ranks``
processes of this tool (``--rank K``), joined over ``--backend`` at a free
local port, that run the same checks on each mesh of ``--meshes`` (DPxTP),
and holds every rank's result against the reference:

  * ``unet`` (tp-only meshes): one UNet forward and its pullback with respect to
    x at batch 1, t = 999;
  * ``chain`` (tp-only meshes): the guided chain at batch 1 with the dryrun's
    settings (``__graft_entry__._guided_chain_parts``: the underwater
    operator, sgd phi, scale 7,7,7,0.9, the aux losses avrg 0.5 and val 20),
    ``--steps`` steps, ``--n-iter`` phi iterations, ``--x-prev-every``,
    clip_denoised, noise drawn once (or read from the inputs) and fed
    through ``noise_fn``;
  * ``joint`` (meshes with dp > 1): the same chain at batch ``--lanes`` (dp
    x k images), whose loss couples the images (the joint norm and the aux
    losses over the whole batch), through ``guided_sample_loop(mesh=)``:
    each dp rank runs its images and reduces the loss over the dp group
    (the dryrun's phase 1, ``run_guided_chain(batch_size=dp, mesh=)``),
    the noise of every image read from the inputs;
  * ``fleet`` (meshes with dp > 1): the fleet runner (``parallel/runner.py``) at
    ``--lanes`` lanes with ``mesh=``, chain noise keyed on a seed.

Under dp > 1 a rank differs from one process at the whole batch in its
UNet's batch and in the order of the loss's sums, and the guided chain
amplifies the first: so the reference of ``joint`` runs the whole batch
with its UNet called on one rank's share of the images at a time, and that
of ``fleet`` each rank's lanes in a call of their own; the difference from
the whole batch in one call is reported beside each, not held.

Ranks that share one card (``-d 0`` for all) need gloo; NCCL takes a card a
rank (rank k on ``cuda:k``). Each rank writes its outputs
(``<mesh>_<check>_rank<k>.npz``) and a report (launch counts of K1-K4 per
check, peak memory, parameter bytes and seconds) under ``--out``; the last
line printed is a JSON summary with the largest differences. On the card
the checks run in fp32 with TF32 off and cuDNN's deterministic algorithms.
The bar is ``__graft_entry__.assert_chain_equivalence``'s: rtol/atol 5e-4
on outputs, x0-hat and phi traces, 1e-3 on the loss trace, with one excuse
(:func:`compare`): in a chain check a sample value past 5e-4 is excused where
a clamp flip explains it, as far as one-process runs with the UNet's output
moved by the mesh's own difference move it (``summary.json``'s ``bar``, and a
line on stdout for each excused value). Every mesh is compared and
``summary.json`` written before a failure raises. On the card ``--sites``
also reports what was live at each check's peak, by allocation site
(``memory``; the check's seconds then include the recording).
``--perturb EPS`` also reruns each one-process check with the UNet's output
moved by EPS of seeded noise and reports how far that moves its outputs:
the guided chain with clip_denoised amplifies rounding where x0-hat sits at
the clamp's edge. For each dp mesh ``summary.json`` also holds ``edges``
(:func:`edge_report`): where the joint chain's sample is furthest from its
reference, x0-hat before the clamp there at each step in both runs, the
last step's guidance gradient against the gradient clip, and the elements
the clamp takes in one run and not the other; ``conditioning_edges`` holds
the same for each perturbed one-process joint chain against its own.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RTOL = ATOL = 5e-4
LOSS_TOL = 1e-3
CHECKS = ("unet", "chain", "joint", "fleet")
TRACE = "trace."  # a chain check's arrays for the excuse and edge_report, not held to the bar
# The excuse (compare): the UNet's output on the mesh is measured against the
# reference's, its largest difference over its largest value; the perturbed
# one-process runs move the UNet's output by that much, measured the same way
# (at least EPS_FLOOR, about an fp32 ulp), once for each seed; a mesh whose
# UNet is off by more than EPS_CAP (about 3x the largest seen on the H100,
# 3.36e-6 at 1x4) is a fault, excused nowhere
EPS_FLOOR, EPS_CAP, BAR_SEEDS = 1e-7, 1e-5, (0, 1, 2)
EXCUSE_FACTOR = 2.0  # an excused value is at most this times the perturbed runs' largest


def chain_parts(batch_size: int = 1, steps: int = 4, n_iter: int = 2, update_start: float = 0.7,
                x_prev_every: int = 1):
    """The port's copy of ``__graft_entry__._guided_chain_parts``: schedule,
    operator, sample pattern and guidance config of the short guided chain."""
    from ..diffusion.guided import GuidanceConfig
    from ..diffusion.schedules import make_schedule
    from ..guidance.operators import get_operator

    schedule = make_schedule("cosine", steps)
    operator = get_operator(
        "underwater_physical_revised", batch_size=batch_size, optimizer="sgd",
        depth_type="gamma", value="1.4,1.4,1",
        phi_a="1.1,0.95,0.95", phi_b="0.95,0.8,0.8", phi_inf="0.14,0.29,0.49")
    pattern = dict(pattern="pcgs", update_start=update_start, update_end=0, global_N=1,
                   local_M=1, s_start=1, s_end=0, n_iter=n_iter, start_guidance=1,
                   stop_guidance=0)
    gcfg = GuidanceConfig.from_config(
        "osmosis", dict(loss_function="norm", loss_weight="depth",
                        weight_function="gamma,1.4,1.4,1", scale="7,7,7,0.9",
                        gradient_x_prev=True, gradient_clip="True,0.005",
                        x_prev_every=x_prev_every),
        pattern, {"aux_loss": {"avrg_loss": 0.5, "val_loss": 20.0}})
    return schedule, operator, pattern, gcfg


def make_inputs(path: str, size: int, steps: int, lanes: int, seed: int = 0) -> None:
    """Seeded inputs: x and y at batch 1 and at ``lanes``, the cotangent of
    the UNet's output, and the chain's noise for each step at batch 1
    (``noise``) and at ``lanes`` (``noises``)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    np.savez(path, x=f(1, size, size, 4), y=rng.uniform(-1, 1, (1, size, size, 3)).astype(
        np.float32), cot=f(1, size, size, 8), noise=f(steps, 1, size, size, 4),
        xs=f(lanes, size, size, 4),
        ys=rng.uniform(-1, 1, (lanes, size, size, 3)).astype(np.float32),
        noises=f(steps, lanes, size, size, 4))


KERNELS = ("upsample_nearest_2x", "box_sum_2x", "group_norm_forward", "group_norm_backward")


def kernel_counts() -> Dict[str, int]:
    from ..utils import profiling

    c = profiling.counters()
    return {name: c[f"{name}.launches"] for name in KERNELS}


def zero_kernel_counts() -> None:
    from ..utils import profiling

    profiling.reset_counters(*(f"{name}.launches" for name in KERNELS),
                             "group_norm_forward.kernel_launches",
                             "group_norm_backward.kernel_launches")


def _result(res) -> Dict[str, np.ndarray]:
    out = {"sample": res.sample, "pred_xstart": res.pred_xstart, "sep_loss": res.sep_loss,
           **{f"phi_trace.{k}": v for k, v in res.phi_trace.items()}}
    return {k: v.detach().float().cpu().numpy() for k, v in out.items()}


def chunked(model, parts: int):
    """``model`` called on ``parts`` equal slices of the batch in turn, as
    ``parts`` dp ranks call it."""
    def fn(x, t):
        return torch.cat([model(a, b) for a, b in zip(x.chunk(parts), t.chunk(parts))])
    return fn


def recorded(model, calls: list):
    """``model``, keeping each call's input and output in ``calls``."""
    def fn(x, t):
        out = model(x, t)
        calls.append((x.detach(), out.detach()))
        return out
    return fn


def edge_trace(calls: list, res, schedule, mesh=None) -> Dict[str, np.ndarray]:
    """What the excuse (:func:`compare`) and :func:`edge_report` read of a
    chain (one UNet call a step) on this rank's images: x0-hat before the
    clamp at each step ([T, B, H, W, C]), the first step's UNet output (the
    same input on every mesh) and the last step's guidance, its posterior
    mean less its sample (no noise is added at t = 0)."""
    from ..diffusion.sampler import (SamplerConfig, device_constants, posterior_mean,
                                     predict_xstart, split_model_output)

    consts = device_constants(schedule, calls[0][0].device)
    x0s = []
    for s, (x, out) in enumerate(calls):
        tb = torch.full((x.shape[0],), schedule.num_timesteps - 1 - s, dtype=torch.long,
                        device=x.device)
        x0s.append(predict_xstart(x, tb, split_model_output(out, x.shape[-1])[0], consts,
                                  SamplerConfig()))
    B = x.shape[0]
    row0 = mesh.index("dp") * B if mesh is not None else 0
    guidance = posterior_mean(x0s[-1].clamp(-1.0, 1.0), x, tb, consts) - res.sample[row0:row0 + B]
    return {TRACE + "x0_pre": torch.stack(x0s).cpu().numpy(),
            TRACE + "out0": calls[0][1].cpu().numpy(), TRACE + "guidance": guidance.cpu().numpy()}


def _axis(key: str) -> int:
    """The image axis of a check's array: 1 for those over steps."""
    return 1 if key in ("sep_loss", TRACE + "x0_pre") or key.startswith("phi_trace") else 0


def edge_report(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray], gcfg) -> dict:
    """Where the joint chain's sample ``got`` is furthest from ``ref`` (both
    with :func:`edge_trace`'s arrays for the whole batch): the index [b, y, x,
    c], both samples, both last-step guidance gradients (guidance over the
    channel's scale; ``gcfg``'s gradient clip holds them within it), and at each
    step both x0-hat before the clamp at the index, the count of elements
    the clamp (|x0-hat| > 1) takes in one run and not the other, and the
    nearest of them to the index in its image (Chebyshev pixels)."""
    diff = np.abs(got["sample"].astype(np.float64) - ref["sample"])
    idx = tuple(int(i) for i in np.unravel_index(int(diff.argmax()), diff.shape))
    x0r, x0g = ref[TRACE + "x0_pre"], got[TRACE + "x0_pre"]
    c_scale = float(np.broadcast_to(np.asarray(gcfg.scale, np.float64),
                                    (diff.shape[-1],))[idx[-1]])
    steps = []
    for k in range(len(x0r)):
        flips = np.argwhere((np.abs(x0r[k]) > 1) != (np.abs(x0g[k]) > 1))
        same = flips[flips[:, 0] == idx[0]]
        dist = np.abs(same[:, 1:3] - np.asarray(idx[1:3])).max(1) if len(same) else None
        steps.append(dict(
            x0_pre=[float(x0r[k][idx]), float(x0g[k][idx])], clamp_flips=int(len(flips)),
            nearest_flip=None if dist is None else [int(i) for i in same[int(dist.argmin())]],
            nearest_flip_pixels=None if dist is None else int(dist.min())))
    return dict(index=list(idx), max_abs=float(diff[idx]),
                sample=[float(ref["sample"][idx]), float(got["sample"][idx])],
                gradient=[float(ref[TRACE + "guidance"][idx]) / c_scale,
                          float(got[TRACE + "guidance"][idx]) / c_scale],
                gradient_clip=gcfg.gradient_clip_value, steps=steps)


def run_check(check: str, model, inputs: dict, device, args, mesh=None, shards: int = 1,
              stats: Optional[dict] = None) -> Dict[str, np.ndarray]:
    """One check on ``model`` (sharded or not), its outputs as numpy, with
    :func:`edge_trace`'s arrays for a chain. With ``shards`` the joint chain
    calls its UNet on ``shards`` slices of the batch, and the fleet runs its
    lanes in ``shards`` groups, one call each, as ``shards`` dp ranks do; on
    the card ``stats["group_peak_bytes"]`` gets each group's peak."""
    from ..diffusion.guided import guided_sample_loop
    from ..diffusion.sampler import SamplerConfig
    from ..parallel.runner import make_batched_guided_runner

    dev = lambda k: torch.from_numpy(inputs[k]).to(device)  # noqa: E731
    if check == "unet":
        x = dev("x").requires_grad_(True)
        out = model(x, torch.full((1,), 999, device=device))
        (dx,) = torch.autograd.grad(out, x, dev("cot"))
        return {"out": out.detach().cpu().numpy(), "dx": dx.cpu().numpy()}
    chain = (args.steps, args.n_iter, args.update_start, args.x_prev_every)
    calls: list = []
    if check == "chain":
        schedule, operator, pattern, gcfg = chain_parts(1, *chain)
        noise = dev("noise")
        res = guided_sample_loop(recorded(model, calls), schedule, dev("x"), dev("y"), operator,
                                 gcfg, SamplerConfig(clip_denoised=True), sample_pattern=pattern,
                                 noise_fn=lambda t, shape, *i: noise[int(t)].expand(shape))
        return {**_result(res), **edge_trace(calls, res, schedule)}
    if check == "joint":
        xs, noises = dev("xs"), dev("noises")
        schedule, operator, pattern, gcfg = chain_parts(xs.shape[0], *chain)
        res = guided_sample_loop(recorded(chunked(model, shards), calls), schedule, xs,
                                 dev("ys"), operator, gcfg, SamplerConfig(clip_denoised=True),
                                 sample_pattern=pattern,
                                 noise_fn=lambda t, shape, *i: noises[int(t)], mesh=mesh)
        return {**_result(res), **edge_trace(calls, res, schedule, mesh)}
    schedule, operator, pattern, gcfg = chain_parts(1, *chain)
    xs, ys = dev("xs"), dev("ys")
    step = xs.shape[0] // shards
    parts, peaks = [], []
    for j in range(shards):
        calls = []
        run = make_batched_guided_runner(recorded(model, calls), schedule, operator, gcfg,
                                         SamplerConfig(clip_denoised=True),
                                         sample_pattern=pattern, mesh=mesh)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        res = run(xs[j * step:(j + 1) * step], ys[j * step:(j + 1) * step], seed=args.seed)
        parts.append({**_result(res), **edge_trace(calls, res, schedule, mesh)})
        if device.type == "cuda":
            peaks.append(torch.cuda.max_memory_allocated(device))
    if stats is not None and peaks:
        stats["group_peak_bytes"] = peaks
    return {k: np.concatenate([p[k] for p in parts], axis=_axis(k)) for k in parts[0]}


def perturbed(model, eps: float, device, seed: int = 0, relative: bool = False):
    """``model`` with seeded normal noise added to its output, ``eps`` its
    standard deviation (``--perturb``) or, ``relative``, scaled so that its
    largest value is ``eps`` times the output's largest (the bar's: the
    mesh's difference is measured so, :func:`unet_difference`): run through
    a check, it shows how far the check moves when the UNet's output moves
    by rounding, mesh or not."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def fn(x, t):
        out = model(x, t)
        z = torch.randn(out.shape, generator=gen, device=out.device, dtype=out.dtype)
        scale = eps * out.detach().abs().max() / z.abs().max() if relative else eps
        return out + scale * z
    return fn


def clamp_flips(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray]) -> np.ndarray:
    """[T, B, H, W, C]: where the clamp (|x0-hat| > 1) takes an element in
    one run and not the other, step by step."""
    return (np.abs(ref[TRACE + "x0_pre"]) > 1) != (np.abs(got[TRACE + "x0_pre"]) > 1)


def _misses(got: np.ndarray, ref: np.ndarray, tol: float) -> np.ndarray:
    """Where ``got`` is past rtol/atol ``tol`` of ``ref`` (assert_allclose's rule)."""
    return np.abs(got.astype(np.float64) - ref) > tol + tol * np.abs(ref)


def unet_difference(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray]) -> float:
    """The first step's UNet output against the reference's, relative: the
    largest difference over the largest value."""
    r = ref[TRACE + "out0"].astype(np.float64)
    return float(np.abs(got[TRACE + "out0"] - r).max() / max(float(np.abs(r).max()), 1e-30))


def movement(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray]) -> dict:
    """How far a chain ``got`` is from ``ref`` in the excuse's terms: the
    clamp flips summed over steps, the sample values past RTOL and the
    largest sample difference; and the same two for x0-hat (reported)."""
    out = dict(clamp_flips=int(clamp_flips(ref, got).sum()))
    for k, name in (("sample", "sample"), ("pred_xstart", "x0")):
        out[f"{name}_misses"] = int(_misses(got[k], ref[k], RTOL).sum())
        out[f"{name}_max_abs"] = float(np.abs(got[k].astype(np.float64) - ref[k]).max())
    return out


def _flip_of(flips: np.ndarray, idx: tuple) -> Optional[Tuple[int, tuple]]:
    """The flip that explains a sample value at ``idx`` [b, y, x, c]: its
    step and element; the element's own flip at any step first, else the
    first flip in its image at a step before the last. None: no flip does."""
    own = np.flatnonzero(flips[(slice(None),) + idx])
    if len(own):
        return int(own[0]), idx
    for k in range(len(flips) - 1):
        at = np.argwhere(flips[k, idx[0]])
        if len(at):
            return k, (idx[0],) + tuple(int(i) for i in at[0])
    return None


def judge(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray], what: str,
          bar: Optional[dict] = None) -> Tuple[dict, List[str]]:
    """The verdict on ``got`` against ``ref`` and its faults (empty: it
    passes). Every held output is held at rtol/atol RTOL (LOSS_TOL on the
    loss trace). ``bar`` (a chain check's: ``measured``, the UNet's relative
    difference on the mesh, :func:`unet_difference`; ``perturbed``, the
    :func:`movement` of each one-process run with the UNet's output moved by
    that much, or a function that runs them, called only when a value is to
    be excused) excuses sample values only, and only those that a clamp flip
    explains: the value's own element flips at some step, or its image has a
    flip at a step before the last (x_{t-1} moves there, and the next UNet
    call spreads it over the image). The excuse holds only when the measured
    difference is within EPS_CAP, the mesh's clamp flips and sample misses
    are no more than the most of any perturbed run, and each excused value is
    within EXCUSE_FACTOR times the perturbed runs' largest sample difference.
    x0-hat, the phi and loss traces and the ``unet`` check get no excuse; the
    verdict counts the x0-hat values past RTOL in images with a flip at a
    step before the last (``x0_misses_after_a_flip``). Raises on another
    shape or a non-finite value."""
    faults, excused, after_a_flip = [], [], None
    for k, r in _held(ref).items():
        g = got[k]
        if g.shape != r.shape:
            raise AssertionError(f"{what} {k}: shape {g.shape}, expected {r.shape}")
        if not (np.isfinite(r).all() and np.isfinite(g).all()):
            raise AssertionError(f"{what} {k}: non-finite values")
        tol = LOSS_TOL if k == "sep_loss" else RTOL
        miss = _misses(g, r, tol)
        if k == "sample" and bar is not None and miss.any():
            flips = clamp_flips(ref, got)
            for idx in map(tuple, np.argwhere(miss)):
                flip = _flip_of(flips, idx)
                if flip is None:
                    continue
                miss[idx] = False
                step, at = flip
                excused.append(dict(
                    index=[int(i) for i in idx], sample=[float(r[idx]), float(g[idx])],
                    flip_step=step, flip=[int(i) for i in at],
                    x0_pre=[float(ref[TRACE + "x0_pre"][(step,) + at]),
                            float(got[TRACE + "x0_pre"][(step,) + at])]))
        if k == "pred_xstart" and bar is not None:
            earlier = clamp_flips(ref, got)[:-1].any(axis=(0, 2, 3, 4))  # [B]
            after_a_flip = int(miss[earlier].sum())
        if miss.any():
            diff = np.abs(g.astype(np.float64) - r)
            worst = tuple(int(i) for i in np.unravel_index(int(np.where(miss, diff, -1).argmax()),
                                                           diff.shape))
            faults.append(f"{what} {k}: {int(miss.sum())} of {miss.size} values past rtol/atol "
                          f"{tol:g} that no clamp flip explains; the largest {diff[worst]:.3e} at "
                          f"{list(worst)}: {float(g[worst])!r} against {float(r[worst])!r}")
    verdict = dict(differences=differences(ref, got), excused=excused)
    if bar is not None:
        verdict.update(movement(ref, got), x0_misses_after_a_flip=after_a_flip)
        if bar["measured"] > EPS_CAP:
            faults.append(f"{what}: the UNet's output is {bar['measured']:.3e} relative from the "
                          f"reference's, past the cap {EPS_CAP:g}: nothing is excused")
    if excused:
        runs = bar["perturbed"]() if callable(bar["perturbed"]) else bar["perturbed"]
        most = {k: max(p[k] for p in runs) for k in runs[0]}
        for k in ("clamp_flips", "sample_misses"):
            if verdict[k] > most[k]:
                faults.append(f"{what}: {verdict[k]} {k.replace('_', ' ')}, more than the "
                              f"{most[k]} of the perturbed runs: the flips do not excuse it")
        bound = EXCUSE_FACTOR * most["sample_max_abs"]
        over = [e for e in excused if abs(e["sample"][1] - e["sample"][0]) > bound]
        if over:
            faults.append(f"{what}: {len(over)} excused sample values past {EXCUSE_FACTOR:g} x "
                          f"the perturbed runs' largest difference ({bound:.3e}), first "
                          f"{over[0]['index']}: {over[0]['sample']}")
    return verdict, faults


def compare(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray], what: str,
            bar: Optional[dict] = None) -> dict:
    """:func:`judge`'s verdict; raises on anything it cannot excuse."""
    verdict, faults = judge(ref, got, what, bar)
    if faults:
        raise AssertionError("\n".join(faults))
    return verdict


def peak_sites(events: list, start: int, top: int = 12) -> dict:
    """What was live at the peak of the allocator's history ``events`` (a
    ``torch.cuda.memory._snapshot()``'s ``device_traces`` of one device)
    that began with ``start`` bytes allocated: the peak, the bytes allocated
    since the start that were still live there by allocation site (the
    innermost frame in this package, else the innermost Python frame; the
    autograd engine's own allocations have none), and the bytes freed but
    not yet reusable (waiting for another stream)."""
    cur = peak = start
    at, requested = -1, set()
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            cur += e["size"]
        elif e["action"] == "free_requested":
            cur -= e["size"]
            requested.add(e["addr"])
        elif e["action"] == "free_completed":
            if e["addr"] in requested:
                requested.discard(e["addr"])
            else:
                cur -= e["size"]
        if cur > peak:
            peak, at = cur, i
    live, pending = {}, {}
    for e in events[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_requested" and e["addr"] in live:
            pending[e["addr"]] = live.pop(e["addr"])
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
            pending.pop(e["addr"], None)
    sites: Dict[str, list] = {}
    for e in live.values():
        frames = e.get("frames") or []
        own = [f for f in frames if "osmosis_tpu_torch" in f["filename"]]
        f = (own or frames or [None])[0]
        site = ("autograd engine (no Python frame)" if f is None else
                f"{os.path.relpath(f['filename'], REPO)}:{f['line']} ({f['name']})")
        row = sites.setdefault(site, [0, 0])
        row[0] += e["size"]
        row[1] += 1
    rows = sorted(sites.items(), key=lambda kv: -kv[1][0])
    return dict(peak_bytes=peak, start_bytes=start,
                live_since_start_bytes=sum(e["size"] for e in live.values()),
                pending_free_bytes=sum(e["size"] for e in pending.values()),
                sites=[dict(site=k, bytes=b, blocks=n) for k, (b, n) in rows[:top]])


def measured(fn, device, sites: bool = False):
    """``fn(stats)``'s result and a record of the call: seconds, K1-K4
    launches, peak bytes (on the card) and what ``fn`` put in ``stats``. With
    ``sites`` (on the card) the allocator's history is recorded through the
    call and the record gets what was live at the peak (:func:`peak_sites`);
    the seconds then include the recording."""
    cuda = device.type == "cuda"
    sites = sites and cuda
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.memory_allocated(device)
    if sites:
        torch.cuda.memory._record_memory_history("all", context="alloc", stacks="python",
                                                 clear_history=True)
    zero_kernel_counts()
    stats: dict = {}
    t0 = time.perf_counter()
    out = fn(stats)
    _sync(device)
    record = dict(seconds=time.perf_counter() - t0, launches=kernel_counts(), peak_bytes=None)
    if sites:
        events = torch.cuda.memory._snapshot(device)["device_traces"][device.index]
        torch.cuda.memory._record_memory_history(None)
        record["memory"] = peak_sites(events, start)
    if cuda:
        record["peak_bytes"] = max([torch.cuda.max_memory_allocated(device)]
                                   + stats.get("group_peak_bytes", []))
    record.update(stats)
    return out, record


def checks_of(mesh_name: str):
    """The UNet and the batch-1 chain on a tp-only mesh, the joint chain and
    the fleet where there is a dp axis."""
    dp, tp = (int(v) for v in mesh_name.split("x"))
    return ("unet", "chain") if dp == 1 and tp > 1 else ("joint", "fleet")


def _device(args):
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
    return torch.device("cuda", args.device)


def _setup(device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def _config(args):
    from ..models.unet import UNetConfig

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in json.loads(args.unet).items()
          } if args.unet else {}
    return UNetConfig(**dict(dict(image_size=args.size), **kw))


def _load(args, device):
    from ..models.convert import load_unet

    return load_unet(args.checkpoint, _config(args), device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_main(args) -> int:
    """One rank: every mesh of ``--meshes`` in turn, each check of it."""
    from ..parallel import mesh as M
    from ..parallel import multihost

    device = _device(args)
    _setup(device)
    multihost.initialize(args.coordinator, args.ranks, args.rank, backend=args.backend)
    inputs = dict(np.load(os.path.join(args.out, "inputs.npz")))
    for mesh_name in args.meshes.split(","):
        dp, tp = (int(v) for v in mesh_name.split("x"))
        mesh = M.make_mesh(dp=dp, tp=tp)
        model = _load(args, device)
        full_bytes = M.local_parameter_bytes(model)
        M.shard_params(model, mesh)
        sharded = M.layout(model, tp)
        report = dict(rank=args.rank, mesh=mesh.shape, dp_index=mesh.index("dp"),
                      tp_index=mesh.index("tp"), full_parameter_bytes=full_bytes,
                      local_parameter_bytes=M.local_parameter_bytes(model),
                      sharded_parameter_bytes=sum(
                          p.numel() * p.element_size() for n, p in model.named_parameters()
                          if sharded[n]),
                      placements={n: "shard" if p.placements[1].is_shard() else "replicate"
                                  for n, p in model.named_parameters()},
                      checks={})
        for check in checks_of(mesh_name):
            out, report["checks"][check] = measured(
                lambda stats: run_check(check, model, inputs, device, args, mesh, stats=stats),
                device, args.sites)
            np.savez(os.path.join(args.out, f"{mesh_name}_{check}_rank{args.rank}.npz"), **out)
        with open(os.path.join(args.out, f"{mesh_name}_rank{args.rank}.json"), "w") as f:
            json.dump(report, f)
        del model
    multihost.barrier("mesh_check_done")
    return 0


def _held(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: v for k, v in out.items() if not k.startswith(TRACE)}


def differences(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray]) -> dict:
    """{output: max abs and max relative difference}."""
    out = {}
    for k, r in _held(ref).items():
        diff = np.abs(got[k].astype(np.float64) - r)
        out[k] = dict(max_abs=float(diff.max(initial=0.0)),
                      max_rel=float((diff / np.maximum(np.abs(r), 1e-12)).max(initial=0.0)))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_group(outs: list, reps: list, k: int) -> Dict[str, np.ndarray]:
    """Rank k's outputs with the traces of every rank of its dp group (the
    ranks of its tp index), in image order: the images its result holds."""
    group = sorted((r for r in reps if r["tp_index"] == reps[k]["tp_index"]),
                   key=lambda r: r["dp_index"])
    return {**outs[k], **{key: np.concatenate([outs[r["rank"]][key] for r in group],
                                              axis=_axis(key))
                          for key in outs[k] if key.startswith(TRACE)}}


def launch(args, timeout: float, rank_cmd: Optional[list] = None) -> dict:
    """The reference in this process, the ranks as subprocesses (``rank_cmd``
    each, the arguments appended; default this tool), the comparison;
    returns the summary."""
    device = _device(args)
    _setup(device)
    os.makedirs(args.out, exist_ok=True)
    meshes = args.meshes.split(",")
    path = os.path.join(args.out, "inputs.npz")
    if args.inputs:
        shutil.copy(args.inputs, path)
    else:
        make_inputs(path, args.size, args.steps, args.lanes)
    inputs = dict(np.load(path))
    model = _load(args, device)
    summary: dict = dict(reference={}, meshes={}, bar={}, edges={})
    # what one process computes where its UNet sees what each of dp ranks sees: "<check>/<dp>"
    names = [c for c in CHECKS if any(c in checks_of(m) for m in meshes)] + [
        f"{c}/{dp}" for dp in sorted({int(m.split("x")[0]) for m in meshes} - {1})
        for c in ("joint", "fleet")]

    def one_process(name, fn, stats=None):
        check, _, dp = name.partition("/")
        return run_check(check, fn, inputs, device, args, shards=int(dp or 1), stats=stats)

    refs = {}
    for name in names:
        refs[name], summary["reference"][name] = measured(
            lambda stats: one_process(name, model, stats), device, args.sites)
    _, _, _, gcfg = chain_parts(args.lanes, args.steps, args.n_iter, args.update_start,
                                args.x_prev_every)
    if args.perturb:
        for key in ("conditioning", "conditioning_movement", "conditioning_edges"):
            summary[key] = {}
        for name, ref in refs.items():
            out = one_process(name, perturbed(model, args.perturb, device))
            summary["conditioning"][name] = differences(ref, out)
            if not name.startswith("unet"):
                summary["conditioning_movement"][name] = movement(ref, out)
            if name.startswith("joint"):
                summary["conditioning_edges"][name] = edge_report(ref, out, gcfg)
    model = None  # the ranks may share the card
    if device.type == "cuda":
        torch.cuda.empty_cache()
    coordinator = f"127.0.0.1:{_free_port()}"
    cmd = [*(rank_cmd or [sys.executable, "-m", "osmosis_tpu_torch.tools.mesh_check"]),
           *args.argv, "--coordinator", coordinator]
    procs, t0 = [], time.perf_counter()
    try:
        for k in range(args.ranks):
            dev = ["--cpu"] if args.cpu else ["-d", str(args.device if args.backend == "gloo"
                                                         else k)]
            log = open(os.path.join(args.out, f"rank{k}.log"), "w")
            procs.append((subprocess.Popen(cmd + ["--rank", str(k), *dev], stdout=log,
                                           stderr=subprocess.STDOUT, cwd=REPO,
                                           env=dict(os.environ, OMP_NUM_THREADS="1",
                                                    PYTHONPATH=REPO)), log))
        deadline = time.time() + timeout
        for p, _ in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    summary["ranks_seconds"] = time.perf_counter() - t0
    for k, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(args.out, f"rank{k}.log")) as f:
                raise AssertionError(f"rank {k} exited {p.returncode}:\n{f.read()[-4000:]}")
    failures: List[str] = []
    moved: dict = {}  # (reference, eps): the perturbed runs' movements, made at first need

    def perturbed_runs(name: str, eps: float):
        def runs():
            nonlocal model
            if (name, eps) not in moved:
                if model is None:
                    model = _load(args, device)
                moved[name, eps] = [movement(refs[name], one_process(name, perturbed(
                    model, eps, device, seed, relative=True))) for seed in BAR_SEEDS]
            return moved[name, eps]
        return runs

    for mesh_name in meshes:
        reps = []
        for k in range(args.ranks):
            with open(os.path.join(args.out, f"{mesh_name}_rank{k}.json")) as f:
                reps.append(json.load(f))
        dp = reps[0]["mesh"]["dp"]
        summary["bar"][mesh_name] = {}
        for rep in reps:
            rep["differences"], rep["bar"] = {}, {}
            del rep["placements"]
        for check in checks_of(mesh_name):
            name = f"{check}/{dp}" if dp > 1 else check
            ref = refs[name]
            outs = [dict(np.load(os.path.join(args.out, f"{mesh_name}_{check}_rank{k}.npz")))
                    for k in range(args.ranks)]
            gots = [_dp_group(outs, reps, k) for k in range(args.ranks)]
            bar = None
            if check != "unet":  # a chain: the excuse, bounded by the mesh's own rounding
                by_rank = [unet_difference(ref, g) for g in gots]
                eps = max(EPS_FLOOR, min(max(by_rank), EPS_CAP))
                bar = dict(measured=max(by_rank), eps=eps, perturbed=perturbed_runs(name, eps))
                summary["bar"][mesh_name][check] = dict(bar, measured_by_rank=by_rank, ranks={})
            for k, (rep, got) in enumerate(zip(reps, gots)):
                what = f"mesh {mesh_name} rank {k} {check}"
                try:
                    verdict, faults = judge(ref, got, what, bar)
                except AssertionError as e:  # another shape or a non-finite value
                    failures.append(str(e))
                    continue
                failures.extend(faults)
                rep["differences"][check] = verdict.pop("differences")
                rep["bar"][check] = verdict
                if bar is not None:
                    summary["bar"][mesh_name][check]["ranks"][k] = dict(
                        {c: verdict[c] for c in ("clamp_flips", "sample_misses", "x0_misses",
                                                 "x0_misses_after_a_flip")},
                        excused=len(verdict["excused"]))
                for e in verdict["excused"]:
                    print(f"excused: {what} sample {e['index']}: {e['sample'][0]:.7g} in one "
                          f"process, {e['sample'][1]:.7g} on the mesh; clamp flip at step "
                          f"{e['flip_step']}, {e['flip']}: x0-hat before the clamp "
                          f"{e['x0_pre'][0]:.7g} / {e['x0_pre'][1]:.7g}", flush=True)
                if dp > 1:  # reported, not held: the UNet at another batch
                    rep[f"whole_batch_{check}_differences"] = differences(refs[check], got)
            if bar is not None:  # null: nothing was excused, so the runs were not made
                summary["bar"][mesh_name][check]["perturbed"] = moved.get((name, bar["eps"]))
            if check == "joint":  # the worst value, traced over every dp rank's images
                summary["edges"][mesh_name] = edge_report(ref, gots[0], gcfg)
        summary["meshes"][mesh_name] = reps
    model = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    summary["failures"] = failures
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if failures:  # every mesh's numbers are in the summary first
        raise AssertionError("\n".join(failures))
    return summary


def parse(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help=".pt, .msgpack or an orbax dir; 'seeded': the seeded random-init .pt "
                         "(tools/runbook_rehearsal) of --unet's model, else the preset's, "
                         "written for the run")
    ap.add_argument("--out", required=True)
    ap.add_argument("--unet", default=None, help="UNetConfig keywords as JSON (default: the "
                                                 "preset's model at --size)")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--meshes", default="1x2,2x1", help="DPxTP, comma-separated")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--n-iter", type=int, default=1)
    ap.add_argument("--update-start", type=float, default=1.0)
    ap.add_argument("--x-prev-every", type=int, default=1,
                    help="the hybrid schedule's x_prev_every (needs --steps above it)")
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--inputs", default=None, help="an .npz of x, y, cot, noise, xs, ys, noises "
                                                   "to use instead of seeded draws")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="also run each one-process check with the UNet's output moved by this "
                         "much seeded noise and report how far its outputs move (summary "
                         "'conditioning'), beside the bar")
    ap.add_argument("--sites", action="store_true",
                    help="on the card, record the allocator's history through each check and "
                         "report what was live at its peak by allocation site ('memory'); the "
                         "checks' seconds then include the recording")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("-d", "--device", type=int, default=0, help="CUDA device index")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.argv = [a for a in (sys.argv[1:] if argv is None else argv)]
    return args


def main(argv: Optional[list] = None) -> int:
    args = parse(argv)
    if args.rank is not None:
        return rank_main(args)
    if args.checkpoint == "seeded":
        import tempfile

        from .runbook_rehearsal import seeded_checkpoint

        build = os.path.join(REPO, "osmosis_tpu_torch", "_build")
        os.makedirs(build, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            args.checkpoint = os.path.join(tmp, "seeded.pt")
            seeded_checkpoint(args.checkpoint, _config(args) if args.unet else None)
            args.argv[args.argv.index("seeded")] = args.checkpoint
            summary = launch(args, args.timeout)
    else:
        summary = launch(args, args.timeout)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
