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
on outputs, x0-hat and phi traces, 1e-3 on the loss trace. Every mesh is
compared and ``summary.json`` written before a failure raises.
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
from typing import Dict, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RTOL = ATOL = 5e-4
LOSS_TOL = 1e-3
CHECKS = ("unet", "chain", "joint", "fleet")
TRACE = "trace."  # a joint check's arrays for edge_report, not held to the bar


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


def kernel_counts() -> Dict[str, int]:
    from ..ops import group_norm as G
    from ..ops import upsample as U

    return {"upsample_nearest_2x": U.upsample_nearest_2x_kernel.launches,
            "box_sum_2x": U.box_sum_2x_kernel.launches,
            "group_norm_forward": G.group_norm_forward.launches,
            "group_norm_backward": G.group_norm_backward.launches}


def zero_kernel_counts() -> None:
    from ..ops import group_norm as G
    from ..ops import upsample as U

    for fn in (U.upsample_nearest_2x_kernel, U.box_sum_2x_kernel, G.group_norm_forward,
               G.group_norm_backward):
        fn.launches = 0
    G.group_norm_forward.kernel_launches = G.group_norm_backward.kernel_launches = 0


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
    """What :func:`edge_report` reads of a joint chain (one UNet call a step)
    on this rank's images: x0-hat before the clamp at each step ([T, B, H, W,
    C]) and the last step's guidance, its posterior mean less its sample (no
    noise is added at t = 0)."""
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
            TRACE + "guidance": guidance.cpu().numpy()}


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


def run_check(check: str, model, inputs: dict, device, args, mesh=None,
              shards: int = 1) -> Dict[str, np.ndarray]:
    """One check on ``model`` (sharded or not), its outputs as numpy. With
    ``shards`` the joint chain calls its UNet on ``shards`` slices of the
    batch, and the fleet runs its lanes in ``shards`` groups, one call each,
    as ``shards`` dp ranks do."""
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
    if check == "chain":
        schedule, operator, pattern, gcfg = chain_parts(1, *chain)
        noise = dev("noise")
        res = guided_sample_loop(model, schedule, dev("x"), dev("y"), operator, gcfg,
                                 SamplerConfig(clip_denoised=True), sample_pattern=pattern,
                                 noise_fn=lambda t, shape, *i: noise[int(t)].expand(shape))
        return _result(res)
    if check == "joint":
        xs, noises = dev("xs"), dev("noises")
        schedule, operator, pattern, gcfg = chain_parts(xs.shape[0], *chain)
        calls: list = []
        res = guided_sample_loop(recorded(chunked(model, shards), calls), schedule, xs,
                                 dev("ys"), operator, gcfg, SamplerConfig(clip_denoised=True),
                                 sample_pattern=pattern,
                                 noise_fn=lambda t, shape, *i: noises[int(t)], mesh=mesh)
        return {**_result(res), **edge_trace(calls, res, schedule, mesh)}
    schedule, operator, pattern, gcfg = chain_parts(1, *chain)
    run = make_batched_guided_runner(model, schedule, operator, gcfg,
                                     SamplerConfig(clip_denoised=True), sample_pattern=pattern,
                                     mesh=mesh)
    xs, ys = dev("xs"), dev("ys")
    step = xs.shape[0] // shards
    parts = [_result(run(xs[j * step:(j + 1) * step], ys[j * step:(j + 1) * step],
                         seed=args.seed)) for j in range(shards)]
    return {k: np.concatenate([p[k] for p in parts], axis=1 if k in ("sep_loss",) or
                              k.startswith("phi_trace") else 0) for k in parts[0]}


def perturbed(model, eps: float, device, seed: int = 0):
    """``model`` with ``eps`` times seeded normal noise added to its output:
    run through a check, it shows how far the check moves when the UNet's
    output moves by rounding (``--perturb``), mesh or not."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def fn(x, t):
        out = model(x, t)
        return out + eps * torch.randn(out.shape, generator=gen, device=out.device,
                                       dtype=out.dtype)
    return fn


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


def _load(args, device):
    from ..models.convert import load_unet
    from ..models.unet import UNetConfig

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in json.loads(args.unet).items()
          } if args.unet else {}
    cfg = UNetConfig(**dict(dict(image_size=args.size), **kw))
    return load_unet(args.checkpoint, cfg, device)


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
            _sync(device)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            zero_kernel_counts()
            t0 = time.perf_counter()
            out = run_check(check, model, inputs, device, args, mesh)
            _sync(device)
            report["checks"][check] = dict(
                seconds=time.perf_counter() - t0, launches=kernel_counts(),
                peak_bytes=torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                else None)
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


def compare(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray], what: str) -> dict:
    """:func:`differences`; raises past the bar (or on a non-finite value or
    another shape)."""
    for k, r in _held(ref).items():
        g = got[k]
        if g.shape != r.shape:
            raise AssertionError(f"{what} {k}: shape {g.shape}, expected {r.shape}")
        if not (np.isfinite(r).all() and np.isfinite(g).all()):
            raise AssertionError(f"{what} {k}: non-finite values")
        tol = LOSS_TOL if k == "sep_loss" else RTOL
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol, err_msg=f"{what} {k}")
    return differences(ref, got)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, timeout: float) -> dict:
    """The reference in this process, the ranks as subprocesses, the
    comparison; returns the summary."""
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
    summary: dict = dict(reference={}, meshes={}, edges={})
    refs = {}
    for check in sorted({c for m in meshes for c in checks_of(m)}, key=CHECKS.index):
        _sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        zero_kernel_counts()
        t0 = time.perf_counter()
        refs[check] = run_check(check, model, inputs, device, args)
        _sync(device)
        summary["reference"][check] = dict(
            seconds=time.perf_counter() - t0, launches=kernel_counts(),
            peak_bytes=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None)
    for dp in sorted({int(m.split("x")[0]) for m in meshes} - {1}):
        # what one process computes where its UNet sees what each of dp ranks sees
        for check in ("joint", "fleet"):
            refs[f"{check}/{dp}"] = run_check(check, model, inputs, device, args, shards=dp)
    _, _, _, gcfg = chain_parts(args.lanes, args.steps, args.n_iter, args.update_start,
                                args.x_prev_every)
    if args.perturb:
        summary["conditioning"], summary["conditioning_edges"] = {}, {}
        for name, ref in refs.items():
            check, _, dp = name.partition("/")
            out = run_check(check, perturbed(model, args.perturb, device), inputs, device, args,
                            shards=int(dp or 1))
            summary["conditioning"][name] = differences(ref, out)
            if check == "joint":
                summary["conditioning_edges"][name] = edge_report(ref, out, gcfg)
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    coordinator = f"127.0.0.1:{_free_port()}"
    cmd = [sys.executable, "-m", "osmosis_tpu_torch.tools.mesh_check", *args.argv,
           "--coordinator", coordinator]
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
    failures = []
    for mesh_name in meshes:
        ranks = []
        for k in range(args.ranks):
            with open(os.path.join(args.out, f"{mesh_name}_rank{k}.json")) as f:
                rep = json.load(f)
            rep["differences"] = {}
            dp = rep["mesh"]["dp"]
            for check in checks_of(mesh_name):
                got = dict(np.load(os.path.join(args.out, f"{mesh_name}_{check}_rank{k}.npz")))
                ref = refs[f"{check}/{dp}"] if dp > 1 else refs[check]
                try:
                    rep["differences"][check] = compare(ref, got, f"mesh {mesh_name} rank {k} "
                                                                  f"{check}")
                except AssertionError as e:
                    failures.append(str(e))
                    if all(got[o].shape == r.shape for o, r in _held(ref).items()):
                        rep["differences"][check] = differences(ref, got)
                if dp > 1:  # reported, not held: the UNet at another batch
                    rep[f"whole_batch_{check}_differences"] = differences(refs[check], got)
            del rep["placements"]
            ranks.append(rep)
        summary["meshes"][mesh_name] = ranks
        if ranks[0]["mesh"]["dp"] > 1:  # the joint chain's worst value, from every dp rank's trace
            traces = [np.load(os.path.join(args.out, f"{mesh_name}_joint_rank{r['rank']}.npz"))
                      for r in sorted(ranks, key=lambda r: r["dp_index"]) if r["tp_index"] == 0]
            got = {"sample": traces[0]["sample"],
                   **{k: np.concatenate([t[k] for t in traces], axis=int(k.endswith("x0_pre")))
                      for k in traces[0].files if k.startswith(TRACE)}}
            summary["edges"][mesh_name] = edge_report(
                refs[f"joint/{ranks[0]['mesh']['dp']}"], got, gcfg)
    summary["failures"] = failures
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if failures:  # every mesh's numbers are in the summary first
        raise AssertionError("\n".join(failures))
    return summary


def parse(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help=".pt, .msgpack or an orbax dir; 'seeded': the preset's seeded "
                         "random-init .pt (tools/runbook_rehearsal), written for the run")
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
            seeded_checkpoint(args.checkpoint)
            args.argv[args.argv.index("seeded")] = args.checkpoint
            summary = launch(args, args.timeout)
    else:
        summary = launch(args, args.timeout)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
