"""Guided restoration pipeline (port of ``osmosis_tpu/pipelines/restore.py``,
the reference osmosis_sampling.py:33-409).

Per image: preprocess on the host, run the guided chain on the device
(:func:`osmosis_tpu_torch.diffusion.guided.guided_sample_loop`), then
post-process on the host (physical recomposition, depth colormaps, grids)
into the reference's run-dir layout. ``use_fp16: True`` runs the UNet torso
in bfloat16; ``rgb_guidance: True`` runs vanilla DPS ('ps') and saves the
final sample's RGB and depth.

The JAX package's extensions, with its config keys:
  * ``data.batch_size > 1``: the fleet, chunks of images through one batched
    chain (:mod:`osmosis_tpu_torch.parallel.runner`), each image with its
    batch-1 math, measurement noise, x_start and chain noise;
  * ``best_of`` / ``accept_loss`` / ``phi_jitter``: restarts from other
    seeds, the lowest final loss kept;
  * ``sample_pattern.global_eta_scale``: global chain ii scales its phi
    steps by s**ii (0 freezes phi);
  * ``progress_segments``: the chain in segments, a progress row at each
    boundary, the same bits as one call;
  * ``chain_checkpoint``: durable state at every boundary
    (:mod:`osmosis_tpu_torch.utils.chainjournal`), so ``resume: True``
    continues an interrupted image mid-chain;
  * ``perf.async_save``: an image's PNG work overlaps the next chain.

In a multi-process run (:mod:`osmosis_tpu_torch.parallel.multihost`) every
process runs this same function: image i goes to rank i % P, into one run dir
that rank 0 allocates, and rank r > 0 logs to ``log-rank{r:03d}.txt``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import datetime
import hashlib
import json
import os
import time
from functools import partial
from os.path import join as pjoin
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .. import config as C
from .. import perf as PF
from ..data import datasets as D
from ..data import postprocess as P
from ..data import transforms as TR
from ..diffusion.guided import GuidanceConfig, GuidedResult, draw_seed, guided_sample_loop
from ..diffusion.sampler import SamplerConfig
from ..diffusion.schedules import make_schedule
from ..guidance.noise import get_noiser
from ..guidance.operators import convert_depth, get_operator
from ..models.convert import load_unet
from ..models.unet import unet_config_from_yaml
from ..parallel import multihost as MH
from ..parallel.runner import lane, make_batched_segment_runner, map_tensors
from ..utils import logging as L
from ..utils import native
from ..utils import profiling as prof
from ..utils.chainjournal import ChainJournal
from ..utils.rundir import make_output_dirs, update_save_dir_date

# process-wide count of chain-checkpoint boundary saves, read by the
# OSMOSIS_TPU_CRASH_AFTER_SEGMENTS fault-injection hook
_CRASH_SAVES = {"n": 0}


def resolve_device(device) -> torch.device:
    """The torch device for an entry point; CUDA without a card raises, so a
    run never falls back to the CPU unless it was asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' (--cpu on the CLI) to run on the CPU")
    return dev


def _better_loss(new_fl, best_fl) -> bool:
    """best_of selection: does a trial with final loss ``new_fl`` displace
    the best so far? Plain ``<``, plus a NaN arm: after a diverged trial 0
    seeded the best with NaN, ``new < nan`` is always False and no finite
    trial could win."""
    if best_fl is None:
        return True
    return bool(new_fl < best_fl or (np.isnan(best_fl) and np.isfinite(new_fl)))


def allocate_run_dir(base_dir: str, config_file: str, perf, resume: bool = False,
                     barrier: str = "rundir_allocated") -> str:
    """The run dir ``<base_dir>/<d-m-yy>/runN`` (with ``resume`` today's
    latest one) and its configurations.txt: the config, then the perf knobs.
    In a multi-process run rank 0 allocates it and writes the file, and after
    the barrier the other ranks re-enter it."""
    if MH.process_index() == 0:
        out_path = update_save_dir_date(base_dir, resume=resume)
        C.config_snapshot(config_file, pjoin(out_path, "configurations.txt"))
        with open(pjoin(out_path, "configurations.txt"), "a") as f:
            f.write(PF.snapshot_text(perf))
    if MH.is_multihost():
        MH.barrier(barrier)
        if MH.process_index() != 0:
            out_path = update_save_dir_date(base_dir, resume=True)
    return out_path


def configure_logger(out_path: str, device):
    """The run's logger: ``log.txt`` on rank 0, ``log-rank{r:03d}.txt`` on
    rank r, which first logs its place in a multi-process run."""
    logger = L.configure(out_path, rank_suffix=MH.rank_suffix())
    if MH.is_multihost():
        logger.log(f"multi-host run: process {MH.process_index()}/{MH.process_count()}, "
                   f"device {device}")
    return logger


def finish_multihost(logger, name):
    """Every rank waits for the others' slices, then says so."""
    if MH.is_multihost():
        MH.barrier(name)
        logger.log(f"multi-host: all processes finished (this rank: {MH.process_index()})")


def _grad_mode_str(cp):
    if not cp["gradient_x_prev"]:
        return "x0"
    k = int(cp.get("x_prev_every", 1))
    return f"x_prev every {k} steps, x0 between" if k > 1 else "x_prev"


def torso_dtype(args, dtype=torch.float32) -> torch.dtype:
    """The UNet torso dtype of a run: bfloat16 where the config sets
    ``use_fp16`` (the JAX package's half precision on the TPU), else ``dtype``."""
    return torch.bfloat16 if args.unet_model.get("use_fp16") else dtype


def precision_str(device, dtype) -> str:
    """The device and the arithmetic a run uses, for the run header."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    if dtype == torch.bfloat16:
        return f"{name}, bf16 torso, fp32 GroupNorm statistics"
    if device.type == "cuda":
        return (f"{name}, fp32 with TF32 off "
                "(cudnn.allow_tf32 = False, cuda.matmul.allow_tf32 = False)")
    return f"{name}, fp32"


def cudnn_deterministic(device, dtype, chain_checkpoint: bool) -> bool:
    """Does a run take cuDNN's deterministic algorithms? On a card a fp32 run
    with ``chain_checkpoint`` does: cuDNN's default fp32 backward-data
    algorithm sums in another order from call to call, so without them a
    resumed chain would continue the chain but not its bits. They cost a
    fp32 guided step 40% at batch 1 and 19% at batch 4 on an H100 (PERF.md,
    ``tools/cudnn_determinism``), so other runs keep the default algorithms,
    with which the bf16 torso repeats its bits. A caller that has set
    ``torch.backends.cudnn.deterministic`` keeps it."""
    if device.type != "cuda":
        return False
    return bool(torch.backends.cudnn.deterministic) or (
        dtype == torch.float32 and bool(chain_checkpoint))


def algorithms_str(device, deterministic: bool) -> str:
    """The convolution algorithms a run takes, for the run header."""
    if device.type != "cuda":
        return f"{device.type} (no cuDNN)"
    if deterministic:
        return ("cuDNN deterministic (cudnn.deterministic = True, cudnn.benchmark = False): "
                "a fp32 chain repeats its bits")
    return "cuDNN default (cudnn.deterministic = False)"


@contextlib.contextmanager
def cudnn_algorithms(deterministic: bool):
    """cuDNN's deterministic algorithms (``benchmark`` off) inside the block
    where ``deterministic``; the process's own settings again after it."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    if deterministic:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _log_run_header(logger, args, device, dtype):
    """utils.py:635-669 log_text equivalent, plus the device and the
    arithmetic it runs."""
    cp = args.conditioning["params"]
    op = args.measurement["operator"]
    txt = (
        f"\n\nGuidance Scale: {cp['scale']}"
        f"\nLoss Function: {cp['loss_function']}"
        f"\nweight: {cp['loss_weight']}, weight_function: {cp['weight_function']}"
        f"\nAuxiliary Loss: {args.aux_loss['aux_loss']}"
        f"\nUnderwater model: {op['name']}"
        f"\nOptimize w.r.t: {_grad_mode_str(cp)}"
        f"\nOptimizer model: {op.get('optimizer', 'none')}, "
        f"\nManual seed: {args.manual_seed}"
        f"\nDepth type: {op['depth_type']}, value: {op['value']}"
        f"\nNoise: {args.measurement['noise']['name']}"
    )
    if "sigma" in args.measurement["noise"]:
        txt += f", sigma: {args.measurement['noise']['sigma']}"
    clip_on, clip_val = C.parse_gradient_clip(cp["gradient_clip"])
    txt += f"\nGradient Clipping: {clip_on}"
    if clip_on:
        txt += f", min value: -{clip_val}, max value: {clip_val}"
    sp = args.sample_pattern
    if sp["pattern"] == "original":
        txt += "\nSample Pattern: original"
    else:
        txt += (
            f"\nSample Pattern: {sp['pattern']}, "
            f"\n     Guidance start: {sp['start_guidance']} ,end: {sp['stop_guidance']}"
            f"\n     Optimizations iters: {sp['n_iter']}, "
            f"\n     Update start from: {sp['update_start']}, end: {sp['update_end']}"
            f"\n     M: {sp['local_M']}, start: {sp['s_start']}, end: {sp['s_end']}"
        )
    txt += f"\nDevice: {precision_str(device, dtype)}"
    logger.log(txt)


def _map_result(fn, res: GuidedResult) -> GuidedResult:
    return dataclasses.replace(res, **{f.name: map_tensors(fn, getattr(res, f.name))
                                       for f in dataclasses.fields(res)})


def _to_numpy(res: GuidedResult) -> GuidedResult:
    """A copy of ``res`` with every tensor moved to the host as numpy."""
    return _map_result(lambda v: v.detach().cpu().numpy(), res)


def _cat_traces(pieces) -> dict:
    """The trace fields of consecutive segments, joined along the step axis."""
    cat = lambda get: torch.cat([get(p) for p in pieces])  # noqa: E731
    return dict(sep_loss=cat(lambda p: p.sep_loss),
                phi_trace={k: cat(lambda p: p.phi_trace[k]) for k in pieces[-1].phi_trace},
                aux_trace={k: cat(lambda p: p.aux_trace[k]) for k in pieces[-1].aux_trace},
                x0_std_trace=cat(lambda p: p.x0_std_trace))


def _make_chain_fn(seg_fn, schedule, progress_segments, k_align, device):
    """A chain runner over the serial or the fleet runner (both keep traces
    [T, B, ...]). ``seg_fn(x, y, seed, phi0, opt0, eta_s)`` runs the chain
    in one call; with ``progress_segments > 1`` ``seg_fn(..., ts, buf0,
    eps0)`` runs it in segments of a k-aligned length, logging a progress
    row (lane means) at each boundary, with the same bits. With a journal
    the state at every boundary is saved, and a chain whose partial state is
    found resumes from its last boundary."""
    T = schedule.num_timesteps
    full_ts = np.arange(T - 1, -1, -1)
    # non-final segments stay multiples of the hybrid block width, so the
    # x_prev steps fall where they fall in the unsegmented chain
    base = max(k_align, (T // max(progress_segments, 1)) // k_align * k_align)

    def chain(x_start, y, seed, phi0, opt0, eta_s, logger=None, journal=None, tag=(0, 0)):
        if progress_segments <= 1:
            return seg_fn(x_start, y, seed, phi0, opt0, eta_s)
        x, phi, opt, buf, eps = x_start, phi0, opt0, None, None
        pieces, done, res = [], 0, None
        part = journal.load_partial(tag) if journal is not None else None
        if part is not None:
            part = map_tensors(lambda a: a.to(device), part)
            done = int(part["done"])
            x, phi, opt, buf, eps = part["x"], part["phi"], part["opt"], part["buf"], part["eps"]
            pieces.append(SimpleNamespace(**part["traces"]))  # the prefix's traces
            if logger is not None:
                logger.log(f"  resuming chain at step {done}/{T} from the chain checkpoint "
                           "(bitwise-identical continuation)")
        while done < T:
            n = base if T - done >= 2 * base else T - done
            res = seg_fn(x, y, seed, phi, opt, eta_s, full_ts[done:done + n], buf, eps)
            x, phi, opt = res.sample, res.phi, res.opt_state
            buf, eps = res.x0_snapshots, res.eps_hist
            pieces.append(res)
            done += n
            if journal is not None and done < T:
                journal.save_partial(tag, dict(done=done, x=x, phi=phi, opt=opt, buf=buf, eps=eps,
                                               traces=_cat_traces(pieces)))
                _CRASH_SAVES["n"] += 1
                after = int(os.environ.get("OSMOSIS_TPU_CRASH_AFTER_SEGMENTS", 0) or 0)
                if after and _CRASH_SAVES["n"] >= after:
                    raise RuntimeError(
                        f"injected crash: OSMOSIS_TPU_CRASH_AFTER_SEGMENTS={after} reached")
            if logger is not None:
                row = (f"  progress {done:4d}/{T} steps (t={int(full_ts[done - 1])})"
                       f" loss={float(res.sep_loss[-1].mean()):9.3f}"
                       f" x0_std={float(res.x0_std_trace[-1].mean()):.3f}")
                phi_vals = {k: np.round(v[-1].double().mean(0).cpu().numpy(), 3).tolist()
                            for k, v in res.phi_trace.items()}
                logger.log(row + (f" {phi_vals}" if phi_vals else ""))
        return dataclasses.replace(res, **_cat_traces(pieces))

    return chain


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _log_trace_summary(logger, res, max_rows=10):
    """The reference's tqdm postfix (gaussian_diffusion.py:276-296: loss, aux
    and live phi) rebuilt from the chain's traces after it ends."""
    sep = res.sep_loss  # [T, B]
    T = sep.shape[0]
    if T == 0:
        return
    idx = np.unique(np.linspace(0, T - 1, max_rows).round().astype(int))
    # the JAX package's header, word for word, so that either package's
    # runbook reads either package's log.txt
    lines = ["chain telemetry (scan trace; step runs t=T-1..0):"]
    for i in idx:
        row = f"  t={T - 1 - i:4d} loss={float(sep[i].mean()):9.3f}"
        row += f" x0_std={float(res.x0_std_trace[i].mean()):.3f}"
        aux = {k: round(float(v[i]), 3) for k, v in res.aux_trace.items()}
        if aux:
            row += f" aux={aux}"
        phi_vals = {k: np.round(v[i, 0].astype(np.float64), 3).tolist()
                    for k, v in res.phi_trace.items()}
        if phi_vals:
            row += f" {phi_vals}"
        lines.append(row)
    logger.log("\n".join(lines))


def _save_process_grid(snapshots, path):
    """Recorded x0-hat snapshots -> an rgb row over a depth row."""
    x0s = snapshots["x0_hat"]  # [K, B, H, W, 4]
    rgb_row, depth_row = [], []
    for k in range(x0s.shape[0]):
        x0 = x0s[k, 0]
        rgb_row.append(P.clip01(P.to_01(x0[..., 0:3])))
        d = P.min_max_norm_range_percentile(x0[..., 3], percent_low=0.05, percent_high=0.99)
        depth_row.append(P.depth_to_color(d))
    P.save_png(P.make_grid(rgb_row + depth_row, nrow=len(rgb_row)), path)


def run_restoration(config_file: str, device="cuda:0",
                    save_dir_override: Optional[str] = None, dtype=torch.float32,
                    progress_every: Optional[int] = None) -> str:
    """Run guided restoration over the configured dataset; returns the run dir.

    Runs on ``device`` (CUDA unless the caller passes ``"cpu"``). The UNet
    torso runs in bfloat16 where the config sets ``use_fp16`` or ``dtype`` is
    ``torch.bfloat16``, else in fp32, which on CUDA runs with TF32 off for
    cuDNN's convolutions and for matmuls; a fp32 run with ``chain_checkpoint``
    takes cuDNN's deterministic algorithms (:func:`cudnn_deterministic`), so
    that a resumed chain writes the uninterrupted one's bytes, and the log
    says which algorithms and which host ops (native or numpy) the run took.
    ``progress_every`` prints the loss
    and phi (of the first image of a batch) every that many timesteps.
    ``x_start`` comes from a ``torch.Generator`` seeded with the trial's seed
    (``manual_seed`` + 7919·restart) and the chain noise is keyed on (seed,
    t, i), so their bits differ from the JAX package's ``jax.random``
    streams, but not between a segmented, resumed or batched chain and the
    plain one.
    """
    dev = resolve_device(device)
    args = C.arguments_from_file(config_file)
    perf = PF.configure_from_dict(getattr(args, "perf", None))
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    image_size = args.unet_model["image_size"]
    data_config = args.data
    gt_flag = bool(data_config.get("ground_truth", False))
    transform = partial(TR.preprocess_image, size=image_size)
    if gt_flag:
        dataset = D.ImagesFolderGT(data_config["root"], data_config["gt_rgb"],
                                   data_config["gt_depth"], transform=transform)
    else:
        dataset = D.ImagesFolder(data_config["root"], transform=transform)

    dtype = torso_dtype(args, dtype)
    ucfg = unet_config_from_yaml(args.unet_model)
    model = load_unet(args.unet_model.get("model_path", ""), ucfg, dev, dtype=dtype)
    rgb_guidance = bool(getattr(args, "rgb_guidance", False))

    measure_config = args.measurement
    sample_pattern = args.sample_pattern
    resume = bool(getattr(args, "resume", False))
    operator_name = measure_config["operator"]["name"]
    base = save_dir_override or args.save_dir
    out_path = allocate_run_dir(os.path.abspath(pjoin(base, operator_name, data_config["name"])),
                                config_file, perf, resume=resume)
    paths = make_output_dirs(out_path, args.save_singles, args.save_grids)
    logger = configure_logger(out_path, dev)
    logger.log(f"pretrained model file: {args.unet_model['model_path']}")
    if not rgb_guidance:
        _log_run_header(logger, args, dev, dtype)
    chain_checkpoint = bool(getattr(args, "chain_checkpoint", False))
    deterministic = cudnn_deterministic(dev, dtype, chain_checkpoint)
    logger.log(f"Convolution algorithms: {algorithms_str(dev, deterministic)}"
               f"\nHost ops: {native.status()}")

    dcfg = args.diffusion
    schedule = make_schedule(
        noise_schedule=dcfg["noise_schedule"], steps=dcfg["steps"],
        timestep_respacing=dcfg.get("timestep_respacing", ""),
        rescale_timesteps=dcfg.get("rescale_timesteps", False),
    )
    scfg = SamplerConfig(
        sampler=dcfg["sampler"], model_mean_type=dcfg["model_mean_type"],
        model_var_type=dcfg["model_var_type"],
        dynamic_threshold=dcfg.get("dynamic_threshold", False),
        clip_denoised=dcfg.get("clip_denoised", False),
    )
    op_kwargs = {k: v for k, v in measure_config["operator"].items() if k != "name"}
    operator = get_operator(operator_name, batch_size=1, **op_kwargs)
    gcfg = GuidanceConfig.from_config(
        "ps" if rgb_guidance else args.conditioning["method"], args.conditioning["params"],
        sample_pattern, args.aux_loss, noiser_name=measure_config["noise"]["name"],
    )
    record_every = args.record_every if args.record_process else None

    if sample_pattern["pattern"] == "pcgs":
        global_N = sample_pattern.get("global_N", 1)
    elif sample_pattern["pattern"] == "original":
        global_N = 1
    else:
        raise ValueError(f"Unrecognized sample pattern: {sample_pattern['pattern']}")
    g_eta = sample_pattern.get("global_eta_scale")  # 0.0 is legal: phi frozen
    batch_size = int(data_config.get("batch_size", 1) or 1)
    progress_segments = int(getattr(args, "progress_segments", 0) or 0)
    chain_fp = chain_fingerprint(args, dtype, dev) if chain_checkpoint else ""

    k_align = gcfg.x_prev_every if (gcfg.x_prev_every > 1 and (
        gcfg.gradient_x_prev or gcfg.method == "ps")) else 1
    run = SimpleNamespace(
        args=args, dev=dev, dataset=dataset, paths=paths, logger=logger, out_path=out_path,
        operator=operator, measure_config=measure_config,
        noiser=get_noiser(**measure_config["noise"]),
        gt_flag=gt_flag, image_size=image_size, record_every=record_every,
        rgb_guidance=rgb_guidance, resume=resume, global_N=global_N,
        global_opt_reset=bool(sample_pattern.get("global_opt_reset", False)),
        g_eta=1.0 if g_eta is None else float(g_eta),
        stop_after=data_config.get("stop_after", -1),
        best_of=int(getattr(args, "best_of", 1) or 1),
        accept_loss=getattr(args, "accept_loss", None),
        phi_jitter=float(getattr(args, "phi_jitter", 0.0) or 0.0),
        chain_checkpoint=chain_checkpoint, chain_fp=chain_fp,
        async_save=perf.async_save,
        phi_cold={k: torch.as_tensor(v, device=dev) for k, v in operator.phi_init().items()},
    )

    if batch_size > 1:
        seg = make_batched_segment_runner(model, schedule, operator, gcfg, scfg,
                                          sample_pattern, record_every, progress_every)
    else:
        def seg(x, y, seed, phi0, opt0, eta_s, ts=None, buf0=None, eps0=None):
            return guided_sample_loop(
                model, schedule, x, y, operator, gcfg, scfg, sample_pattern=sample_pattern,
                record_every=record_every, phi_init=phi0, opt_state_init=opt0, seed=seed,
                eta_scale=eta_s, ts=ts, x0_buf_init=buf0, eps_hist_init=eps0,
                progress_every=progress_every)
    run.chain = _make_chain_fn(seg, schedule, progress_segments, k_align, dev)
    with cudnn_algorithms(deterministic), \
            _saver(run, backlog=2 * max(global_N, 1) * batch_size) as save:
        if batch_size > 1:
            _run_fleet(run, batch_size, save)
        else:
            _run_serial(run, save)
    finish_multihost(logger, "fleet_done" if batch_size > 1 else "serial_done")
    logger.log(prof.TIMERS.summary())
    logger.close()
    return out_path


def chain_fingerprint(args, dtype, device) -> str:
    """The chain checkpoint's fingerprint: everything that sets the chain's
    numbers. The torso dtype and the device type are in it, since the CUDA
    and CPU generators draw other noise from one seed; the run dir's place,
    resume and segmentation (bit-neutral) stay out, so a resume may change
    them."""
    fp_cfg = {k: v for k, v in vars(args).items()
              if k not in ("save_dir", "resume", "progress_segments", "chain_checkpoint")}
    fp_cfg["torso_dtype"] = str(dtype)
    fp_cfg["device_type"] = torch.device(device).type
    return hashlib.sha256(json.dumps(fp_cfg, sort_keys=True, default=str).encode()).hexdigest()[:16]


def _measurement(run, ref_np, i):
    """Image i's measurement: its noise from a generator seeded by the image
    index (the same on the serial and fleet paths), then degamma."""
    gen = torch.Generator(device=run.dev).manual_seed((run.args.manual_seed + 1) * 1_000_003 + i)
    y = run.noiser(torch.from_numpy(ref_np).to(run.dev), generator=gen)
    return TR.degamma(y) if getattr(run.args, "degamma_input", False) else y


def _trial_start(run, try_k):
    """Trial k's seed (trial 0: ``manual_seed``), its x_start [1, H, W, 4]
    and its phi init: cold, or for k > 0 with ``phi_jitter`` the cold phi
    plus phi_jitter·N(0, 1), each phi from its own keyed generator."""
    seed = run.args.manual_seed + 7919 * try_k
    gen = torch.Generator(device=run.dev).manual_seed(seed)
    x_start = torch.randn((1, run.image_size, run.image_size, 4), generator=gen, device=run.dev)
    phi = run.phi_cold
    if try_k and run.phi_jitter > 0:
        phi = {k: v + run.phi_jitter * torch.randn(
            v.shape, device=run.dev,
            generator=torch.Generator(device=run.dev).manual_seed(draw_seed(seed, 2, n)))
               for n, (k, v) in enumerate(sorted(run.phi_cold.items()))}
    return seed, x_start, phi


def _open_journal(run, name, what, fingerprint):
    if not run.chain_checkpoint:
        return None, {}
    journal = ChainJournal(run.out_path, name, fingerprint)
    saved = journal.load_chains()
    if saved:
        run.logger.log(f"chain checkpoint: {len(saved)} completed {what}(s) restored from a "
                       "previous run")
    return journal, saved


def _run_trial(run, seed, x_start, y, phi, journal, saved, try_k, what="chain"):
    """The global_N chains of one trial: phi (and, unless global_opt_reset,
    its optimizer state) warm-starts each chain from the one before; chain
    ii scales its phi steps by global_eta_scale**ii. Returns [(res, seconds)]."""
    phi_carry, opt_carry, trial = phi, None, []
    for global_ii in range(run.global_N):
        run.logger.log(f"global iteration: {global_ii}\n")
        eta_s = None if run.g_eta == 1.0 else run.g_eta ** global_ii
        if (try_k, global_ii) in saved:
            res, seconds = _map_result(lambda a: a.to(run.dev), saved[(try_k, global_ii)]), 0.0
            run.logger.log(f"{what} (restart {try_k}, global {global_ii}): replayed from the "
                           "chain checkpoint")
        else:
            t0 = time.perf_counter()
            with prof.phase("sample"):
                res = run.chain(x_start, y, seed, phi_carry, opt_carry, eta_s, logger=run.logger,
                                journal=journal, tag=(try_k, global_ii))
                _sync(run.dev)
            seconds = time.perf_counter() - t0
            if journal is not None:
                journal.save_chain(try_k, global_ii, res)
                journal.clear_partial()
        phi_carry = res.phi
        opt_carry = None if run.global_opt_reset else res.opt_state
        trial.append((res, seconds))
    return trial


def _items(run):
    """The dataset walk: ``(i, ref_img, ref_img_name, orig_name, gt)`` for
    every image this process owns (i % P == rank, the first ``stop_after``
    images only when that is set); with ``resume`` an image whose output
    exists is skipped."""
    n = len(run.dataset)
    if run.stop_after is not None and run.stop_after >= 0:
        n = min(n, run.stop_after)
    for i in MH.host_slice(n):
        ref_img, ref_img_name = run.dataset[i]
        gt = None
        if run.gt_flag:
            ref_img, gt_rgb, gt_depth = ref_img
            gt = (gt_rgb, gt_depth)
        orig_name = os.path.splitext(ref_img_name)[0]
        if run.resume and run.paths.get("rgb") and os.path.exists(
                pjoin(run.paths["rgb"], f"{orig_name}.png")):
            run.logger.log(f"skipping image {i}: {ref_img_name} (output exists)")
            continue
        yield i, ref_img, ref_img_name, orig_name, gt


@contextlib.contextmanager
def _saver(run, backlog):
    """``save(job)`` runs :func:`_finish_image` on ``job`` (its results
    already fetched to the host on the caller's thread): inline, or with
    ``perf.async_save`` in one worker thread, so the host work overlaps the
    next chain. Past ``backlog`` pending saves the caller waits for them, so
    a worker's failure re-raises within a few images, and at the latest when
    the block ends."""
    if not run.async_save:
        yield lambda job: _finish_image(*job)
        return
    pending = []

    def await_saves():
        for f in pending:
            f.result()  # re-raises the worker's exception
        pending.clear()

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        def save(job):
            if len(pending) >= backlog:
                await_saves()
            pending.append(pool.submit(_finish_image, *job))

        yield save
        await_saves()


def _run_serial(run, save):
    """One image at a time (osmosis_sampling.py:107-409)."""
    logger = run.logger
    for i, ref_img, ref_img_name, orig_name, gt in _items(run):
        start_time = datetime.datetime.now()
        logger.log(f"\nInference image {i}: {ref_img_name}\n")
        journal, saved = _open_journal(run, orig_name, "chain", run.chain_fp)
        ref_np = ref_img[None]  # [1, H, W, 3]
        y = _measurement(run, ref_np, i)

        best_trial, best_fl = None, None
        for try_k in range(run.best_of):
            seed, x_start, phi = _trial_start(run, try_k)
            trial = _run_trial(run, seed, x_start, y, phi, journal, saved, try_k)
            fl = float(trial[-1][0].sep_loss[-1].mean())
            if run.best_of > 1:
                logger.log(f"restart {try_k}: final loss {fl:.4f}")
            if _better_loss(fl, best_fl):
                best_trial, best_fl = trial, fl
            if run.accept_loss is not None and best_fl <= float(run.accept_loss):
                break
        if run.best_of > 1:
            logger.log(f"kept restart with final loss {best_fl:.4f}")

        for global_ii, (res, seconds) in enumerate(best_trial):
            save((run, _to_numpy(res), seconds, ref_np[0], ref_img_name, orig_name, global_ii,
                  gt, start_time))
        if journal is not None:
            journal.clear()


def _finish_image(run, res, sample_seconds, ref_img, ref_img_name, orig_name, global_ii, gt,
                  start_time, batch=1):
    """Save one chain's outputs (``res`` in numpy, batch 1) and log its row;
    ``batch`` is the size of the batched chain it came from, whose time
    ``sample_seconds`` is."""
    logger, paths = run.logger, run.paths
    with prof.phase("postprocess+save"):
        if run.rgb_guidance:
            _save_rgb_guidance_outputs(run.args, paths, orig_name, ref_img, res.sample[0], logger)
        else:
            _save_osmosis_outputs(run.args, paths, orig_name, global_ii, ref_img, res,
                                  run.operator, run.measure_config, logger, gt=gt)
        if run.record_every is not None and paths["grids"] is not None:
            _save_process_grid(res.snapshots, pjoin(paths["grids"], f"{orig_name}_process.png"))
    if not run.rgb_guidance:
        _log_trace_summary(logger, res)
    dt = datetime.datetime.now() - start_time
    logger.log(f"Run time: {dt}")
    logger.logkv("image", ref_img_name)
    logger.logkv("global_iter", global_ii)
    logger.logkv("batch", batch)
    logger.logkv("seconds", dt.total_seconds())
    logger.logkv("sample_seconds", sample_seconds)
    _log_result_kvs(logger, res)


def _log_result_kvs(logger, res):
    logger.logkv("final_loss", float(res.sep_loss[-1].mean()))
    logger.logkv("chain_finite", bool(np.isfinite(res.pred_xstart).all()))
    for pname, pval in res.phi.items():
        for ci, v in enumerate(pval[0].tolist()):
            logger.logkv(f"{pname}_{ci}", round(float(v), 6))
    logger.dumpkvs()


def _run_fleet(run, fleet_size, save):
    """Chunks of ``fleet_size`` images through one batched chain each
    (osmosis_tpu/pipelines/restore.py:917-1130): each image keeps its
    batch-1 measurement noise, x_start, chain noise, phi and losses, so lane
    j reproduces image j's serial chain; GT grids, resume and global_N warm
    starts as on the serial path. The tail chunk runs at its own batch. With
    best_of every trial reruns the whole chunk and each lane keeps its best;
    restarts stop once every lane is at or under accept_loss. With
    chain_checkpoint the chunk is the durable unit: its journal's
    fingerprint names the chunk's images."""
    logger = run.logger
    items = list(_items(run))
    for c0 in range(0, len(items), fleet_size):
        chunk = items[c0:c0 + fleet_size]
        n = len(chunk)
        if n < fleet_size:
            logger.log(f"tail chunk of {n} images: runs at batch {n}")
        comp = ",".join(f"{idx}:{name}" for idx, _, name, _, _ in chunk)
        journal, saved = _open_journal(
            run, f"chunk_{chunk[0][0]:05d}", "fleet chain",
            run.chain_fp + "-" + hashlib.sha256(comp.encode()).hexdigest()[:8])
        start_time = datetime.datetime.now()
        ys = torch.cat([_measurement(run, im[None], idx) for idx, im, _, _, _ in chunk])

        best_fl = np.full((n,), np.inf)
        best_res = [None] * n  # per lane: its best trial's [(res_j, seconds)] over global_ii
        for try_k in range(run.best_of):
            seed, x_one, phi = _trial_start(run, try_k)
            xs = x_one.expand((n,) + tuple(x_one.shape[1:])).contiguous()
            phis = None if phi is run.phi_cold else {
                k: v.expand((n,) + tuple(v.shape[1:])).contiguous() for k, v in phi.items()}
            trial = _run_trial(run, seed, xs, ys, phis, journal, saved, try_k,
                               what="fleet chain")
            fls = trial[-1][0].sep_loss[-1].double().cpu().numpy()
            if run.best_of > 1:
                logger.log(f"restart {try_k}: final losses {np.round(fls, 4).tolist()}")
            for j in range(n):
                if best_res[j] is None or _better_loss(fls[j], best_fl[j]):
                    best_fl[j] = fls[j]
                    best_res[j] = [(lane(res, j), s) for res, s in trial]
            if run.accept_loss is not None and (best_fl <= float(run.accept_loss)).all():
                break
        if run.best_of > 1:
            logger.log(f"kept restarts with final losses {np.round(best_fl, 4).tolist()}")

        for global_ii in range(run.global_N):
            for j, (_, ref_img, name, orig_name, gt) in enumerate(chunk):
                res_j, seconds = best_res[j][global_ii]
                save((run, _to_numpy(res_j), seconds, ref_img, name, orig_name, global_ii, gt,
                      start_time, n))
        if journal is not None:
            journal.clear()
        logger.log(f"fleet chunk {c0 // fleet_size}: {n} images in "
                   f"{datetime.datetime.now() - start_time}")


def _save_osmosis_outputs(args, paths, orig_name, global_ii, ref_img, res, operator,
                          measure_config, logger, gt=None):
    """osmosis_sampling.py:204-358: split rgb/depth, physical recomposition,
    phi logging, singles and grid saving. ``res`` holds numpy arrays."""
    x0 = res.pred_xstart[0]  # [H, W, 4]
    if not np.isfinite(x0).all():
        logger.log(
            "WARNING: non-finite outputs — the chain diverged. This is "
            "expected when sampling with randomly initialized weights "
            "(no checkpoint at unet_model.model_path)."
        )
    sample_rgb = x0[..., 0:3]
    sample_depth = x0[..., 3]

    ref01 = P.to_01(ref_img)
    rgb01 = P.to_01(sample_rgb)
    rgb01_clip = P.clip01(rgb01)
    depth_mm = P.min_max_norm_range(sample_depth)
    depth_pmm = P.min_max_norm_range_percentile(sample_depth, percent_low=0.03, percent_high=0.99)
    depth_color = P.depth_to_color(depth_pmm)

    op_cfg = measure_config["operator"]
    depth_calc = convert_depth(torch.from_numpy(sample_depth[..., None]),
                               operator.depth_type, operator.depth_value).numpy()
    phi = {k: v[0] for k, v in res.phi.items()}  # [C]
    phi_inf = phi["phi_inf"].reshape(1, 1, -1)
    final_loss = res.sep_loss[-1]

    if "underwater_physical_revised" in operator.name:
        phi_a = phi["phi_a"].reshape(1, 1, -1)
        phi_b = phi["phi_b"].reshape(1, 1, -1)
        backscatter = phi_inf * (1 - np.exp(-phi_b * depth_calc))
        attenuation = np.exp(-phi_a * depth_calc)
        degraded = 2 * (rgb01 * attenuation + backscatter) - 1
        norm_loss = np.round([np.linalg.norm(degraded - ref_img)], decimals=3)
        logger.log(
            f"\nInitialized values: "
            f"\nphi_a: [{op_cfg['phi_a']}], lr: {op_cfg['phi_a_eta']}"
            f"\nphi_b: [{op_cfg['phi_b']}], lr: {op_cfg['phi_b_eta']}"
            f"\nphi_inf: [{op_cfg['phi_inf']}], lr: {op_cfg['phi_inf_eta']}"
            f"\n\nResults values: "
            f"\nphi_a: {np.round(phi['phi_a'], 3).tolist()}"
            f"\nphi_b: {np.round(phi['phi_b'], 3).tolist()}"
            f"\nphi_inf: {np.round(phi['phi_inf'], 3).tolist()}"
            f"\n\nNorm loss: {norm_loss}"
            f"\nFinal loss: {np.round(final_loss, 3)}"
        )
    elif ("haze" in operator.name) or ("underwater_physical" in operator.name):
        phi_ab = phi["phi_ab"].reshape(1, 1, -1)
        backscatter = phi_inf * (1 - np.exp(-phi_ab * depth_calc))
        attenuation = np.exp(-phi_ab * depth_calc)
        degraded = 2 * (rgb01 * attenuation + backscatter) - 1
        norm_loss = np.round([np.linalg.norm(degraded - ref_img)], decimals=3)
        logger.log(
            f"\nInitialized values: "
            f"\nphi_ab: [{op_cfg['phi_ab']}], lr: {op_cfg['phi_ab_eta']}"
            f"\nphi_inf: [{op_cfg['phi_inf']}], lr: {op_cfg['phi_inf_eta']}"
            f"\n\nResults values: "
            f"\nphi_ab: {np.round(phi['phi_ab'], 3)}"
            f"\nphi_inf: {np.round(phi['phi_inf'], 3)}"
            f"\n\nNorm loss: {norm_loss}"
            f"\nFinal loss: {np.round(final_loss, 5)}"
        )
    else:
        raise NotImplementedError("Operator can be for 'underwater' or 'haze'")

    if args.save_singles:
        P.save_png(ref01, pjoin(paths["input"], f"{orig_name}.png"))
        P.save_png(rgb01_clip, pjoin(paths["rgb"], f"{orig_name}.png"))
        P.save_png(depth_color, pjoin(paths["depth_color"], f"{orig_name}.png"))
        P.save_png(depth_mm, pjoin(paths["depth_raw"], f"{orig_name}.png"))

    if args.save_grids:
        grid_list = [ref01, rgb01_clip, depth_color]
        if gt is not None:
            gt_rgb, gt_depth = gt
            grid_list += [
                np.zeros_like(rgb01),
                P.to_01(gt_rgb),
                P.depth_to_color(P.to_01(gt_depth)[..., 0]),
            ]
        grid = P.make_grid(grid_list, nrow=3, pad_value=1.0)
        P.save_png(grid, pjoin(paths["grids"], f"{orig_name}_g{global_ii}_grid.png"))

    if args.save_singles or args.save_grids:
        logger.log(f"result images was saved into: {paths['out']}")


def _save_rgb_guidance_outputs(args, paths, orig_name, ref_img, sample, logger):
    """osmosis_sampling.py:361-406: the rgb-guidance outputs, from the final
    SAMPLE [H, W, 4] (not x0-hat)."""
    ref01 = P.to_01(ref_img)
    rgb01_clip = P.clip01(P.to_01(sample[..., 0:3]))
    depth_mm = P.min_max_norm_range(sample[..., 3])
    depth_pmm = P.min_max_norm_range_percentile(sample[..., 3], percent_low=0.05,
                                                percent_high=0.99)
    depth_color = P.depth_to_color(depth_pmm)
    if args.save_singles:
        P.save_png(ref01, pjoin(paths["input"], f"{orig_name}.png"))
        P.save_png(rgb01_clip, pjoin(paths["rgb"], f"{orig_name}.png"))
        P.save_png(depth_color, pjoin(paths["depth_color"], f"{orig_name}.png"))
        P.save_png(depth_mm, pjoin(paths["depth_raw"], f"{orig_name}.png"))
    if args.save_grids:
        grid = P.make_grid([ref01, rgb01_clip, depth_color], nrow=3, pad_value=1.0)
        P.save_png(grid, pjoin(paths["grids"], f"{orig_name}.png"))
    if args.save_singles or args.save_grids:
        logger.log(f"result images was saved into: {paths['out']}")
