"""Guided restoration pipeline (port of ``osmosis_tpu/pipelines/restore.py``,
the reference osmosis_sampling.py:33-409), serial batch-1 path.

Per image: preprocess on the host, run the guided chain on the device
(:func:`osmosis_tpu_torch.diffusion.guided.guided_sample_loop`), then
post-process on the host (physical recomposition, depth colormaps, grids)
into the reference's run-dir layout. ``use_fp16: True`` runs the UNet torso
in bfloat16; ``rgb_guidance: True`` runs vanilla DPS ('ps') and saves the
final sample's RGB and depth.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from functools import partial
from os.path import join as pjoin
from typing import Optional

import numpy as np
import torch

from .. import config as C
from ..data import datasets as D
from ..data import postprocess as P
from ..data import transforms as TR
from ..diffusion.guided import GuidanceConfig, GuidedResult, guided_sample_loop
from ..diffusion.sampler import SamplerConfig
from ..diffusion.schedules import make_schedule
from ..guidance.noise import get_noiser
from ..guidance.operators import convert_depth, get_operator
from ..guidance.phi_optim import make_phi_optimizer
from ..models.convert import load_unet
from ..models.unet import unet_config_from_yaml
from ..utils.logging import RunLogger
from ..utils.rundir import make_output_dirs, update_save_dir_date

_RESTORE_ITEM = "ROADMAP.md queue 1, item 2 (restore extensions)"


def resolve_device(device) -> torch.device:
    """The torch device for an entry point; CUDA without a card raises, so a
    run never falls back to the CPU unless it was asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' (--cpu on the CLI) to run on the CPU")
    return dev


def _check_slice(args) -> None:
    """Raise on configuration this port does not run yet."""
    data = args.data
    unsupported = [
        (int(data.get("batch_size", 1) or 1) > 1, "batch_size > 1 (the fleet path)", _RESTORE_ITEM),
        (int(getattr(args, "progress_segments", 0) or 0) > 1, "progress_segments", _RESTORE_ITEM),
        (bool(getattr(args, "chain_checkpoint", False)), "chain_checkpoint", _RESTORE_ITEM),
        (int(getattr(args, "best_of", 1) or 1) > 1, "best_of > 1", _RESTORE_ITEM),
        (args.sample_pattern.get("global_eta_scale") not in (None, 1.0), "global_eta_scale",
         _RESTORE_ITEM),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet: {item}")


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


def _to_numpy(res: GuidedResult) -> GuidedResult:
    """A copy of ``res`` with every tensor moved to the host as numpy."""
    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v

    return dataclasses.replace(res, **{f.name: conv(getattr(res, f.name))
                                       for f in dataclasses.fields(res)})


def _log_trace_summary(logger, res, max_rows=10):
    """The reference's tqdm postfix (gaussian_diffusion.py:276-296: loss, aux
    and live phi) rebuilt from the chain's traces after it ends."""
    sep = res.sep_loss  # [T, B]
    T = sep.shape[0]
    if T == 0:
        return
    idx = np.unique(np.linspace(0, T - 1, max_rows).round().astype(int))
    lines = ["chain telemetry (step runs t=T-1..0):"]
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
                    save_dir_override: Optional[str] = None) -> str:
    """Run guided restoration over the configured dataset; returns the run dir.

    Runs on ``device`` (CUDA unless the caller passes ``"cpu"``). The UNet
    torso runs in bfloat16 where the config sets ``use_fp16``, else in fp32,
    which on CUDA runs with TF32 off for cuDNN's convolutions and for
    matmuls.
    ``x_start`` and every chain noise draw come from a ``torch.Generator`` on
    the device, seeded with ``manual_seed`` at each global iteration, so their
    bits differ from the JAX package's ``jax.random`` streams.
    """
    dev = resolve_device(device)
    args = C.arguments_from_file(config_file)
    _check_slice(args)
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

    dtype = torso_dtype(args)
    ucfg = unet_config_from_yaml(args.unet_model)
    model = load_unet(args.unet_model.get("model_path", ""), ucfg, dev, dtype=dtype)
    rgb_guidance = bool(getattr(args, "rgb_guidance", False))

    measure_config = args.measurement
    sample_pattern = args.sample_pattern
    resume = bool(getattr(args, "resume", False))
    operator_name = measure_config["operator"]["name"]
    base = save_dir_override or args.save_dir
    out_path = update_save_dir_date(
        os.path.abspath(pjoin(base, operator_name, data_config["name"])), resume=resume)
    C.config_snapshot(config_file, pjoin(out_path, "configurations.txt"))
    paths = make_output_dirs(out_path, args.save_singles, args.save_grids)
    logger = RunLogger(out_path)
    logger.log(f"pretrained model file: {args.unet_model['model_path']}")
    if not rgb_guidance:
        _log_run_header(logger, args, dev, dtype)

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
    noiser = get_noiser(**measure_config["noise"])
    gcfg = GuidanceConfig.from_config(
        "ps" if rgb_guidance else args.conditioning["method"], args.conditioning["params"],
        sample_pattern, args.aux_loss, noiser_name=measure_config["noise"]["name"],
    )
    record_every = args.record_every if args.record_process else None

    phi_cold = {k: torch.as_tensor(v, device=dev) for k, v in operator.phi_init().items()}
    opt_cold = make_phi_optimizer(operator.optimizer, operator.etas()).init(phi_cold)
    if sample_pattern["pattern"] == "pcgs":
        global_N = sample_pattern.get("global_N", 1)
    elif sample_pattern["pattern"] == "original":
        global_N = 1
    else:
        raise ValueError(f"Unrecognized sample pattern: {sample_pattern['pattern']}")
    global_opt_reset = bool(sample_pattern.get("global_opt_reset", False))
    stop_after = data_config.get("stop_after", -1)

    for i, (ref_img, ref_img_name) in enumerate(dataset):
        if i == stop_after:
            break
        if gt_flag:
            ref_img, gt_rgb, gt_depth = ref_img
        start_time = datetime.datetime.now()
        orig_name = os.path.splitext(ref_img_name)[0]
        if resume and paths.get("rgb") and os.path.exists(pjoin(paths["rgb"], f"{orig_name}.png")):
            logger.log(f"skipping image {i}: {ref_img_name} (output exists)")
            continue
        logger.log(f"\nInference image {i}: {ref_img_name}\n")

        ref_np = ref_img[None]  # [1, H, W, 3]
        noise_gen = torch.Generator(device=dev).manual_seed(
            (args.manual_seed + 1) * 1_000_003 + i)
        y = noiser(torch.from_numpy(ref_np).to(dev), generator=noise_gen)
        if getattr(args, "degamma_input", False):
            y = TR.degamma(y)

        # phi and its optimizer state reset per image and carry across global
        # iterations (osmosis_sampling.py:146-163 vs :191)
        phi_carry, opt_carry = phi_cold, opt_cold
        chains = []
        for global_ii in range(global_N):
            logger.log(f"global iteration: {global_ii}\n")
            gen = torch.Generator(device=dev).manual_seed(args.manual_seed)
            x_start = torch.randn((1, image_size, image_size, 4), generator=gen, device=dev)
            t0 = time.perf_counter()
            res = guided_sample_loop(
                model, schedule, x_start, y, operator, gcfg, scfg,
                sample_pattern=sample_pattern, record_every=record_every,
                phi_init=phi_carry, opt_state_init=opt_carry, generator=gen,
            )
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            sample_seconds = time.perf_counter() - t0
            phi_carry = res.phi
            opt_carry = opt_cold if global_opt_reset else res.opt_state
            chains.append((res, sample_seconds))

        gt = (gt_rgb, gt_depth) if gt_flag else None
        for global_ii, (res, sample_seconds) in enumerate(chains):
            res = _to_numpy(res)
            if rgb_guidance:
                _save_rgb_guidance_outputs(args, paths, orig_name, ref_np[0], res.sample[0],
                                           logger)
            else:
                _save_osmosis_outputs(args, paths, orig_name, global_ii, ref_np[0], res,
                                      operator, measure_config, logger, gt=gt)
            if record_every is not None and paths["grids"] is not None:
                _save_process_grid(res.snapshots,
                                   pjoin(paths["grids"], f"{orig_name}_process.png"))
            if not rgb_guidance:
                _log_trace_summary(logger, res)
            dt = datetime.datetime.now() - start_time
            logger.log(f"Run time: {dt}")
            logger.logkv("image", ref_img_name)
            logger.logkv("global_iter", global_ii)
            logger.logkv("seconds", dt.total_seconds())
            logger.logkv("sample_seconds", sample_seconds)
            logger.logkv("final_loss", float(res.sep_loss[-1].mean()))
            logger.logkv("chain_finite", bool(np.isfinite(res.pred_xstart).all()))
            for pname, pval in res.phi.items():
                for ci, v in enumerate(pval[0].tolist()):
                    logger.logkv(f"{pname}_{ci}", round(float(v), 6))
            logger.dumpkvs()

    logger.close()
    return out_path


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
