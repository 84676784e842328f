"""Unconditional RGBD prior sampling (port of ``osmosis_tpu/pipelines/prior.py``;
the reference RGBD_prior_sampling.py:22-126).

The minimal prior sampler of the reference (osmosis_utils/diffusion.py) is
:func:`osmosis_tpu_torch.diffusion.sampler.sample_loop` with
``model_var_type='fixed_small'``, the model fed 1-indexed timesteps (a +1
offset), over the LAST ``timestep_respacing`` steps of the unrespaced
schedule. The UNet runs under ``torch.no_grad``: forwards only. In a
multi-process run sample index i goes to rank i % P, into one run dir.
"""

from __future__ import annotations

import datetime
import os
import time
from os.path import join as pjoin
from typing import Optional

import numpy as np
import torch

from .. import config as C
from .. import perf as PF
from ..data import postprocess as P
from ..diffusion.sampler import SamplerConfig, sample_loop
from ..diffusion.schedules import make_schedule
from ..models.convert import load_unet
from ..models.unet import unet_config_from_yaml
from ..parallel import multihost as MH
from ..utils import native
from ..utils.rundir import make_output_dirs
from .restore import (allocate_run_dir, configure_logger, finish_multihost, precision_str,
                      resolve_device, torso_dtype)


def run_prior_sampling(config_file: str, device="cuda:0",
                       save_dir_override: Optional[str] = None,
                       dtype: torch.dtype = torch.float32) -> str:
    """Sample ``number_of_images`` RGBD images from the prior; returns the run
    dir ``<save_dir>/RGBD_prior/<d-m-yy>/runN``.

    Runs on ``device`` (CUDA unless the caller passes ``"cpu"``), the torso in
    ``dtype`` or in bfloat16 where the config sets ``use_fp16``. Image i's
    x_init and chain noise come from a ``torch.Generator`` on the device seeded
    from ``manual_seed`` and i, so their bits differ from the JAX package's.
    """
    dev = resolve_device(device)
    args = C.arguments_from_file(config_file)
    perf = PF.configure_from_dict(getattr(args, "perf", None))
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    image_size = args.unet_model["image_size"]

    out_path = allocate_run_dir(
        os.path.abspath(pjoin(save_dir_override or args.save_dir, "RGBD_prior")), config_file,
        perf, barrier="prior_rundir")
    paths = make_output_dirs(out_path, args.save_singles, args.save_grids,
                             singles_subdirs=("rgb", "depth_color"))
    logger = configure_logger(out_path, dev)
    logger.log(f"pretrained model file: {args.unet_model['model_path']}")

    dtype = torso_dtype(args, dtype)
    ucfg = unet_config_from_yaml(args.unet_model)
    model = load_unet(args.unet_model.get("model_path", ""), ucfg, dev, dtype=dtype)
    logger.log(f"Device: {precision_str(dev, dtype)}\nHost ops: {native.status()}")

    T = args.diffusion["steps"]
    num_steps = int(args.diffusion.get("timestep_respacing", T) or T)
    # the last `num_steps` steps of the unrespaced schedule, the model fed
    # 1-indexed timesteps (osmosis_utils/diffusion.py:74-96)
    schedule = make_schedule(noise_schedule=args.diffusion["noise_schedule"], steps=T)
    scfg = SamplerConfig(sampler="ddpm", model_var_type="fixed_small")
    record_steps = None
    if args.record_process:
        # the reference records where the 1-indexed t % record_every == 0, and t == 1
        rec = [t for t in range(T) if (t + 1) % args.record_every == 0] + [0]
        record_steps = tuple(sorted(set(rec), reverse=True))

    for im_idx in MH.host_slice(args.number_of_images):
        start_time = datetime.datetime.now()
        logger.log(f"\nInference image {im_idx}/{args.number_of_images}\n")
        gen = torch.Generator(device=dev).manual_seed(args.manual_seed * 1_000_003 + im_idx)
        x_init = torch.randn((1, image_size, image_size, 4), generator=gen, device=dev)
        t0 = time.perf_counter()
        x, snaps = sample_loop(model, schedule, x_init, scfg, timestep_offset=1.0, start_t=T,
                               num_steps=num_steps, record_steps=record_steps, generator=gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sample_seconds = time.perf_counter() - t0
        x = x[0].float().cpu().numpy()
        x_rgb = P.clip01(0.5 * (1 + x[..., 0:3]))
        x_d_color = P.depth_to_color(
            P.min_max_norm_range_percentile(x[..., 3], percent_low=0.05, percent_high=0.99))
        if snaps is not None:
            snaps = {"steps": snaps["steps"], "x_t": snaps["x_t"].float().cpu().numpy(),
                     "x0_hat": snaps["x0_hat"].float().cpu().numpy()}
            # the final recorded x0-hat (diffusion.py:130 returns the last recording)
            x0_rgb, x0_d = _rgb_and_depth_color(snaps["x0_hat"][-1, 0])
        else:
            x0_rgb, x0_d = x_rgb, x_d_color

        if args.save_singles:
            P.save_png(x0_rgb, pjoin(paths["rgb"], f"image_{im_idx}.png"))
            P.save_png(x0_d, pjoin(paths["depth_color"], f"image_{im_idx}.png"))
        if args.save_grids:
            grid = P.make_grid([x_rgb, x_d_color], nrow=2, pad_value=1.0)
            P.save_png(grid, pjoin(paths["grids"], f"image_{im_idx}.png"))
            if snaps is not None:
                _save_prior_process_grid(snaps,
                                         pjoin(paths["grids"], f"image_{im_idx}_process.png"))
        dt = datetime.datetime.now() - start_time
        logger.log(f"Run time: {dt}")
        logger.logkv("image", im_idx)
        logger.logkv("seconds", dt.total_seconds())
        logger.logkv("sample_seconds", sample_seconds)
        logger.logkv("sample_finite", bool(np.isfinite(x).all()))
        logger.dumpkvs()
    finish_multihost(logger, "prior_done")
    logger.close()
    return out_path


def _rgb_and_depth_color(x0: np.ndarray):
    """An [H, W, 4] x0-hat in [-1, 1] -> (rgb in [0, 1], colored depth)."""
    rgb = P.clip01(P.to_01(x0[..., 0:3]))
    depth = P.depth_to_color(P.min_max_norm_range_percentile(
        P.to_01(x0[..., 3]), percent_low=0.05, percent_high=0.99))
    return rgb, depth


def _save_prior_process_grid(snaps, path):
    """x_t row + x0-rgb row + depth row (diffusion.py:98-128)."""
    xt_row = [P.clip01(P.to_01(x[..., 0:3])) for x in snaps["x_t"][:, 0]]
    pairs = [_rgb_and_depth_color(x) for x in snaps["x0_hat"][:, 0]]
    grid = P.make_grid(xt_row + [p[0] for p in pairs] + [p[1] for p in pairs],
                       nrow=len(xt_row), pad_value=1.0)
    P.save_png(grid, path)
