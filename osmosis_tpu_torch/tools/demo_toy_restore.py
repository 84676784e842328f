"""Product-path quality demo with a learned toy prior (the port of the JAX
package's ``tools/demo_toy_restore.py``).

    python -m osmosis_tpu_torch.tools.train_toy_prior --size 64 --channels 96 \\
        --out checkpoints/toy_prior64.msgpack
    python -m osmosis_tpu_torch.tools.demo_toy_restore \\
        --checkpoint checkpoints/toy_prior64.msgpack [-d <cuda idx> | --cpu]

``validate_toy_e2e`` measures restoration through the library; this demo
runs the shipped pipeline end to end. It draws held-out toy scenes,
degrades them with known parameters through ``simulate_degraded`` into the
simulation preset's PNG layout (input, gt_rgb, uint16 gt_depth), writes a
config on the public YAML surface (a ``.msgpack`` checkpoint, the adam phi
optimizer, fixed_small variance for the untrained variance head), runs
``pipelines.restore.run_restoration`` (what ``python -m
osmosis_tpu_torch.sample`` calls) and scores the run dir with
``evaluate``'s PSNR and SSIM and the depth correlation of the recovered
depth. ``--operator`` picks the guidance surface: the three physical models,
or ``rgb_guidance`` (the 'ps' path, guided by the clean RGB, depth from the
prior). Without a card and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
from PIL import Image

from ..data.datasets import natsorted
from ..pipelines.restore import resolve_device, run_restoration
from .evaluate import evaluate_dirs
from .simulate_degraded import DEFAULT_PHI, simulate_dataset, synth_scenes

# the inits per operator, offset from DEFAULT_PHI's true values by the
# margins of the revised-underwater toy protocol
OP_SETUPS = {
    "underwater_physical_revised": dict(
        init={"phi_a": "0.7,0.6,0.5", "phi_b": "0.6,0.5,0.45", "phi_inf": "0.14,0.29,0.49"}),
    "underwater_physical": dict(init={"phi_ab": "0.65,0.55,0.5", "phi_inf": "0.14,0.29,0.49"}),
    "haze_physical": dict(init={"phi_ab": "1.0", "phi_inf": "0.5,0.55,0.6"}),
}


def depth_corr_dirs(depth_dir: str, gt_depth_dir: str, size: int):
    """Mean Pearson correlation between the run dir's depth_raw PNGs and the
    GT depth PNGs (min-max normalization is monotonic, so the correlation's
    sign and size mean something); returns (mean, positives, per image)."""
    names = natsorted(os.listdir(depth_dir))
    gts = natsorted(os.listdir(gt_depth_dir))
    corrs = []
    for n, g in zip(names, gts):
        with Image.open(os.path.join(depth_dir, n)) as im:
            d = np.asarray(im, np.float32)
        if d.ndim == 3:
            d = d[..., 0]
        with Image.open(os.path.join(gt_depth_dir, g)) as im:
            t = np.asarray(im.resize((size, size)), np.float32)
        if t.ndim == 3:
            t = t[..., 0]
        corrs.append(float(np.corrcoef(d.ravel(), t.ravel())[0, 1]))
    return float(np.mean(corrs)), sum(1 for c in corrs if c > 0), corrs


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default="checkpoints/toy_prior64.msgpack")
    ap.add_argument("--operator", default="underwater_physical_revised",
                    choices=sorted(OP_SETUPS) + ["rgb_guidance"])
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--channels", type=int, default=96)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "osmosis_toy_demo"))
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--scale", default=None,
                    help="guidance scale override (default 4,4,4,2 physics / 3,3,3,0.1 "
                         "rgb_guidance)")
    ap.add_argument("--global-N", type=int, default=1,
                    help="full-chain restarts with phi warm-start")
    ap.add_argument("--global-opt-reset", action="store_true",
                    help="reset the phi optimizer's moments between global chains")
    ap.add_argument("--phi-eta", type=float, default=1e-3,
                    help="phi optimizer learning rate (halve per size doubling from the 64px "
                         "value 1e-3)")
    ap.add_argument("--global-eta-scale", type=float, default=1.0,
                    help="geometric phi-eta decay across global chains: chain ii runs with "
                         "etas * scale**ii")
    ap.add_argument("--phi-warmup", type=int, default=0,
                    help="phi_warmup_iters: extra phi-only iterations at the unfreeze boundary")
    ap.add_argument("--best-of", type=int, default=1, help="loss-selected noise-seed restarts")
    ap.add_argument("--phi-jitter", type=float, default=0.0,
                    help="phi-init jitter sigma for restart trials > 0")
    ap.add_argument("--accept-loss", type=float, default=None,
                    help="stop restarting once a trial's final loss is <= X")
    ap.add_argument("--x0-grad", action="store_true",
                    help="gradient_x_prev=False: the guidance gradient w.r.t. x0-hat, no UNet "
                         "backward; needs a smaller scale")
    ap.add_argument("--x-prev-every", type=int, default=1,
                    help="hybrid gradient schedule: the x_prev gradient every k-th chain step, "
                         "the x0 gradient between")
    ap.add_argument("--oracle-phi", action="store_true",
                    help="init phi at the TRUE water parameters and freeze it (the oracle "
                         "ceiling)")
    ap.add_argument("--oracle-learn", action="store_true",
                    help="with --oracle-phi: keep the learn flags on (descent from the true "
                         "phi)")
    ap.add_argument("--arch", default="toy", choices=["toy", "production"],
                    help="must match the checkpoint's train_toy_prior --arch")
    ap.add_argument("--respacing", default="200",
                    help="timestep_respacing of the run (the JAX tool's fixed 200)")
    ap.add_argument("-d", "--device", type=int, default=0, help="CUDA device index")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def _write_rgb_guidance_set(wd: str, scenes) -> None:
    """The guidance measurement is the clean RGB; depth comes from the prior."""
    for sub in ("input", "gt_rgb", "gt_depth"):
        os.makedirs(os.path.join(wd, sub), exist_ok=True)
    for name, rgbd in scenes:
        rgb01 = np.clip(0.5 * (rgbd[0, ..., :3] + 1.0), 0, 1)
        depth01 = np.clip(0.5 * (rgbd[0, ..., 3] + 1.0), 0, 1)
        img = Image.fromarray((rgb01 * 255).round().astype(np.uint8))
        img.save(os.path.join(wd, "input", f"{name}.png"))
        img.save(os.path.join(wd, "gt_rgb", f"{name}.png"))
        Image.fromarray((depth01 * 65535).round().astype(np.uint16)).save(
            os.path.join(wd, "gt_depth", f"{name}.png"))


def demo_config(args) -> dict:
    """The run's config on the public YAML surface."""
    wd = args.workdir
    rgb_guidance = args.operator == "rgb_guidance"
    if rgb_guidance:
        measurement = dict(operator=dict(name="rgb_guidance"),
                           noise=dict(name="gaussian", sigma=0))
        conditioning = dict(method="ps", params=dict(
            loss_function="norm", loss_weight="depth", weight_function="gamma,1.4,1.4,1",
            scale=args.scale or "3,3,3,0.1", gradient_x_prev=True, gradient_clip="True,0.01"))
    else:
        if args.oracle_phi:
            init, learn = dict(DEFAULT_PHI[args.operator]), bool(args.oracle_learn)
        else:
            init, learn = OP_SETUPS[args.operator]["init"], True
        op_cfg = dict(name=args.operator, optimizer="adam", depth_type="gamma",
                      value="1.4,1.4,1")
        for pname, pinit in init.items():
            op_cfg[pname] = pinit
            op_cfg[f"{pname}_eta"] = args.phi_eta
            op_cfg[f"{pname}_learn_flag"] = learn
        measurement = dict(operator=op_cfg, noise=dict(name="clean"))
        # the x0 gradient is unclipped and stronger per unit scale: half the
        # x_prev scale, the RGB:depth ratio kept
        conditioning = dict(method="osmosis", params=dict(
            loss_function="norm", loss_weight="depth", weight_function="gamma,1.4,1.4,1",
            scale=args.scale or ("2,2,2,1" if args.x0_grad else "4,4,4,2"),
            gradient_x_prev=not args.x0_grad, gradient_clip="True,0.01",
            x_prev_every=args.x_prev_every))
    production = args.arch == "production"
    return dict(
        save_dir=os.path.join(wd, "results"), best_of=args.best_of,
        phi_jitter=args.phi_jitter, accept_loss=args.accept_loss, degamma_input=False,
        manual_seed=args.seed, rgb_guidance=rgb_guidance, save_singles=True, save_grids=True,
        record_process=False, record_every=200, change_input_output_channels=True,
        input_channels=4, output_channels=8,
        sample_pattern=dict(
            pattern="pcgs", update_start=0.7, update_end=0, global_N=args.global_N,
            global_opt_reset=bool(args.global_opt_reset),
            global_eta_scale=args.global_eta_scale, local_M=1, s_start=1, s_end=0, n_iter=10,
            start_guidance=1, stop_guidance=0, phi_warmup_iters=args.phi_warmup),
        unet_model=dict(
            image_size=args.size, num_channels=args.channels, num_res_blocks=2,
            channel_mult="1,1,2,2,4,4" if production else "1,2", learn_sigma=True,
            class_cond=False, use_checkpoint=False,
            # ds = image_size // res: the toy arch attends at size // 4, the
            # production arch at size // 8, // 16 and // 32
            attention_resolutions=(f"{args.size // 8},{args.size // 16},{args.size // 32}"
                                   if production else str(args.size // 4)),
            num_heads=4, num_head_channels=64 if production else 32, num_heads_upsample=-1,
            use_scale_shift_norm=True, dropout=0.0, resblock_updown=True, use_fp16=False,
            use_new_attention_order=False, model_path=args.checkpoint,
            pretrain_model="osmosis"),
        diffusion=dict(
            sampler="ddpm", steps=1000, noise_schedule="linear", model_mean_type="epsilon",
            model_var_type="fixed_small",  # the toy prior's variance head is untrained
            dynamic_threshold=False, clip_denoised=True, min_max_denoised=False,
            rescale_timesteps=False, timestep_respacing=args.respacing),
        conditioning=conditioning,
        aux_loss=dict(aux_loss=dict(avrg_loss=0.5, val_loss=20)),
        data=dict(batch_size=1, name="toy_demo", root=os.path.join(wd, "input"),
                  stop_after=-1, ground_truth=True, gt_rgb=os.path.join(wd, "gt_rgb"),
                  gt_depth=os.path.join(wd, "gt_depth")),
        measurement=measurement,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    import yaml

    device = resolve_device("cpu" if args.cpu else f"cuda:{args.device}")
    wd = args.workdir
    scenes = synth_scenes(args.scenes, args.size, args.seed)
    if args.operator == "rgb_guidance":
        _write_rgb_guidance_set(wd, scenes)
    else:
        simulate_dataset(wd, scenes, operator_name=args.operator, device=device)
    cfg_path = os.path.join(wd, "toy_demo_config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(demo_config(args), f)

    out = run_restoration(cfg_path, device=device)
    print(f"run dir: {out}", file=sys.stderr)
    scores = evaluate_dirs(os.path.join(out, "single_images", "rgb"),
                           os.path.join(wd, "gt_rgb"), resize_gt=args.size)
    corr, n_pos, _ = depth_corr_dirs(os.path.join(out, "single_images", "depth_raw"),
                                     os.path.join(wd, "gt_depth"), args.size)
    report = {
        "operator": args.operator, "scenes": args.scenes, "global_N": args.global_N,
        "psnr_restored": round(scores["psnr"], 2), "ssim_restored": round(scores["ssim"], 4),
        "depth_corr": round(corr, 3), "depth_corr_positive": f"{n_pos}/{args.scenes}",
        "run_dir": out,
    }
    if args.operator != "rgb_guidance":
        # with rgb_guidance the input is the GT, so a gain means nothing there
        degraded = evaluate_dirs(os.path.join(wd, "input"), os.path.join(wd, "gt_rgb"),
                                 resize_gt=args.size)
        report.update({
            "psnr_degraded": round(degraded["psnr"], 2),
            "psnr_gain_db": round(scores["psnr"] - degraded["psnr"], 2),
            "ssim_degraded": round(degraded["ssim"], 4),
        })
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
