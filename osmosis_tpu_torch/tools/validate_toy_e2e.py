"""Quantitative end-to-end validation of guided restoration with a learned
prior, the toy RGBD prior of ``train_toy_prior`` (the port of the JAX
package's ``tools/validate_toy_e2e.py``).

    python -m osmosis_tpu_torch.tools.validate_toy_e2e \\
        --checkpoint checkpoints/toy_prior.msgpack [--scenes 6 --seed 123 --respacing 200] \\
        [-d <cuda idx> | --cpu]

For each held-out scene of the training distribution (J_true, z_true):
degrade it through the revised underwater model with KNOWN phi
(I = J e^{-phi_a z} + phi_inf (1 - e^{-phi_b z})), run the guided sampling
loop (osmosis conditioning, pcgs masks, the phi optimizer inside the chain)
from pure noise on the device, and report PSNR(restored, J_true) against
PSNR(degraded, J_true), the depth correlation and the recovered-phi error.
PASS: the restoration beats the degraded input by more than 2 dB, depth
correlates on average, and at least 2/3 of the scenes correlate positively.
The recipe, the phi, the pattern and the pass rule are the JAX tool's.

Scene i comes from a CPU generator seeded by ``draw_seed(seed, i, 0)``
(``simulate_degraded.synth_scenes``); its sampling draws (x_init on the
device, the chain noise keyed on ``draw_seed(root, 2)``, the phi jitter) from
the root ``draw_seed(seed, i)``, or ``draw_seed(seed, i, 50000 +
sample_seed)`` with ``--sample-seed``. Their bits differ from the JAX tool's
``jax.random`` streams. Without a card and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..diffusion.guided import GuidanceConfig, draw_seed, guided_sample_loop
from ..diffusion.sampler import SamplerConfig
from ..diffusion.schedules import make_schedule
from ..guidance.operators import get_operator
from ..models.convert import unet_from_msgpack
from ..pipelines.restore import resolve_device
from .evaluate import psnr
from .train_toy_prior import synth_scene_batch, toy_unet_config

PHI_TRUE = {"phi_a": [0.55, 0.45, 0.35], "phi_b": [0.5, 0.4, 0.35],
            "phi_inf": [0.18, 0.32, 0.45]}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default="checkpoints/toy_prior.msgpack")
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--respacing", default="200")
    ap.add_argument("--n-iter", type=int, default=10)
    ap.add_argument("--update-start", type=float, default=0.7,
                    help="pcgs update_start: phi is frozen above update_start*T; 1.0 lets "
                         "phi descend from the first step")
    ap.add_argument("--scale", default="2,2,2,1",
                    help="guidance scale; norm-loss gradients shrink ~1/size per pixel, so "
                         "larger images need a larger scale (32px: 2,2,2,1; 64px: ~4,4,4,2)")
    ap.add_argument("--phi-eta", type=str, default="2e-4",
                    help="phi SGD lr (halve per 2x image size); a comma list gives "
                         "per-channel rates")
    ap.add_argument("--phi-warmup", type=int, default=0,
                    help="phi_warmup_iters: extra phi-only iterations at the unfreeze boundary")
    ap.add_argument("--best-of", type=int, default=1,
                    help="run K chains from different noise seeds and keep the one with the "
                         "lowest final measurement loss")
    ap.add_argument("--phi-jitter", type=float, default=0.0,
                    help="with --best-of: restarts > 0 also jitter the phi init by "
                         "N(0, sigma)")
    ap.add_argument("--only-scene", type=int, default=None,
                    help="run a single scene index")
    ap.add_argument("--accept-loss", type=float, default=None,
                    help="with --best-of: stop restarting once a trial's final loss is <= "
                         "this")
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "gd", "adam", "rmsprop"],
                    help="phi optimizer (the operator config surface)")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--sample-seed", type=int, default=None,
                    help="vary only the sampling randomness (chain init and chain noise), "
                         "keeping the held-out scenes and degradations identical")
    ap.add_argument("--row-name", default=None,
                    help="stamp a row identifier into the output JSON")
    ap.add_argument("--sampler", default="ddpm", choices=["ddpm", "ltsp"],
                    help="ltsp = Lie-Trotter splitting with a PLMS4 diffusion substep")
    ap.add_argument("--arch", default="toy", choices=["toy", "production"],
                    help="must match the checkpoint's train_toy_prior --arch")
    ap.add_argument("--x0-grad", action="store_true",
                    help="gradient_x_prev=False: the guidance gradient w.r.t. x0-hat, no "
                         "UNet backward, never clipped")
    ap.add_argument("--x-prev-every", type=int, default=1,
                    help="hybrid gradient schedule: the x_prev gradient every k-th chain "
                         "step, the x0 gradient between")
    ap.add_argument("--oracle-phi", action="store_true",
                    help="initialize phi at the TRUE water parameters and freeze it")
    ap.add_argument("--save-png", default=None,
                    help="save a GT / degraded / restored / depth strip here")
    ap.add_argument("-d", "--device", type=int, default=0, help="CUDA device index")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def _operator(args):
    """The revised underwater operator: phi from the offset init (or, with
    --oracle-phi, frozen at the truth), the depth mapping of the presets."""
    if args.oracle_phi:
        kw = dict(phi_a="0.55,0.45,0.35", phi_a_eta=0.0, phi_a_learn_flag=False,
                  phi_b="0.5,0.4,0.35", phi_b_eta=0.0, phi_b_learn_flag=False,
                  phi_inf="0.18,0.32,0.45", phi_inf_eta=0.0, phi_inf_learn_flag=False)
    else:
        kw = dict(phi_a="0.7,0.6,0.5", phi_a_eta=args.phi_eta, phi_a_learn_flag=True,
                  phi_b="0.6,0.5,0.45", phi_b_eta=args.phi_eta, phi_b_learn_flag=True,
                  phi_inf="0.14,0.29,0.49", phi_inf_eta=args.phi_eta, phi_inf_learn_flag=True)
    return get_operator("underwater_physical_revised", batch_size=1, optimizer=args.optimizer,
                        depth_type="gamma", value="1.4,1.4,1", **kw)


def validate(args):
    """Run the protocol of ``args`` (see :func:`build_parser`); returns the
    report (the JSON line the CLI prints) and its pass flag."""
    dev = resolve_device("cpu" if args.cpu else f"cuda:{args.device}")
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = toy_unet_config(args.size, args.channels, args.arch)
    model = unet_from_msgpack(args.checkpoint, cfg).requires_grad_(False).eval().to(
        device=dev, memory_format=torch.channels_last)
    phi_true = {k: torch.tensor([v], device=dev) for k, v in PHI_TRUE.items()}
    operator = _operator(args)
    schedule = make_schedule("linear", args.T, timestep_respacing=args.respacing)
    pattern = dict(pattern="pcgs", update_start=args.update_start, update_end=0, global_N=1,
                   local_M=1, s_start=1, s_end=0, n_iter=args.n_iter, start_guidance=1,
                   stop_guidance=0, phi_warmup_iters=args.phi_warmup)
    # the presets' guidance recipe: the depth-weighted loss and the aux
    # exposure losses
    gcfg = GuidanceConfig.from_config(
        "osmosis",
        dict(loss_function="norm", loss_weight="depth", weight_function="gamma,1.4,1.4,1",
             scale=args.scale, gradient_x_prev=not args.x0_grad, gradient_clip="True,0.01",
             x_prev_every=args.x_prev_every),
        pattern, {"aux_loss": {"avrg_loss": 0.5, "val_loss": 20.0}})
    scfg = SamplerConfig(sampler=args.sampler, model_var_type="fixed_small", clip_denoised=True)
    phi_cold = {k: torch.as_tensor(v, device=dev) for k, v in operator.phi_init().items()}

    rows, strips = [], []
    for i in range(args.scenes):
        if args.only_scene is not None and i != args.only_scene:
            continue
        scene = synth_scene_batch(torch.Generator().manual_seed(draw_seed(args.seed, i, 0)),
                                  1, args.size).to(dev)
        root = (draw_seed(args.seed, i) if args.sample_seed is None
                else draw_seed(args.seed, i, 50_000 + args.sample_seed))
        J_true01 = 0.5 * (scene[0, ..., :3].cpu().numpy() + 1.0)
        z_true = scene[0, ..., 3].cpu().numpy()
        with torch.no_grad():
            y01 = operator.forward(phi_true, scene)  # degraded, in [0, 1]
        y = 2.0 * y01 - 1.0
        best_loss, res, chosen = None, None, 0
        for k_try in range(max(args.best_of, 1)):
            k_base = draw_seed(root, 1000 * k_try) if k_try else root
            x_init = torch.randn(scene.shape, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(
                                     draw_seed(k_base, 1)))
            phi0 = phi_cold
            if k_try and args.phi_jitter > 0:
                phi0 = {k: v + args.phi_jitter * torch.randn(
                    v.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(draw_seed(k_base, 3, n)))
                        for n, (k, v) in enumerate(sorted(phi_cold.items()))}
            r = guided_sample_loop(model, schedule, x_init, y, operator, gcfg, scfg,
                                   sample_pattern=pattern, phi_init=phi0,
                                   seed=draw_seed(k_base, 2))
            fl = float(r.sep_loss[-1].mean())
            if args.best_of > 1:
                print(f"scene {i}: try {k_try} final loss {fl:.3f}", file=sys.stderr)
            if best_loss is None or fl < best_loss:
                best_loss, res, chosen = fl, r, k_try
            if args.accept_loss is not None and best_loss <= args.accept_loss:
                break
        if args.best_of > 1:
            print(f"scene {i}: best-of-{args.best_of} kept try {chosen} "
                  f"(final loss {best_loss:.3f})", file=sys.stderr)

        x0 = res.pred_xstart[0].float().cpu().numpy()
        J_rest01 = np.clip(0.5 * (x0[..., :3] + 1.0), 0, 1)
        z_rest = x0[..., 3]
        y01_np = y01[0].cpu().numpy()
        p_in = psnr(y01_np, J_true01)
        p_out = psnr(J_rest01, J_true01)
        corr = float(np.corrcoef(z_rest.ravel(), z_true.ravel())[0, 1])
        phi = {k: v[0].cpu().numpy() for k, v in res.phi.items()}
        phi_err = float(np.mean([np.abs(phi[k] - np.asarray(PHI_TRUE[k], np.float32)).mean()
                                 for k in PHI_TRUE]))
        final_loss = float(res.sep_loss[-1].mean())
        rows.append(dict(scene=i, psnr_degraded=round(p_in, 2), psnr_restored=round(p_out, 2),
                         depth_corr=round(corr, 3), phi_mae=round(phi_err, 4),
                         final_loss=round(final_loss, 3)))
        print(f"scene {i}: degraded {p_in:.2f} dB -> restored {p_out:.2f} dB, "
              f"depth corr {corr:.3f}, phi MAE {phi_err:.4f}, final loss {final_loss:.3f}",
              file=sys.stderr)
        if args.save_png:
            strips.append((J_true01, np.clip(y01_np, 0, 1), J_rest01, z_true, z_rest))

    mean_in = float(np.mean([r["psnr_degraded"] for r in rows]))
    mean_out = float(np.mean([r["psnr_restored"] for r in rows]))
    mean_corr = float(np.mean([r["depth_corr"] for r in rows]))
    n_pos = sum(1 for r in rows if r["depth_corr"] > 0)
    # joint RGBD posterior sampling is multi-modal: an occasional
    # depth-inverted scene at toy scale is allowed, hence 2/3
    ok = (mean_out - mean_in) > 2.0 and mean_corr > 0.0 and n_pos * 3 >= len(rows) * 2

    if args.save_png and strips:
        from ..data import postprocess as P

        panels = []
        for J, y01_s, R, zt, zr in strips:
            panels += [J, y01_s, R, P.depth_to_color(P.min_max_norm_range(zt)),
                       P.depth_to_color(P.min_max_norm_range(zr))]
        P.save_png(P.make_grid(panels, nrow=5, pad_value=1.0), args.save_png)
        print(f"strip saved: {args.save_png}", file=sys.stderr)

    out = {"sampler": args.sampler, "respacing": args.respacing, "scenes": rows,
           "psnr_degraded_mean": round(mean_in, 2), "psnr_restored_mean": round(mean_out, 2),
           "psnr_gain_db": round(mean_out - mean_in, 2), "depth_corr_mean": round(mean_corr, 3),
           "pass": bool(ok)}
    if args.row_name is not None:
        out = {"row": args.row_name, **out}
    if args.sample_seed is not None:
        out["seed"] = args.sample_seed
    return out, ok


def main(argv=None):
    args = build_parser().parse_args(argv)
    out, ok = validate(args)
    print(json.dumps(out))
    if not ok:
        # first separate "the prior is weak" from "the recipe is wrong": a
        # miscalibrated prior fails every recipe
        device_flag = "--cpu" if args.cpu else f"-d {args.device}"
        print(
            "FAIL triage: (1) check prior calibration first:\n"
            f"    python -m osmosis_tpu_torch.tools.check_prior_stats --checkpoint "
            f"{args.checkpoint} --size {args.size} --channels {args.channels} "
            f"--arch {args.arch} {device_flag}\n"
            "    (rgb_std/depth_std far above the train stats => the prior learned to read "
            "amplitude cues sampling cannot provide; the measured fix is retraining with "
            "--offset-noise 0.1, not more data or steps. Probe ladder: --trajectory for "
            "on-chain contraction, --eps-bias for per-t accuracy)\n"
            "(2) isolate guidance with --oracle-phi; (3) wrong-basin phi (high final_loss "
            "outliers) => --best-of/--phi-jitter; (4) scale law: double --scale per size "
            "doubling",
            file=sys.stderr,
        )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
