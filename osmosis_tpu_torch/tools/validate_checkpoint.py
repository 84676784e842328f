"""One-command validation of a reference checkpoint (the port of the JAX
package's ``tools/validate_checkpoint.py``).

    python -m osmosis_tpu_torch.tools.validate_checkpoint --checkpoint <osmosis_outdoor.pt> \\
        [--config configs/osmosis_simulation_sample_config.yaml] [--stop-after 5] \\
        [--bisect] [-d <cuda idx> | --cpu]
    python -m osmosis_tpu_torch.tools.validate_checkpoint --tiny --cpu   # the self-test

Stages:
  1. convert: read the reference ``.pt`` state_dict under its own names (the
     port's UNet has them), carry it through the JAX package's parameter
     layout into a ``.msgpack`` (the port's codec, the bytes the JAX
     package writes) and load that back into a second UNet; the two
     forwards on a fixed probe must agree at the repo's UNet bar, rtol 1e-3
     and atol 5e-4. On disagreement, or with ``--bisect``, forward hooks on
     the last layer of every block, compared in plan order, name the first
     block whose output diverges. (The JAX tool compares against the
     reference repository's own torch UNet, which the port does without.)
  2. sample: the preset's guided restoration through ``run_restoration``
     with the converted ``.msgpack``, on the preset's data, or on a few
     synthesized simulated underwater images where its data root is absent.
  3. score: PSNR and SSIM (``evaluate``) against the dataset's GT.

Without ``--checkpoint`` (or with a missing path) a seeded random UNet at the
config's shape is validated instead (its zero-initialized convs randomized
so that parity covers them); ``--tiny`` uses a tiny UNet and a 20-step
chain. Runs on CUDA device ``-d``, or on the CPU with ``--cpu``; without a
card and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch
from PIL import Image

from .. import config as C
from ..models.convert import (init_unet, params_from_state_dict, save_params_msgpack,
                              unet_from_msgpack)
from ..models.unet import UNetConfig, UNetModel, unet_config_from_yaml
from ..pipelines.restore import resolve_device, run_restoration
from .evaluate import evaluate_dirs

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
RTOL, ATOL = 1e-3, 5e-4  # the repo's UNet parity bar

TINY = dict(image_size=32, num_channels=32, num_res_blocks=1, channel_mult="1,2",
            attention_resolutions="8", num_heads=4, num_head_channels=16)


def _close(got: torch.Tensor, ref: torch.Tensor):
    """(within the bar, max |got - ref| / max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item() or 1.0
    return err <= ATOL + RTOL * scale, err / scale


def build_reference_model(unet_cfg: dict, checkpoint, device):
    """The UNet at the config's shape holding the ``.pt`` state_dict, or, with
    no checkpoint, seeded random weights with the zero-initialized convs
    set to 0.02·N(0, 1). Returns (model, config, where the weights came from)."""
    cfg = unet_config_from_yaml(unet_cfg)
    model = init_unet(cfg, seed=0)
    if checkpoint and os.path.exists(checkpoint):
        model.load_state_dict(torch.load(checkpoint, map_location="cpu", weights_only=True))
        source = checkpoint
    else:
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                if not p.any():
                    p.add_(0.02 * torch.randn(p.shape, generator=gen))
        source = "random-init (no checkpoint found: harness self-test mode)"
    return model.requires_grad_(False).eval().to(device), cfg, source


def _probe(cfg: UNetConfig, size: int, device):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, size, size, cfg.in_channels)).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.tensor([433.0], device=device)


def stage_convert_and_parity(ref_model: UNetModel, cfg: UNetConfig, out_msgpack: str,
                             bisect: bool, probe_size: int):
    """.pt weights -> .msgpack -> a second UNet; the full-forward parity, and
    the per-block bisection where it fails (or with ``bisect``). Returns
    (ok, relative error, the first diverging block or None)."""
    device = next(ref_model.parameters()).device
    save_params_msgpack(params_from_state_dict(ref_model.state_dict(), cfg), out_msgpack)
    model = unet_from_msgpack(out_msgpack, cfg).requires_grad_(False).eval().to(device)
    print(f"[convert] wrote {out_msgpack} "
          f"({sum(p.numel() for p in model.parameters()):,} weights)")
    x, ts = _probe(cfg, probe_size, device)
    with torch.no_grad():
        ok, rel = _close(model(x, ts), ref_model(x, ts))
    print(f"[parity] max |d| / max |ref| = {rel:.3e} (bar: atol {ATOL} + rtol {RTOL}) -> "
          f"{'OK' if ok else 'MISMATCH'}")
    first_bad = None
    if bisect or not ok:
        first_bad = bisect_layers(ref_model, model, x, ts)
    return ok, rel, first_bad


def _block_outputs(model: UNetModel, x, ts):
    """Each block's output (its last layer's), by the reference's block names."""
    acts, handles = {}, []

    def hook(name):
        def fn(_m, _i, out):
            acts[name] = out.detach()
        return fn

    for i, block in enumerate(model.input_blocks):
        handles.append(block[-1].register_forward_hook(hook(f"input_blocks.{i}")))
    handles.append(model.middle_block[-1].register_forward_hook(hook("middle_block")))
    for i, block in enumerate(model.output_blocks):
        handles.append(block[-1].register_forward_hook(hook(f"output_blocks.{i}")))
    try:
        with torch.no_grad():
            model(x, ts)
    finally:
        for h in handles:
            h.remove()
    return acts


def bisect_layers(ref_model: UNetModel, model: UNetModel, x, ts):
    """Per-block outputs of the two models in plan order; returns the first
    block whose output diverges (the converter fault's locator), or None."""
    want, got = _block_outputs(ref_model, x, ts), _block_outputs(model, x, ts)
    first_bad = None
    for name, ref in want.items():
        ok, rel = _close(got[name], ref)
        print(f"  [bisect] {name:22s} rel {rel:.3e} {'ok' if ok else 'DIVERGED'}")
        if not ok and first_bad is None:
            first_bad = name
    if first_bad:
        print(f"[bisect] first diverging block: {first_bad}")
    else:
        print("[bisect] all blocks agree (any full-forward mismatch would be in the out head)")
    return first_bad


def ensure_dataset(run_cfg: dict, size: int, n: int = 2) -> dict:
    """The preset's data section; where its root is absent (the simulated set
    is not in the repository), a few synthesized simulated underwater images:
    random GT RGB and uint16 depth, the input degraded by
    I = J·e^(−φ_ab z) + φ_inf(1 − e^(−φ_ab z)), so that scoring runs end
    to end."""
    data = dict(run_cfg["data"])
    if os.path.isdir(data.get("root", "")):
        return data
    base = tempfile.mkdtemp(prefix="osmosis_valsim_")
    dirs = {k: os.path.join(base, k) for k in ("input", "gt_rgb", "gt_depth")}
    for d in dirs.values():
        os.makedirs(d)
    rng = np.random.default_rng(7)
    phi_ab = np.array([0.3, 0.35, 0.4], np.float32)
    phi_inf = np.array([0.14, 0.29, 0.49], np.float32)
    for i in range(n):
        J = rng.uniform(0.1, 0.9, (size, size, 3)).astype(np.float32)
        z01 = rng.uniform(0.0, 1.0, (size, size, 1)).astype(np.float32)
        z = 3.0 * z01
        I = J * np.exp(-phi_ab * z) + phi_inf * (1 - np.exp(-phi_ab * z))
        Image.fromarray((np.clip(I, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(dirs["input"], f"sim_{i}.png"))
        Image.fromarray((J * 255).astype(np.uint8)).save(
            os.path.join(dirs["gt_rgb"], f"sim_{i}.png"))
        Image.fromarray((z01[..., 0] * 65535).astype(np.uint16)).save(
            os.path.join(dirs["gt_depth"], f"sim_{i}.png"))
    print(f"[data] preset data root missing: synthesized {n} simulated underwater images "
          f"at {base}")
    data.update(root=dirs["input"], gt_rgb=dirs["gt_rgb"], gt_depth=dirs["gt_depth"],
                ground_truth=True)
    return data


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=None,
                    help=".pt state_dict (osmosis_outdoor.pt); omit for the self-test")
    ap.add_argument("--config",
                    default=os.path.join(ROOT, "configs", "osmosis_simulation_sample_config.yaml"))
    ap.add_argument("--out", default=None, help="msgpack output path")
    ap.add_argument("--stop-after", type=int, default=2, help="images to restore in stage 2")
    ap.add_argument("--respacing", default=None,
                    help="override timestep_respacing for a faster stage 2 (e.g. 100)")
    ap.add_argument("--bisect", action="store_true",
                    help="run the per-block bisection even when parity holds")
    ap.add_argument("--probe-size", type=int, default=None,
                    help="spatial size of the parity probe (default: the config's image_size; "
                         "64 with --tiny)")
    ap.add_argument("--skip-sample", action="store_true", help="stage 1 only")
    ap.add_argument("--tiny", action="store_true",
                    help="self-test with a tiny UNet and a 20-step chain instead of the "
                         "config's")
    ap.add_argument("-d", "--device", type=int, default=0, help="CUDA device index")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else f"cuda:{args.device}")
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    unet_cfg = dict(C.arguments_from_file(args.config).unet_model)
    if args.tiny:
        unet_cfg.update(TINY)
    ref_model, cfg, source = build_reference_model(unet_cfg, args.checkpoint, device)
    print(f"[model] {cfg.model_channels}ch UNet, weights: {source}")
    out_msgpack = args.out or os.path.join(
        ROOT, "checkpoints",
        os.path.splitext(os.path.basename(args.checkpoint or "selftest.pt"))[0] + ".msgpack")
    os.makedirs(os.path.dirname(os.path.abspath(out_msgpack)), exist_ok=True)
    probe = args.probe_size or min(cfg.image_size, 64 if args.tiny else cfg.image_size)
    ok, rel, first_bad = stage_convert_and_parity(ref_model, cfg, out_msgpack, args.bisect, probe)
    del ref_model
    summary = {"weights": source, "parity_ok": ok, "parity_rel_err": rel,
               "first_diverging_block": first_bad, "msgpack": out_msgpack}

    if not args.skip_sample and ok:
        import yaml

        with open(args.config) as f:
            run_cfg = yaml.safe_load(f)
        run_cfg["unet_model"] = dict(unet_cfg, model_path=out_msgpack)
        run_cfg["data"] = dict(ensure_dataset(run_cfg, size=cfg.image_size),
                               stop_after=args.stop_after)
        if args.tiny:
            run_cfg["diffusion"] = dict(run_cfg["diffusion"], steps=20, timestep_respacing=20)
        if args.respacing is not None:
            run_cfg["diffusion"] = dict(run_cfg["diffusion"], timestep_respacing=args.respacing)
        with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as tmp_cfg:
            yaml.safe_dump(run_cfg, tmp_cfg)
        print(f"[sample] running {args.config} (stop_after={args.stop_after})")
        try:
            run_dir = run_restoration(tmp_cfg.name, device=device)
        finally:
            os.unlink(tmp_cfg.name)
        summary["run_dir"] = run_dir
        gt_dir = run_cfg["data"].get("gt_rgb")
        rgb_dir = os.path.join(run_dir, "single_images", "rgb")
        if gt_dir and os.path.isdir(gt_dir) and os.path.isdir(rgb_dir):
            scores = evaluate_dirs(rgb_dir, gt_dir)
            summary["psnr_mean"] = round(scores["psnr"], 3)
            summary["ssim_mean"] = round(scores["ssim"], 4)
            print(f"[score] PSNR {summary['psnr_mean']} / SSIM {summary['ssim_mean']} "
                  f"over {scores['n']} images")
        else:
            print("[score] no GT directory in the preset: skipped")
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
