"""Simulation-dataset generator: ground-truth RGBD through a physical
formation model into the simulation preset's dataset layout (the port of the
JAX package's ``tools/simulate_degraded.py``).

    python -m osmosis_tpu_torch.tools.simulate_degraded --out <dir> --synth 6 --size 64 \\
        [--operator haze_physical] [--phi-jitter 0.1] [--noise gaussian --sigma 0.05] \\
        [-d <cuda idx> | --cpu]
    python -m osmosis_tpu_torch.tools.simulate_degraded --out <dir> \\
        --gt-rgb <rgb dir> --gt-depth <uint16 depth dir> --size 256 [--cpu]

Writes what ``ImagesFolderGT`` reads::

    <out>/input/*.png       degraded RGB (uint8)
    <out>/gt_rgb/*.png      clean RGB (uint8)
    <out>/gt_depth/*.png    depth (uint16)
    <out>/manifest.json     every image's true phi and the generation settings

The scenes are GT folders (RGB PNGs and uint16 or uint8 depth PNGs, read with
PIL) or procedural toy scenes (``--synth N``, the toy trainer's
distribution, drawn from ``torch.Generator`` streams on the CPU, so their
bits differ from the JAX tool's ``jax.random`` scenes but not between
devices). The degradation is the port's operator forward on the run's
device (``-d``, or ``--cpu``; without a card and without ``--cpu`` it
raises); the phi jitter and the gaussian noise come from numpy's
``default_rng(seed)``, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch
from PIL import Image

from ..data import transforms as T
from ..data.datasets import _read_unchanged, natsorted
from ..diffusion.guided import draw_seed
from ..guidance.operators import get_operator
from ..pipelines.restore import resolve_device
from .train_toy_prior import synth_scene_batch

# the true degradation parameters per operator: the regimes of the toy
# validation (the presets' inits are offset from these)
DEFAULT_PHI = {
    "underwater_physical_revised": {
        "phi_a": "0.55,0.45,0.35",
        "phi_b": "0.5,0.4,0.35",
        "phi_inf": "0.18,0.32,0.45",
    },
    "underwater_physical": {
        "phi_ab": "0.5,0.42,0.35",
        "phi_inf": "0.18,0.32,0.45",
    },
    "haze_physical": {
        "phi_ab": "0.8",
        "phi_inf": "0.7,0.72,0.74",
    },
}

Scene = Tuple[str, np.ndarray]  # (name, rgbd [1, size, size, 4] in [-1, 1])


def _resize_crop_float(arr: np.ndarray, size: int) -> np.ndarray:
    """Float [H, W, C] -> [size, size, C]: the pipeline's small-side resize
    and center crop."""
    h, w = arr.shape[:2]
    if (h, w) != (size, size):
        new_h, new_w = T._small_side_dims(h, w, size)
        arr = T.bilinear_resize_u8(arr, new_h, new_w)
        arr = T.center_crop(arr, size)
    return arr.astype(np.float32)


def load_gt_scenes(gt_rgb_dir: str, gt_depth_dir: str, size: int,
                   limit: int = -1) -> Iterator[Scene]:
    """(name, rgbd) from GT folders, paired by natsorted index: RGB from u8
    images, depth from uint16 (0..65535 -> [0, 1]) or u8 (0..255) PNGs."""
    rgbs = natsorted(os.listdir(gt_rgb_dir))
    depths = natsorted(os.listdir(gt_depth_dir))
    if len(rgbs) != len(depths):
        raise SystemExit(f"gt_rgb has {len(rgbs)} files but gt_depth has {len(depths)}")
    if limit > 0:
        rgbs, depths = rgbs[:limit], depths[:limit]
    for rgb_name, depth_name in zip(rgbs, depths):
        try:
            with Image.open(os.path.join(gt_rgb_dir, rgb_name)) as im:
                rgb = np.asarray(im.convert("RGB"), np.float32) / 255.0
            d = _read_unchanged(os.path.join(gt_depth_dir, depth_name))
        except OSError as e:
            raise SystemExit(f"cannot read {rgb_name} / {depth_name}: {e}") from e
        if d is None:
            raise SystemExit(f"cannot read depth {depth_name}")
        if d.ndim == 3:
            d = d[..., 0]
        d01 = d.astype(np.float32) / (65535.0 if d.dtype == np.uint16 else 255.0)
        rgbd = np.concatenate([_resize_crop_float(rgb, size),
                               _resize_crop_float(d01[..., None], size)], axis=-1) * 2.0 - 1.0
        yield os.path.splitext(rgb_name)[0], rgbd[None]


def synth_scenes(n: int, size: int, seed: int) -> Iterator[Scene]:
    """Procedural toy scenes (the toy trainer's distribution): scene i from a
    CPU generator seeded by ``draw_seed(seed, i, 0)``; ``validate_toy_e2e``
    draws its held-out scene i the same way."""
    for i in range(n):
        gen = torch.Generator().manual_seed(draw_seed(seed, i, 0))
        yield f"scene_{i}", synth_scene_batch(gen, 1, size).numpy()


def jitter_phi(phi, sigma: float, rng: np.random.Generator):
    """Per-image multiplicative log-normal jitter, clipped positive; phi_inf
    (the veiling light, a colour in [0, 1]) is also capped at 1, so the
    formation output stays in [0, 1]."""
    if sigma <= 0:
        return phi
    out = {}
    for k, v in phi.items():
        j = np.maximum(v * np.exp(rng.normal(0.0, sigma, v.shape)).astype(v.dtype), 1e-3)
        if k == "phi_inf":
            j = np.minimum(j, 1.0)
        out[k] = j
    return out


def simulate_dataset(out: str, scenes: Iterable[Scene],
                     operator_name: str = "underwater_physical_revised", phi_spec=None,
                     depth_type: str = "gamma", depth_value: str = "1.4,1.4,1",
                     noise: str = "clean", sigma: float = 0.05, phi_jitter: float = 0.0,
                     seed: int = 0, device="cuda:0") -> dict:
    """Write the simulation layout from (name, rgbd in [-1, 1]) pairs, the
    operator's forward on ``device`` (the card unless the caller asks for the
    CPU); returns the manifest."""
    dev = resolve_device(device)
    for sub in ("input", "gt_rgb", "gt_depth"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)

    phi_spec = dict(DEFAULT_PHI[operator_name], **(phi_spec or {}))
    op = get_operator(operator_name, batch_size=1, depth_type=depth_type, value=depth_value,
                      **phi_spec)
    base_phi = op.phi_init()
    rng = np.random.default_rng(seed)
    manifest = {
        "operator": operator_name, "depth_type": depth_type, "depth_value": depth_value,
        "noise": noise, "sigma": sigma if noise == "gaussian" else None,
        "phi_jitter": phi_jitter, "seed": seed, "images": {},
    }
    n = 0
    for name, rgbd in scenes:
        phi = jitter_phi(base_phi, phi_jitter, rng)
        with torch.no_grad():
            y01 = op.forward({k: torch.as_tensor(v, device=dev) for k, v in phi.items()},
                             torch.as_tensor(rgbd, device=dev)).cpu().numpy()[0]
        if noise == "gaussian":
            y01 = y01 + sigma * rng.standard_normal(y01.shape).astype(np.float32)
        y01 = np.clip(y01, 0.0, 1.0)
        rgb01 = np.clip(0.5 * (rgbd[0, ..., :3] + 1.0), 0, 1)
        depth01 = np.clip(0.5 * (rgbd[0, ..., 3] + 1.0), 0, 1)
        Image.fromarray((y01 * 255).round().astype(np.uint8)).save(
            os.path.join(out, "input", f"{name}.png"))
        Image.fromarray((rgb01 * 255).round().astype(np.uint8)).save(
            os.path.join(out, "gt_rgb", f"{name}.png"))
        Image.fromarray((depth01 * 65535).round().astype(np.uint16)).save(
            os.path.join(out, "gt_depth", f"{name}.png"))
        manifest["images"][name] = {k: np.asarray(v)[0].tolist() for k, v in phi.items()}
        n += 1
    manifest["count"] = n
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="output dataset directory")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--synth", type=int, metavar="N", help="synthesize N procedural toy scenes")
    src.add_argument("--gt-rgb", help="directory of GT RGB images")
    ap.add_argument("--gt-depth", help="directory of GT depth maps "
                    "(uint16 or uint8 PNGs; natsorted index pairing)")
    ap.add_argument("--limit", type=int, default=-1, help="use only the first N GT pairs")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--operator", default="underwater_physical_revised",
                    choices=sorted(DEFAULT_PHI))
    ap.add_argument("--phi-a", help="true phi_a (revised underwater)")
    ap.add_argument("--phi-b", help="true phi_b (revised underwater)")
    ap.add_argument("--phi-ab", help="true phi_ab (underwater/haze)")
    ap.add_argument("--phi-inf", help="true phi_inf")
    ap.add_argument("--depth-type", default="gamma", choices=["gamma", "original", "move"])
    ap.add_argument("--depth-value", default="1.4,1.4,1")
    ap.add_argument("--noise", default="clean", choices=["clean", "gaussian"])
    ap.add_argument("--sigma", type=float, default=0.05)
    ap.add_argument("--phi-jitter", type=float, default=0.0,
                    help="per-image log-normal phi jitter sigma")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-d", "--device", type=int, default=0, help="CUDA device index")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.gt_rgb and not args.gt_depth:
        ap.error("--gt-rgb requires --gt-depth")
    phi_spec = {}
    for k in ("phi_a", "phi_b", "phi_ab", "phi_inf"):
        v = getattr(args, k)
        if v is not None:
            if k not in DEFAULT_PHI[args.operator]:
                ap.error(f"--{k.replace('_', '-')} does not apply to {args.operator}")
            phi_spec[k] = v
    dev = resolve_device("cpu" if args.cpu else f"cuda:{args.device}")
    if args.synth is not None:
        scenes = synth_scenes(args.synth, args.size, args.seed)
    else:
        scenes = load_gt_scenes(args.gt_rgb, args.gt_depth, args.size, args.limit)
    manifest = simulate_dataset(
        args.out, scenes, operator_name=args.operator, phi_spec=phi_spec,
        depth_type=args.depth_type, depth_value=args.depth_value, noise=args.noise,
        sigma=args.sigma, phi_jitter=args.phi_jitter, seed=args.seed, device=dev)
    print(json.dumps({
        "out": args.out, "count": manifest["count"], "operator": args.operator,
        "phi": dict(manifest["images"].get(next(iter(manifest["images"]), ""), {})),
    }))
    return manifest


if __name__ == "__main__":
    main()
