"""The day-one runbook rehearsed at production geometry without the real
weights: the H100's wall-clock budget for ``real_weights_runbook``.

    python -m osmosis_tpu_torch.tools.runbook_rehearsal [--out DIR] [--stop-after 1] \\
        [--presets reference,fast,...] [--synth 2] [-d 0]

Writes the seeded random-init checkpoint that ``chip_smoke.py`` drives (the
preset UNet, 552.8M parameters at 256²: ``init_unet`` with seed 0, each
all-zero parameter plus 0.02·N(0, 1) from a CPU generator seeded 1) as a
``.pt`` state_dict, then runs ``real_weights_runbook`` on it with every
preset at its real length, the simulation sets built from ``--synth``
procedural 256px scenes per operator, and ``--rehearsal-json`` written into
``--out``: each stage's seconds with the card's name and power limit. Random
weights restore nothing: the scores are noise, the budget is the result.
"""

import argparse
import os

import torch


def seeded_checkpoint(path: str) -> int:
    """The seeded random-init preset UNet as a ``.pt``; returns its size in
    parameters."""
    from ..config import load_yaml
    from ..models.convert import init_unet
    from ..models.unet import unet_config_from_yaml
    from .real_weights_runbook import CONFIGS

    cfg = unet_config_from_yaml(load_yaml(os.path.join(
        CONFIGS, "osmosis_sample_config.yaml"))["unet_model"])
    model = init_unet(cfg, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
    torch.save(model.state_dict(), path)
    return sum(p.numel() for p in model.parameters())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="runbook_rehearsal")
    ap.add_argument("--stop-after", type=int, default=1)
    ap.add_argument("--presets", default=None, help="comma list (default: all ten)")
    ap.add_argument("--synth", type=int, default=2, help="procedural scenes per simulation set")
    ap.add_argument("-d", "--device", type=int, default=0, help="CUDA device index")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    from . import real_weights_runbook as RB

    os.makedirs(args.out, exist_ok=True)
    pt = os.path.abspath(os.path.join(args.out, "random_init.pt"))
    n = seeded_checkpoint(pt)
    print(f"[rehearsal] seeded random-init checkpoint: {n / 1e6:.1f}M params -> {pt}", flush=True)
    rb_argv = ["--checkpoint", pt, "--synth", str(args.synth), "--out", args.out,
               "--stop-after", str(args.stop_after),
               "--rehearsal-json", os.path.join(args.out, "rehearsal.json")]
    rb_argv += ["--presets", args.presets] if args.presets else []
    rb_argv += ["--cpu"] if args.cpu else ["-d", str(args.device)]
    return RB.main(rb_argv)


if __name__ == "__main__":
    main()
