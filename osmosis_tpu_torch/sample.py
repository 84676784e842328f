"""Guided restoration CLI, the interface of the reference osmosis_sampling.py:

    python -m osmosis_tpu_torch.sample -c <config.yaml> -d <cuda index> [--cpu] [--bf16] [--progress N]

Runs on CUDA device ``-d``; ``--cpu`` runs on the CPU instead. Without a card
and without ``--cpu`` it fails rather than falling back. ``--bf16`` runs the
UNet torso in bfloat16 (fp32 GroupNorm statistics); ``--progress N`` prints
the loss and phi every N diffusion steps.
"""

import os
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("-c", "--config_file", default="./configs/osmosis_sample_config.yaml",
                        help="Configurations file")
    parser.add_argument("-d", "--device", default=0, type=int, help="CUDA device index")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--bf16", action="store_true",
                        help="run the UNet torso in bfloat16 (fp32 GroupNorm statistics)")
    parser.add_argument("--progress", type=int, default=None, metavar="N",
                        help="print loss/phi every N diffusion steps")
    args = parser.parse_args(argv)
    config_file = os.path.abspath(args.config_file)
    print(f"\nConfiguration file:\n{config_file}\n")

    import torch

    from .pipelines.restore import run_restoration

    out = run_restoration(config_file, device="cpu" if args.cpu else f"cuda:{args.device}",
                          dtype=torch.bfloat16 if args.bf16 else torch.float32,
                          progress_every=args.progress)
    print(f"\nFINISH! outputs in {out}")
    return out


if __name__ == "__main__":
    main()
