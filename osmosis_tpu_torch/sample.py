"""Guided restoration CLI, the interface of the reference osmosis_sampling.py:

    python -m osmosis_tpu_torch.sample -c <config.yaml> -d <cuda index> [--cpu]

Runs on CUDA device ``-d``; ``--cpu`` runs on the CPU instead. Without a card
and without ``--cpu`` it fails rather than falling back.
"""

import os
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("-c", "--config_file", default="./configs/osmosis_sample_config.yaml",
                        help="Configurations file")
    parser.add_argument("-d", "--device", default=0, type=int, help="CUDA device index")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    config_file = os.path.abspath(args.config_file)
    print(f"\nConfiguration file:\n{config_file}\n")

    from .pipelines.restore import run_restoration

    out = run_restoration(config_file, device="cpu" if args.cpu else f"cuda:{args.device}")
    print(f"\nFINISH! outputs in {out}")
    return out


if __name__ == "__main__":
    main()
