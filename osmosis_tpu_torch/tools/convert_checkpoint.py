"""One-time conversion of a reference ``.pt`` state_dict to the JAX
package's ``.msgpack`` parameter tree (the port of ``tools/convert_checkpoint.py``).

    python -m osmosis_tpu_torch.tools.convert_checkpoint models/osmosis_outdoor.pt \\
        [-o models/osmosis_outdoor.msgpack] [--image-size 256] [--model-channels 256]

Reads the PyTorch pickle state_dict (~2.2 GB fp32, guided_diffusion/unet.py:
94-98) and writes the msgpack tree in the JAX layout (HWIO conv kernels,
``[in, out]`` dense kernels, part-major qkv), which both packages load.
"""

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("input", help=".pt state_dict path")
    ap.add_argument("-o", "--output", default=None, help="output .msgpack path")
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--model-channels", type=int, default=256)
    args = ap.parse_args(argv)

    import torch

    from ..models.convert import params_from_state_dict, save_params_msgpack
    from ..models.unet import UNetConfig

    cfg = UNetConfig(image_size=args.image_size, model_channels=args.model_channels)
    out = args.output or os.path.splitext(args.input)[0] + ".msgpack"
    print(f"reading {args.input} ...")
    sd = torch.load(args.input, map_location="cpu", weights_only=True)
    print(f"{len(sd)} tensors; converting ...")
    save_params_msgpack(params_from_state_dict(sd, cfg), out)
    print(f"wrote {out} ({os.path.getsize(out) / 1e9:.2f} GB)")
    return out


if __name__ == "__main__":
    main()
