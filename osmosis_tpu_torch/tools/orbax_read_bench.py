"""Seconds to read an orbax checkpoint with the port's reader
(``models/convert.load_params_orbax``), by each zstd decoder.

    python -m osmosis_tpu_torch.tools.orbax_read_bench --path DIR [--decoders native,python]

The native decoder is ``utils/csrc/host_ops.cc`` (``utils/native``); the
plain one is ``utils/zstd.decompress_py``, selected by setting
``OSMOSIS_TPU_NO_NATIVE`` for its run. Each decoder reads the whole tree once,
in turn, on the host; the arrays of every run must be equal. It prints one
JSON object with the host's CPU, the tree's parameters and bytes, and the
seconds of each run. (``python -m tests.test_torch_orbax --full-width DIR`` writes
the 552.8M-parameter preset tree with the JAX package's
``save_params_orbax``.)
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import time

import numpy as np
import torch


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", required=True, help="an orbax checkpoint directory")
    ap.add_argument("--decoders", default="native,python")
    args = ap.parse_args(argv)
    from ..models.convert import load_params_orbax
    from ..utils import native, zstd

    out = dict(path=args.path, cpu=cpu_name(), cores=os.cpu_count(), runs={})
    first = None
    for name in args.decoders.split(","):
        if name == "python":
            os.environ[native.NO_NATIVE_ENV] = "1"
        elif native.build() is None:  # raises where it cannot build
            raise RuntimeError("no native library")
        try:
            decoder = zstd.decoder()
            if not decoder.startswith(name):
                raise RuntimeError(f"asked for the {name} decoder, {decoder} is in use")
            t0 = time.perf_counter()
            tree = load_params_orbax(args.path)
            seconds = time.perf_counter() - t0
        finally:
            os.environ.pop(native.NO_NATIVE_ENV, None)
        leaves = dict(_leaves(tree))
        arrays = {k: (v.view(torch.int16).numpy() if isinstance(v, torch.Tensor) else v)
                  for k, v in leaves.items()}
        if first is None:
            first = arrays
            out.update(leaves=len(arrays), parameters=int(sum(a.size for a in arrays.values())),
                       bytes=int(sum(a.nbytes for a in arrays.values())))
        elif not all(np.array_equal(first[k], arrays[k]) for k in first):
            raise AssertionError(f"the {name} decoder read other arrays")
        out["runs"][name] = dict(decoder=decoder, seconds=seconds,
                                 mb_per_s=out["bytes"] / seconds / 1e6)
        del tree, leaves, arrays
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
