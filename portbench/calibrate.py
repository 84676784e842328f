#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, in one process:
the program on many seeds, and the configuration's control (the reference
computed below the configuration's precision, in the program's place) on a
few, each a whole run of the cell with the run's own comparison.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds <s> [--out FILE]

Prints one JSON line per run ({"seed", "control", "gaps", "correct", ...})
and writes them all to ``--out``. The control is the configuration's ``control``: the plain
reference in the program's place, computed one precision below the
configuration's (:func:`control_kwargs`). Not part of a benchmark run.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_kwargs(cell, seed):
    """``Cell.run``'s arguments that put the configuration's control in the
    program's place: the reference model, its products' operands rounded to
    TF32 (on a card: cuDNN and cuBLAS in TF32) or to fp8, and the reference's
    chain segment with its later stages in ``control["stages"]``."""
    import torch
    from reference import chain, lowp
    ctl = cell.config["control"]
    on_card_tf32 = ctl["unet"] == "tf32" and cell.device.type == "cuda"
    quant = None if on_card_tf32 else getattr(lowp, ctl["unet"])
    dtype = getattr(torch, ctl["stages"])

    def swap_segment(_program_segment, model):
        def seg(x, y, seed_, phi, opt, ts, buf):
            return chain.segment(cell.P, model, x, y, seed_, phi, ts, buf, dtype=dtype)
        return seg

    return dict(swap_model=lambda _m: cell.reference(seed).set_quant(quant),
                swap_segment=swap_segment, tf32=on_card_tf32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch
    from harness.cell import Cell

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate needs a CUDA card")
    cell = Cell(args.workload, bench, "cuda:0")
    rows = []
    plan = [(int(s), False) for s in args.seeds.split(",") if s] + [
        (int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in plan:
        t0 = time.perf_counter()
        kw = control_kwargs(cell, seed) if control else {}
        try:
            out = cell.run(seed, args.seconds, **kw)
            row = dict(workload=args.workload, seed=seed, control=control, gaps=out.gaps,
                       correct=out.correct, steps=out.steps, checked=out.checked_steps,
                       failed=out.failed, rate=out.lanes * out.steps / out.window_s,
                       setup_s=out.setup_s, clip_share=out.clip_share,
                       peak_gib=out.window_peak / 2 ** 30, seconds=time.perf_counter() - t0)
        except Exception as e:  # a control that crashes has failed; record and go on
            row = dict(workload=args.workload, seed=seed, control=control, error=repr(e))
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
