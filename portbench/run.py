#!/usr/bin/env python3
"""The benchmark of osmosis_tpu_torch on one NVIDIA GPU: guided restoration
throughput, checked against a plain float32 reference.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card. ``<cell>`` is
an entry of ``BENCHMARK.json``'s ``workloads``; its configuration is
``portbench/configs/<config>.json`` and its traffic ``portbench/traffic/
<traffic>.json``. Every metric is read by ``portbench/metrics/<name>.py``:
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a ``torch.profiler`` trace of the window.

The run draws the weights and inputs from ``--seed``, warms up one segment,
measures whole segments for ``--seconds`` (to the next segment boundary),
then holds the window's recorded steps against the reference
(``portbench/reference``). The facts of the run go to earlier lines; the last
line of standard output is one JSON object, and the last lines of standard
error give each compared number beside its limit. Without a card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded once the
window has closed, it prints no result and exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "osmosis_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def metric_names(bench: dict, section: str, cell: str):
    return [m["name"] for m in bench[section] if cell in m.get("workloads", [cell])]


def reader(home: str, name: str):
    """``read(ctx)`` of ``<home>/metrics/<name>.py``."""
    from harness import load
    return load(home, "metrics", name).read


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device: str,
             home: str = HERE, t_start: float = T0, overrides=None) -> dict:
    """One run of ``workload`` on ``device``: prints the run's facts, the
    compared numbers (standard error) and the result line, and returns the
    result. ``home`` holds the cell's configuration, family, traffic and
    metric files; ``overrides`` (a smaller model) serves the harness's
    tests. The readers' context holds the outcome, its trace, the cell, the
    seed, the cell's family and its sizes (``arch``), the card's peaks and
    the torso's dtype."""
    import torch
    from harness.cell import Cell
    from yardstick.peaks import peaks

    cell = Cell(workload, bench, device, overrides, home=home)
    out = cell.run(seed, seconds, trace=trace, t_start=t_start)
    cuda = cell.device.type == "cuda"
    kind = torch.cuda.get_device_name(cell.device) if cuda else "cpu"
    chips = int(cell.entry["chips"])
    ctx = SimpleNamespace(outcome=out, trace=out.trace, cell=cell, seed=seed, family=cell.family,
                          arch=cell.arch, peaks=peaks(kind) if cuda else None,
                          torso="bf16" if cell.dtype == torch.bfloat16 else "fp32")
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    for name in metric_names(bench, "per_layer" if trace else "end_to_end", workload):
        value = reader(home, name)(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    device_row = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": chips,
                  "memory_peak_bytes": int(max(out.setup_peak, out.window_peak))}
    if out.trace is not None:
        device_row.update(busy_s=out.trace.busy_s(), window_s=out.trace.window_s)
    # a gap that is not finite (a non-finite output) or was not read prints as null
    checks = {k: {"value": out.gaps[k] if math.isfinite(out.gaps.get(k, math.nan)) else None,
                  "limit": v} for k, v in out.limits.items()}
    f = out.facts
    card = power_limit() if cuda else "no card"
    print(f"card: {card} (nvidia-smi name, power.limit); {kind}, {chips} used")
    print(f"arithmetic: {f['precision']}; convolution algorithms: {f['algorithms']}")
    for key, why in f["departures"].items():
        print(f"departure from the preset: {key}: {why}")
    print(f"traffic: {out.lanes} lane(s); the phi-update slice {f['slice']}")
    print(f"window: {out.steps} steps ({out.x_prev_steps} x_prev) of {out.lanes} lane(s) in "
          f"{out.window_s:.3f} s over images {sorted({s[0] for s in out.segments})}; "
          f"set-up {out.setup_s:.3f} s; peaks {out.setup_peak / 2**30:.3f} GiB set-up, "
          f"{out.window_peak / 2**30:.3f} GiB window")
    if out.clip_share is not None:
        print(f"pullback values the gradient clip ({cell.P.clip}) reaches: "
              f"{100 * out.clip_share:.2f}% at the recorded x_prev steps")
    print(f"segments' seconds in the window: {f['segment_s']}")
    print(f"host in each segment (the machine's busy %, stolen %, this process's CPU %): "
          f"{f['segment_host']}; mean CPU clock {f['cpu_mhz']} MHz and 1-minute load "
          f"{f['load']} at the window's start and end")
    if out.trace is not None:
        print(f"traced after the window: {out.trace_steps} steps ({out.trace_x_prev} x_prev) "
              f"in {out.trace.window_s:.3f} s")
    print(f"checked: {out.checked_steps} recorded steps against the reference; "
          f"image-steps with a non-finite loss: {out.failed} of {out.attempted}")
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_row}
    if out.trace is not None:
        from harness.trace import breakdown
        result["breakdown"] = breakdown(out.trace)
    result["checks"] = checks
    sys.stdout.flush()
    for k, c in checks.items():
        value = "not finite or not read" if c["value"] is None else f"{c['value']:.6g}"
        print(f"check {k}: {value} (limit {c['limit']:.6g})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; the cells are {sorted(cells)}",
              file=sys.stderr)
        return 2
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    sys.path[:0] = [HERE, ROOT]
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):  # the result waits for the look at sys.modules
        run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    loaded = forbidden_modules()
    if loaded:
        print(buf.getvalue().rsplit("\n", 2)[0], flush=True)  # the facts, not the result
        print(f"modules of JAX or the JAX package are loaded: {loaded}", file=sys.stderr)
        return 4
    sys.stdout.write(buf.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
