"""Multi-process data parallelism over ``torch.distributed`` (port of
``osmosis_tpu/parallel/multihost.py``).

Every process runs the same program on its own card (or on a card it
shares), images stride across processes by rank into one run dir, and each
rank logs to its own files. Images are independent, so nothing of the hot
loop crosses processes: only host scalars, gathered at the end, and
barriers. That traffic runs over gloo by default, which also lets several
ranks share one card; ``initialize(backend="nccl")`` (or
``"cpu:gloo,cuda:nccl"``) takes NCCL for CUDA tensors, one card a rank,
for the mesh's collectives (``parallel/mesh``). Ranks that share a card ask
for gloo themselves: NCCL refuses them, and :func:`initialize` raises before
it would.

Launch, the same command in every process, each with its id and its card:

    python -m osmosis_tpu_torch.sample -c config.yaml -d <card> \\
        --coordinator <host0>:<port> --num-processes N --process-id I

or under ``torchrun`` (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) with
``--multihost`` alone.

Barriers: ranks may reach the end of a run whole images apart, so a barrier
waits without a deadline while every peer is alive. Each rank bumps a
heartbeat counter in the coordinator's store every second; a peer whose
counter stops for ``timeout_s`` seconds (its process died or its machine is
gone) makes the barrier raise, and a dead rank 0 takes the store with it, so
the others' next store call raises at once. Either way a rank whose peer
died exits non-zero instead of hanging. Rank 0 leaves each barrier last, so
the store it serves outlives every peer's wait.
"""

from __future__ import annotations

import atexit
import datetime
import os
import socket
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 180.0
HEARTBEAT_S = 1.0
POLL_S = 0.05

_STATE: dict = {}  # the store, the timeout and the barriers' generations


BACKENDS = ("gloo", "nccl", "cpu:gloo,cuda:nccl")


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
               backend: str = "gloo") -> None:
    """Join the process group: ``backend`` (gloo, or with NCCL for CUDA
    tensors, one of :data:`BACKENDS`), its rendezvous at
    ``tcp://HOST:PORT``, where rank 0 serves the store (under torchrun, its
    agent does). Arguments left out are read from torchrun's MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK. ``timeout_s`` bounds every collective
    and how long a silent peer is waited for. With NCCL each rank runs on
    its current CUDA device (``torch.cuda.set_device`` first), and ranks that
    share one raise. A second call with the same rank and size keeps the
    group."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    env = os.environ
    addr = coordinator_address
    if addr is None and env.get("MASTER_ADDR"):
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    n = num_processes if num_processes is not None else env.get("WORLD_SIZE")
    pid = process_id if process_id is not None else env.get("RANK")
    if addr is None or n is None or pid is None:
        raise ValueError("multi-process run: give the coordinator HOST:PORT, the number of "
                         "processes and this process's id, or set MASTER_ADDR, MASTER_PORT, "
                         "WORLD_SIZE and RANK")
    if _STATE:  # joined already: a CLI's main called again in this process
        if (process_count(), process_index()) != (int(n), int(pid)):
            raise RuntimeError(f"this process is rank {process_index()} of {process_count()} "
                               f"already, not rank {pid} of {n}")
        return
    timeout = datetime.timedelta(seconds=timeout_s)
    store, pid, n = next(dist.rendezvous(f"tcp://{addr}", rank=int(pid), world_size=int(n),
                                         timeout=timeout))
    here = f"{socket.gethostname()}/{_device_name(backend)}"
    store.set(f"osmosis/device/{pid}", here)
    devices = [store.get(f"osmosis/device/{r}").decode() for r in range(n)]
    _check_devices(backend, devices)
    dist.init_process_group(backend, store=store, world_size=n, rank=pid, timeout=timeout)
    _STATE.update(store=store, timeout_s=float(timeout_s), gens={}, backend=backend,
                  devices=devices)
    # one trivial collective at once, so the backend's connections are made
    # while the ranks are still in step
    probe = torch.zeros((), device=f"cuda:{torch.cuda.current_device()}" if backend == "nccl"
                        else "cpu")
    dist.all_gather([torch.zeros_like(probe) for _ in range(n)], probe)
    stop = threading.Event()
    beat = threading.Thread(target=_heartbeat, args=(store, pid, stop), name="osmosis-heartbeat",
                            daemon=True)
    if n > 1:
        beat.start()
    atexit.register(_shutdown, stop, beat)


def _device_name(backend: str) -> str:
    """The card a rank's NCCL collectives use (gloo ranks: no claim)."""
    return f"cuda:{torch.cuda.current_device()}" if "nccl" in backend else "gloo"


def _check_devices(backend: str, devices) -> None:
    if "nccl" not in backend:
        return
    seen = {}
    for r, d in enumerate(devices):
        if d in seen:
            raise RuntimeError(f"NCCL needs one card a rank, but ranks {seen[d]} and {r} share "
                               f"{d}; ranks that share a card join with backend='gloo'")
        seen[d] = r


def check_devices() -> None:
    """Raise where the group's backend is NCCL and two ranks share a card."""
    if _STATE:
        _check_devices(_STATE["backend"], _STATE["devices"])


def _shutdown(stop, beat):
    """At exit: the heartbeat stopped and the process group destroyed before
    the interpreter goes, so that no thread of gloo's or of the store is still
    running when the process's objects are torn down (which aborts it)."""
    stop.set()
    if beat.is_alive():
        beat.join(timeout=2 * HEARTBEAT_S)
    if dist.is_initialized():
        dist.destroy_process_group()


def add_cli_arguments(parser) -> None:
    """The CLIs' cluster flags, those of the JAX package's CLIs."""
    parser.add_argument("--multihost", action="store_true",
                        help="join a multi-process run; without --coordinator/--num-processes/"
                             "--process-id read MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK "
                             "(torchrun)")
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="rank 0's rendezvous address")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)


def initialize_from_cli(args) -> None:
    """:func:`initialize` when the CLI was given --multihost or --coordinator."""
    if args.multihost or args.coordinator is not None:
        initialize(args.coordinator, args.num_processes, args.process_id)


def _heartbeat(store, rank, stop):
    try:
        while not stop.is_set():
            store.add(f"osmosis/heartbeat/{rank}", 1)
            stop.wait(HEARTBEAT_S)
    except Exception:  # the store is gone: rank 0 ended; the main thread finds out
        return


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_multihost() -> bool:
    return process_count() > 1


def host_slice(n_items: int) -> list:
    """The indices this process owns: a stride by rank, so an early stop
    (``stop_after``) stays balanced across processes."""
    return list(range(process_index(), n_items, process_count()))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(tree)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees]) for i in range(len(first)))
    return np.stack(trees)


def gather_pytree(tree):
    """Every process's ``tree`` (dicts, lists and tuples of numpy arrays,
    tensors or scalars; bf16 tensors come as fp32), stacked leaf by leaf into
    ``[process_count, ...]`` numpy arrays on every process."""
    local = _numpy(tree)
    parts = [local]
    if is_multihost():
        parts = [None] * process_count()
        dist.all_gather_object(parts, local)
    return _stack(parts)


def gather_scalars(values: dict) -> dict:
    """``{name: float}`` on each process -> ``{name: float64 array [P]}``."""
    keys = sorted(values)
    stacked = gather_pytree(np.asarray([float(values[k]) for k in keys], np.float64))
    return {k: stacked[..., i] for i, k in enumerate(keys)}


def _wait_count(key, target, what):
    """Poll the store until ``key`` reaches ``target``, checking that every
    peer's heartbeat moves."""
    store, timeout = _STATE["store"], _STATE["timeout_s"]
    me = process_index()
    seen = {r: (-1, time.monotonic()) for r in range(process_count()) if r != me}
    while store.add(key, 0) < target:
        now = time.monotonic()
        for r, (beat, since) in seen.items():
            b = store.add(f"osmosis/heartbeat/{r}", 0)
            if b != beat:
                seen[r] = (b, now)
            elif now - since > timeout:
                raise RuntimeError(f"{what}: process {r} has sent no heartbeat for "
                                   f"{timeout:.0f} s; it died or its host is gone")
        time.sleep(POLL_S)


def barrier(name: str = "osmosis") -> None:
    """Wait until every process has reached the barrier of this name."""
    if not is_multihost():
        return
    gens = _STATE["gens"]
    gens[name] = gens.get(name, 0) + 1
    key = f"osmosis/barrier/{name}/{gens[name]}"
    store, n = _STATE["store"], process_count()
    store.add(key + "/in", 1)
    _wait_count(key + "/in", n, f"barrier {name!r}")
    store.add(key + "/out", 1)
    if process_index() == 0:
        _wait_count(key + "/out", n, f"barrier {name!r}")


def rank_suffix() -> str:
    """The suffix of this process's log files: "" on rank 0, "-rank001" on
    rank 1, and so on."""
    r = process_index()
    return "" if r == 0 else f"-rank{r:03d}"
