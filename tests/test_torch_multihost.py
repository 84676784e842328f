"""The port's multi-process data parallelism on the CPU, over gloo (after
tests/test_multihost.py).

Every rank is a real OS process running the port's CLI
(``python -m osmosis_tpu_torch.sample --cpu --coordinator 127.0.0.1:<port>
--num-processes P --process-id k``) through the worker entry at the end of
this file, which then gathers its rank across processes and writes a JSON
report. The claim is bitwise: chain noise is keyed on (seed, t, i), so image
i restored by rank i % P writes the PNGs and phi of a one-process run.

(a) 2 ranks, 3 images; (b) 4 ranks, 5 images: one run dir, image i on rank
    i % P, every image once, rank-suffixed logs, the bytes of one process.
(c) The prior, 2 ranks, 4 indices: one run dir, the bytes of one process.
(d) The fleet (batch 2, segments, chain checkpoints) killed at a segment
    boundary on both ranks and resumed: the bytes of an uninterrupted
    2-rank run, and no chain state left.
(e) Rank 0 exits 17 after its first image: the other rank exits non-zero
    within the timeout; a relaunch with ``resume: True`` finishes the rest.
(f) ``host_slice`` and ``rank_suffix`` against the JAX functions.
Also the barrier: ranks that skew by more than the timeout pass it, and a
dead peer makes it raise within the timeout.

Every subprocess runs under ``communicate(timeout=...)`` and is killed when
its test's time limit (``budget``) runs out.
"""

import json
import os
import socket
import subprocess
import sys
import time
from os.path import join as pjoin

import numpy as np
import pytest
import yaml
from PIL import Image

from tests.test_pipelines_e2e import DIFFUSION, PATTERN, TINY_UNET

REPO = os.path.abspath(pjoin(os.path.dirname(__file__), ".."))
RESPACING = 5


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _restore_cfg(root, save_dir, resume=False, batch_size=1, respacing=RESPACING, **extra):
    return dict(
        save_dir=save_dir, degamma_input=False, manual_seed=0, rgb_guidance=False,
        save_singles=True, save_grids=False, record_process=False, record_every=20,
        resume=resume, **extra,
        sample_pattern=PATTERN, unet_model=TINY_UNET,
        diffusion=dict(DIFFUSION, timestep_respacing=respacing),
        conditioning=dict(method="osmosis", params=dict(
            loss_function="norm", loss_weight="depth", weight_function="gamma,1.4,1.4,1",
            scale="7,7,7,0.9", gradient_x_prev=True, gradient_clip="True,0.005")),
        aux_loss=dict(aux_loss=dict(avrg_loss=0.5, val_loss=20)),
        data=dict(batch_size=batch_size, name="mh", root=root, stop_after=-1,
                  ground_truth=False),
        measurement=dict(operator=dict(
            name="underwater_physical_revised", optimizer="sgd", depth_type="gamma",
            value="1.4,1.4,1", phi_a="1.1,0.95,0.95", phi_a_eta=1e-5, phi_a_learn_flag=True,
            phi_b="0.95, 0.8, 0.8", phi_b_eta=1e-5, phi_b_learn_flag=True,
            phi_inf="0.14, 0.29, 0.49", phi_inf_eta=1e-5, phi_inf_learn_flag=True),
            noise=dict(name="clean")),
    )


def _prior_cfg(save_dir, n=4):
    return dict(save_dir=save_dir, number_of_images=n, manual_seed=4321, save_singles=True,
                save_grids=False, record_process=False, record_every=20, unet_model=TINY_UNET,
                diffusion=dict(DIFFUSION, timestep_respacing=RESPACING))


def _write(path, cfg):
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    return path


def _write_dataset(root, n, size=40):
    """``n`` seeded images; the first k are the same whatever ``n``."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
            pjoin(root, f"img_{i}.png"))
    return root


def _launch(n, tmp_path, cfg, tag, kind="sample", crash_after=0, env_extra=None):
    """``n`` ranks of the CLI on ``cfg``; rank k reports to report_<tag>_<k>.json.
    With ``crash_after`` rank 0 exits 17 after saving that many images."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **(env_extra or {}))
    procs = []
    for k in range(n):
        report = pjoin(str(tmp_path), f"report_{tag}_{k}.json")
        cli = ["-c", cfg, "--cpu", "--coordinator", coordinator, "--num-processes", str(n),
               "--process-id", str(k)]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_multihost", report, kind,
             str(crash_after if k == 0 else 0), *cli],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _drain(procs, deadline):
    """Each process's output and the seconds it took; a process still running
    at ``deadline`` (time.time()) is killed."""
    outs, t0 = [], time.time()
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n[killed at the test's time limit]"
        outs.append((out, time.time() - t0))
    return outs


def _reports(tmp_path, tag, n):
    return [json.load(open(pjoin(str(tmp_path), f"report_{tag}_{k}.json"))) for k in range(n)]


def _check_ok(procs, outs, what):
    for k, (p, (out, _)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{what}: rank {k} exited {p.returncode}:\n{out[-4000:]}"


def _files(run_dir, sub="single_images"):
    """Every file under ``run_dir/sub`` by relative path, as bytes."""
    out = {}
    top = pjoin(run_dir, sub)
    for d, _, fs in os.walk(top):
        for f in fs:
            with open(pjoin(d, f), "rb") as fh:
                out[os.path.relpath(pjoin(d, f), top)] = fh.read()
    return out


def _rows(run_dir, name="progress.json"):
    if not os.path.exists(pjoin(run_dir, name)):
        return []  # a rank that had nothing left to run
    with open(pjoin(run_dir, name)) as f:
        return [json.loads(line) for line in f if line.strip()]


def _phi(row):
    return {k: v for k, v in row.items() if k.startswith("phi_") or k == "final_loss"}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A one-process run over 5 images, in this process: the bytes and phi
    that every multi-process run must give."""
    import torch

    from osmosis_tpu_torch.pipelines.restore import run_restoration

    tmp = tmp_path_factory.mktemp("reference")
    root = _write_dataset(str(tmp / "imgs"), 5)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run_dir = run_restoration(_write(str(tmp / "cfg.yaml"), _restore_cfg(
            root, str(tmp / "results"))), device="cpu")
    finally:
        torch.set_num_threads(before)
    return dict(files=_files(run_dir), phi={r["image"]: _phi(r) for r in _rows(run_dir)})


def _check_split_run(tmp_path, reference, n_ranks, n_images, budget):
    root = _write_dataset(str(tmp_path / "imgs"), n_images)
    cfg = _write(str(tmp_path / "cfg.yaml"), _restore_cfg(root, str(tmp_path / "results")))
    procs = _launch(n_ranks, tmp_path, cfg, "run")
    _check_ok(procs, _drain(procs, time.time() + budget), f"{n_ranks} ranks")
    reports = _reports(tmp_path, "run", n_ranks)
    assert len({r["run_dir"] for r in reports}) == 1, reports
    run_dir = reports[0]["run_dir"]
    for k, r in enumerate(reports):
        assert r["rank"] == k and r["count"] == n_ranks
        assert r["gathered_ranks"] == [float(j) for j in range(n_ranks)]
        # image i is restored by rank i % P, and only there
        assert r["images"] == [f"img_{i}.png" for i in range(k, n_images, n_ranks)], r
    logs = sorted(f for f in os.listdir(run_dir) if f.startswith(("log", "progress")))
    want = ["log.txt", "progress.csv", "progress.json"]
    for k in range(1, n_ranks):
        want += [f"log-rank{k:03d}.txt", f"progress-rank{k:03d}.csv",
                 f"progress-rank{k:03d}.json"]
    assert logs == sorted(want)
    with open(pjoin(run_dir, "log-rank001.txt")) as f:
        text = f.read()
    assert f"multi-host run: process 1/{n_ranks}" in text
    assert "multi-host: all processes finished (this rank: 1)" in text
    # every image once, each with the one-process run's bytes and phi
    got = _files(run_dir)
    want_files = {k: v for k, v in reference["files"].items()
                  if int(k.split("img_")[1].split(".")[0]) < n_images}
    assert sorted(got) == sorted(want_files)
    for name in want_files:
        assert got[name] == want_files[name], f"{name} differs from the one-process run"
    phi = {row["image"]: _phi(row) for r in reports for row in r["rows"]}
    assert phi == {k: v for k, v in reference["phi"].items() if k in phi}
    assert len(phi) == n_images
    return run_dir


def test_two_ranks_three_images(tmp_path, reference):
    """(a) Budget 60 s."""
    _check_split_run(tmp_path, reference, 2, 3, budget=60)


def test_four_ranks_five_images(tmp_path, reference):
    """(b) Budget 90 s."""
    _check_split_run(tmp_path, reference, 4, 5, budget=90)


def test_two_rank_prior(tmp_path):
    """(c) One run dir, every sample index once, the bytes of one process.
    Budget 60 s."""
    import torch

    from osmosis_tpu_torch.pipelines.prior import run_prior_sampling

    cfg = _write(str(tmp_path / "prior.yaml"), _prior_cfg(str(tmp_path / "results")))
    procs = _launch(2, tmp_path, cfg, "prior", kind="prior")
    torch.set_num_threads(1)  # the one-process run, here, while the ranks run
    one = run_prior_sampling(_write(str(tmp_path / "prior_one.yaml"), _prior_cfg(
        str(tmp_path / "results_one"))), device="cpu")
    _check_ok(procs, _drain(procs, time.time() + 60), "prior")
    reports = _reports(tmp_path, "prior", 2)
    assert reports[0]["run_dir"] == reports[1]["run_dir"]
    assert [r["images"] for r in reports] == [[0, 2], [1, 3]]
    got, want = _files(reports[0]["run_dir"]), _files(one)
    assert sorted(got) == [f"{d}/image_{i}.png" for d in ("depth_color", "rgb") for i in range(4)]
    assert got == want
    with open(pjoin(reports[0]["run_dir"], "configurations.txt")) as f:
        assert "# perf knobs" in f.read()


def test_fleet_crash_at_a_boundary_then_resume(tmp_path):
    """(d) batch_size 2, progress_segments 3 and chain_checkpoint on 2 ranks,
    4 images (one chunk a rank): both ranks die at their first segment
    boundary, the relaunch resumes mid-chain, and the PNGs equal an
    uninterrupted 2-rank run's. Budget 80 s."""
    deadline = time.time() + 80
    root = _write_dataset(str(tmp_path / "imgs"), 4)
    kw = dict(batch_size=2, respacing=6, progress_segments=3, chain_checkpoint=True)
    results, clean = str(tmp_path / "results"), str(tmp_path / "results_clean")
    crash_cfg = _write(str(tmp_path / "cfg.yaml"), _restore_cfg(root, results, **kw))
    clean_cfg = _write(str(tmp_path / "clean.yaml"), _restore_cfg(root, clean, **kw))
    crashing = _launch(2, tmp_path, crash_cfg, "crash",
                       env_extra={"OSMOSIS_TPU_CRASH_AFTER_SEGMENTS": "1"})
    uninterrupted = _launch(2, tmp_path, clean_cfg, "clean")
    outs = _drain(crashing, deadline)
    for p, (out, _) in zip(crashing, outs):
        assert p.returncode == 17 and "WORKER_CRASH" in out, out[-3000:]
    _check_ok(uninterrupted, _drain(uninterrupted, deadline), "uninterrupted")
    partials = [d for d, _, fs in os.walk(results) if "partial.npz" in fs]
    assert len(partials) == 2, partials  # one chunk journal a rank, mid-chain
    assert not [f for d, _, fs in os.walk(results) for f in fs if f.endswith(".png")]

    resume_cfg = _write(str(tmp_path / "resume.yaml"), _restore_cfg(
        root, results, resume=True, **kw))
    procs = _launch(2, tmp_path, resume_cfg, "resume")
    _check_ok(procs, _drain(procs, deadline), "resume")
    resumed, control = _reports(tmp_path, "resume", 2), _reports(tmp_path, "clean", 2)
    run_dir = resumed[0]["run_dir"]
    assert resumed[1]["run_dir"] == run_dir
    assert [r["images"] for r in resumed] == [["img_0.png", "img_2.png"],
                                              ["img_1.png", "img_3.png"]]
    for name in ("log.txt", "log-rank001.txt"):
        with open(pjoin(run_dir, name)) as f:
            assert "resuming chain at step 2/6" in f.read()
    assert not os.path.exists(pjoin(run_dir, ".chain_state"))
    got, want = _files(run_dir), _files(control[0]["run_dir"])
    assert len(got) == 16 and got == want


def test_crash_then_resume(tmp_path, reference):
    """(e) 2 ranks, 4 images: rank 0 exits 17 after its first image; rank 1
    exits non-zero within the timeout instead of hanging. A relaunch with
    ``resume: True`` re-enters the run dir, skips what is done and finishes
    the rest, each image once with the one-process bytes. Budget 70 s."""
    from osmosis_tpu_torch.parallel.multihost import DEFAULT_TIMEOUT_S

    deadline = time.time() + 70
    root = _write_dataset(str(tmp_path / "imgs"), 4)
    results = str(tmp_path / "results")
    procs = _launch(2, tmp_path, _write(str(tmp_path / "cfg.yaml"), _restore_cfg(root, results)),
                    "crash", crash_after=1)
    outs = _drain(procs, deadline)
    assert procs[0].returncode == 17 and "WORKER_CRASH" in outs[0][0], outs[0][0][-3000:]
    assert procs[1].returncode not in (0, None), outs[1][0][-3000:]
    assert outs[1][1] < DEFAULT_TIMEOUT_S
    rgb_dirs = [d for d, _, _ in os.walk(results) if d.endswith(pjoin("single_images", "rgb"))]
    assert len(rgb_dirs) == 1
    done = sorted(os.listdir(rgb_dirs[0]))
    assert "img_0.png" in done and "img_2.png" not in done

    resume_cfg = _write(str(tmp_path / "resume.yaml"), _restore_cfg(root, results, resume=True))
    procs = _launch(2, tmp_path, resume_cfg, "resume")
    _check_ok(procs, _drain(procs, deadline), "resume")
    reports = _reports(tmp_path, "resume", 2)
    run_dir = reports[0]["run_dir"]
    assert reports[1]["run_dir"] == run_dir == os.path.dirname(os.path.dirname(rgb_dirs[0]))
    assert [d for d, _, _ in os.walk(results) if d.endswith(pjoin("single_images", "rgb"))] \
        == rgb_dirs
    logs = "".join(open(pjoin(run_dir, f)).read() for f in os.listdir(run_dir)
                   if f.startswith("log"))
    for name in done:
        assert f"skipping image {name[4:-4]}: {name}" in logs
    got = _files(run_dir)
    want = {k: v for k, v in reference["files"].items()
            if int(k.split("img_")[1].split(".")[0]) < 4}
    assert got == want


def test_helpers_match_the_jax_functions(monkeypatch):
    """(f) For P = 1..4 and every rank, host_slice and rank_suffix equal the
    JAX functions' (jax.process_index / process_count monkeypatched); with no
    process group the port reports rank 0 of 1 and initialises none."""
    import jax
    import torch.distributed as dist

    from osmosis_tpu.parallel import multihost as J
    from osmosis_tpu_torch.parallel import multihost as MH

    assert (MH.process_index(), MH.process_count(), MH.is_multihost()) == (0, 1, False)
    assert MH.host_slice(5) == [0, 1, 2, 3, 4] and MH.rank_suffix() == ""
    MH.barrier("no group")  # a no-op
    assert not dist.is_initialized()
    for count in range(1, 5):
        for rank in range(count):
            monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
            monkeypatch.setattr(jax, "process_count", lambda c=count: c)
            monkeypatch.setattr(MH, "process_index", lambda r=rank: r)
            monkeypatch.setattr(MH, "process_count", lambda c=count: c)
            for n in range(10):
                assert MH.host_slice(n) == J.host_slice(n), (count, rank, n)
            assert MH.rank_suffix() == J.rank_suffix()


def test_gather_without_a_group():
    """One process: every leaf gains a leading axis of 1; scalars in float64."""
    import torch

    from osmosis_tpu_torch.parallel import multihost as MH

    got = MH.gather_pytree({"a": torch.ones(2, dtype=torch.bfloat16), "b": [np.arange(3), 2.5]})
    assert got["a"].shape == (1, 2) and got["a"].dtype == np.float32
    assert got["b"][0].tolist() == [[0, 1, 2]] and got["b"][1].tolist() == [2.5]
    s = MH.gather_scalars({"x": 1, "y": 2.5})
    assert s["x"].dtype == np.float64 and s["x"].tolist() == [1.0] and s["y"].tolist() == [2.5]


def test_barrier_waits_out_skew_and_fails_on_a_dead_peer(tmp_path):
    """With a 2 s timeout: a rank that reaches the barrier 5 s late passes
    it (its heartbeat shows it alive), and a rank whose peer exited raises
    within the timeout. Budget 40 s."""
    deadline = time.time() + 40
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    groups = {}
    for case in ("skew", "dead"):
        addr = f"127.0.0.1:{_free_port()}"
        groups[case] = [subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_multihost", "-", f"barrier-{case}", "0",
             addr, "2", str(k)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for k in range(2)]
    skew = _drain(groups["skew"], deadline)
    _check_ok(groups["skew"], skew, "skew")
    assert all("BARRIER_PASSED" in out for out, _ in skew)
    dead = _drain(groups["dead"], deadline)
    assert groups["dead"][1].returncode == 3
    assert groups["dead"][0].returncode not in (0, None), dead[0][0][-3000:]
    assert "has sent no heartbeat" in dead[0][0] and "BARRIER_PASSED" not in dead[0][0]


def _worker(argv):
    """A rank: ``<report> <kind> <crash_after> <CLI args...>``, with ``kind``
    sample, prior or barrier-skew / barrier-dead (``<addr> <P> <k>`` then)."""
    report, kind, crash_after, rest = argv[0], argv[1], int(argv[2]), argv[3:]
    import torch

    torch.set_num_threads(1)
    from osmosis_tpu_torch import prior_sample, sample
    from osmosis_tpu_torch.parallel import multihost as MH
    from osmosis_tpu_torch.pipelines import restore as R

    if kind.startswith("barrier"):
        MH.initialize(rest[0], int(rest[1]), int(rest[2]), timeout_s=2.0)
        MH.initialize(rest[0], int(rest[1]), int(rest[2]))  # joined already: keeps the group
        if kind == "barrier-dead" and MH.process_index() == 1:
            os._exit(3)
        if kind == "barrier-skew" and MH.process_index() == 1:
            time.sleep(5.0)
        MH.barrier("skewed")
        print("BARRIER_PASSED", flush=True)
        return
    if crash_after:
        finish, saved = R._finish_image, []

        def crashing(*a, **k):
            finish(*a, **k)
            saved.append(1)
            if len(saved) >= crash_after:
                print(f"WORKER_CRASH after {len(saved)} image(s)", flush=True)
                os._exit(17)

        R._finish_image = crashing
    try:
        run_dir = (prior_sample if kind == "prior" else sample).main(rest)
    except RuntimeError as e:
        if "injected crash" in str(e):
            print(f"WORKER_CRASH at a segment boundary: {e}", flush=True)
            os._exit(17)
        raise
    gathered = MH.gather_scalars({"rank": float(MH.process_index())})
    rows = _rows(run_dir, f"progress{MH.rank_suffix()}.json")
    with open(report, "w") as f:
        json.dump(dict(rank=MH.process_index(), count=MH.process_count(), run_dir=run_dir,
                       gathered_ranks=gathered["rank"].tolist(),
                       images=[r["image"] for r in rows], rows=rows), f)
    MH.barrier("done")


if __name__ == "__main__":
    _worker(sys.argv[1:])
