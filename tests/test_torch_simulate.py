"""The port's ``tools/simulate_degraded`` against the JAX package's
``tools/simulate_degraded.py`` on the CPU, and the cases of
``tests/test_simulate.py`` for the port.

For the same GT scenes and phi, every PNG the port writes is within one
uint8 level of the JAX tool's (the formation model in the two libraries'
float32 may round to the other side of a level; the share that differs at
all is held under ``MAX_DIFFERING``) and the manifests are equal.
GT folders read with PIL give the JAX tool's OpenCV scenes exactly. The
round trip, the per-image phi jitter, the gaussian noise in the PNG and the
phi-error loop through ``run_restoration`` are the JAX tests' cases.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from osmosis_tpu_torch.guidance.operators import get_operator
from osmosis_tpu_torch.tools import simulate_degraded as S
from tools import simulate_degraded as J

OPERATORS = ["underwater_physical_revised", "underwater_physical", "haze_physical"]
# the share of the input PNGs' values whose uint8 level differs between the
# two packages at all: measured 0 of the 3456 (2 x 24 x 24 x 3) in each of the
# six cases below on an x86 CPU (torch 2.13, jax 0.9)
MAX_DIFFERING = 0.01


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scenes(n=2, size=24, seed=0):
    return [(f"scene_{i}", s) for i, s in enumerate(
        S.synth_scene_batch(torch.Generator().manual_seed(seed), n, size).numpy()[:, None])]


def _pngs(out):
    return {f"{sub}/{f}": np.asarray(Image.open(os.path.join(out, sub, f))).astype(np.int64)
            for sub in ("input", "gt_rgb", "gt_depth")
            for f in sorted(os.listdir(os.path.join(out, sub)))}


@pytest.mark.parametrize("operator", OPERATORS)
@pytest.mark.parametrize("noise,jitter", [("clean", 0.0), ("gaussian", 0.15)])
def test_dataset_matches_the_jax_tool(tmp_path, operator, noise, jitter):
    scenes = _scenes()
    kw = dict(operator_name=operator, noise=noise, sigma=0.05, phi_jitter=jitter, seed=4)
    got = S.simulate_dataset(str(tmp_path / "port"), scenes, device="cpu", **kw)
    want = J.simulate_dataset(str(tmp_path / "jax"), scenes, **kw)
    assert got == want
    with open(tmp_path / "port" / "manifest.json") as f, \
            open(tmp_path / "jax" / "manifest.json") as g:
        assert json.load(f) == json.load(g)
    a, b = _pngs(str(tmp_path / "port")), _pngs(str(tmp_path / "jax"))
    assert a.keys() == b.keys()
    differing = total = 0
    for k in a:
        d = np.abs(a[k] - b[k])
        assert d.max() <= 1, (k, d.max())
        if k.startswith("input/"):
            differing += int((d > 0).sum())
            total += d.size
        else:  # the GT is written from the same arrays: the same bytes
            assert d.max() == 0, k
    assert differing <= MAX_DIFFERING * total, f"{differing} of {total} pixels differ"


def test_gt_folders_read_with_pil_give_the_jax_tools_scenes(tmp_path):
    rng = np.random.default_rng(0)
    for sub in ("rgb", "depth", "depth8"):
        os.makedirs(tmp_path / sub)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (30, 40, 3), dtype=np.uint8)).save(
            tmp_path / "rgb" / f"im_{i}.png")
        Image.fromarray(rng.integers(0, 65535, (30, 40), dtype=np.uint16)).save(
            tmp_path / "depth" / f"im_{i}.png")
        Image.fromarray(rng.integers(0, 255, (30, 40), dtype=np.uint8)).save(
            tmp_path / "depth8" / f"im_{i}.png")
    for depth in ("depth", "depth8"):
        got = list(S.load_gt_scenes(str(tmp_path / "rgb"), str(tmp_path / depth), 24))
        want = list(J.load_gt_scenes(str(tmp_path / "rgb"), str(tmp_path / depth), 24))
        assert [n for n, _ in got] == [n for n, _ in want] == ["im_0", "im_1"]
        for (_, a), (_, b) in zip(got, want):
            assert a.shape == (1, 24, 24, 4) and np.array_equal(a, b)


def _load_rgbd(out, name):
    rgb = np.asarray(Image.open(os.path.join(out, "gt_rgb", f"{name}.png")))
    depth = np.asarray(Image.open(os.path.join(out, "gt_depth", f"{name}.png")))
    rgb01 = rgb.astype(np.float32) / 255.0
    d01 = depth.astype(np.float32) / 65535.0
    return np.concatenate([rgb01, d01[..., None]], axis=-1)[None] * 2.0 - 1.0


@pytest.mark.parametrize("operator", OPERATORS)
def test_roundtrip(tmp_path, operator):
    """The operator's forward on the saved GT with the manifest's phi gives
    the saved input within a few levels (the GT went through uint8/uint16)."""
    out = str(tmp_path / operator)
    manifest = S.simulate_dataset(out, S.synth_scenes(2, 16, seed=3), operator_name=operator,
                                  device="cpu")
    assert manifest["count"] == 2
    assert sorted(os.listdir(os.path.join(out, "input"))) == ["scene_0.png", "scene_1.png"]
    for name, phi in manifest["images"].items():
        op = get_operator(operator, batch_size=1, depth_type="gamma", value="1.4,1.4,1",
                          **{k: ",".join(str(x) for x in v) for k, v in phi.items()})
        y = torch.clamp(op.forward({k: torch.tensor([v]) for k, v in phi.items()},
                                   torch.from_numpy(_load_rgbd(out, name))), 0, 1)[0].numpy()
        saved = np.asarray(Image.open(os.path.join(out, "input", f"{name}.png"))) / 255.0
        assert np.max(np.abs(y - saved)) < 3.0 / 255.0


def test_synth_scenes_are_seeded_per_scene():
    a = dict(S.synth_scenes(3, 16, seed=0))
    b = dict(S.synth_scenes(2, 16, seed=0))
    assert np.array_equal(a["scene_1"], b["scene_1"])
    assert not np.array_equal(a["scene_0"], a["scene_1"])
    assert a["scene_0"].shape == (1, 16, 16, 4) and np.abs(a["scene_0"]).max() <= 1


def test_phi_jitter_varies_per_image(tmp_path):
    manifest = S.simulate_dataset(str(tmp_path / "jit"), S.synth_scenes(3, 16, seed=0),
                                  operator_name="haze_physical", phi_jitter=0.15, seed=7,
                                  device="cpu")
    abs_ = [manifest["images"][f"scene_{i}"]["phi_ab"][0] for i in range(3)]
    assert len(set(abs_)) == 3 and all(a > 0 for a in abs_)


def test_gaussian_noise_in_png(tmp_path):
    clean, noisy = str(tmp_path / "clean"), str(tmp_path / "noisy")
    S.simulate_dataset(clean, S.synth_scenes(1, 16, seed=5), device="cpu")
    S.simulate_dataset(noisy, S.synth_scenes(1, 16, seed=5), noise="gaussian", sigma=0.1,
                       device="cpu")
    a = np.asarray(Image.open(os.path.join(clean, "input", "scene_0.png")), dtype=np.float32)
    b = np.asarray(Image.open(os.path.join(noisy, "input", "scene_0.png")), dtype=np.float32)
    assert np.std(b - a) > 5.0  # ~0.1 * 255 noise is present


def test_simulated_protocol_phi_error_loop(tmp_path):
    """Simulate (the manifest's true phi), restore through the port's
    pipeline (the per-channel phi in progress.json), score with the port's
    ``evaluate.phi_error``: a 10-step chain on random weights barely moves
    phi, so the error is about the init's offset."""
    import yaml

    from osmosis_tpu_torch.pipelines.restore import run_restoration
    from osmosis_tpu_torch.tools.evaluate import phi_error
    from tests.test_pipelines_e2e import DIFFUSION, PATTERN, TINY_UNET

    sim = str(tmp_path / "sim")
    S.simulate_dataset(sim, S.synth_scenes(1, 32, seed=11), device="cpu")
    cfg = dict(
        save_dir=str(tmp_path / "results"), degamma_input=False, manual_seed=0,
        rgb_guidance=False, save_singles=True, save_grids=False, record_process=False,
        record_every=20, change_input_output_channels=True, input_channels=4,
        output_channels=8, sample_pattern=dict(PATTERN, n_iter=2), unet_model=TINY_UNET,
        diffusion=dict(DIFFUSION, timestep_respacing=10),
        conditioning=dict(method="osmosis", params=dict(
            loss_function="norm", loss_weight="depth", weight_function="gamma,1.4,1.4,1",
            scale="4,4,4,2", gradient_x_prev=True, gradient_clip="True,0.01")),
        aux_loss=dict(aux_loss=dict(avrg_loss=0.5, val_loss=20)),
        data=dict(batch_size=1, name="sim", root=os.path.join(sim, "input"), stop_after=1,
                  ground_truth=True, gt_rgb=os.path.join(sim, "gt_rgb"),
                  gt_depth=os.path.join(sim, "gt_depth")),
        measurement=dict(operator=dict(
            name="underwater_physical_revised", optimizer="sgd", depth_type="gamma",
            value="1.4,1.4,1", phi_a="0.7,0.6,0.5", phi_a_eta=1e-4, phi_a_learn_flag=True,
            phi_b="0.6,0.5,0.45", phi_b_eta=1e-4, phi_b_learn_flag=True,
            phi_inf="0.14,0.29,0.49", phi_inf_eta=1e-4, phi_inf_learn_flag=True),
            noise=dict(name="clean")),
    )
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.dump(cfg, f)
    out = run_restoration(cfg_path, device="cpu")
    rec = [json.loads(line) for line in open(os.path.join(out, "progress.json"))][-1]
    assert all(f"{p}_{c}" in rec for p in ("phi_a", "phi_b", "phi_inf") for c in range(3))
    err = phi_error(os.path.join(sim, "manifest.json"), out)
    assert err["n_phi_images"] == 1 and 0.01 < err["phi_mae"] < 0.5


def test_cli_needs_a_card_or_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.main(["--out", str(tmp_path / "x"), "--synth", "1", "--size", "16"])
    S.main(["--out", str(tmp_path / "y"), "--synth", "2", "--size", "16", "--cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["count"] == 2 and set(report["phi"]) == {"phi_a", "phi_b", "phi_inf"}
