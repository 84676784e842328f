"""The port's restoration pipeline end to end on the CPU: a tiny random-init
UNet, tiny images, few steps; checks the run-dir contract, the log lines and
finite outputs, and that the entry points refuse to fall back to the CPU."""

import json
import os
from os.path import join as pjoin

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from osmosis_tpu_torch.pipelines.restore import run_restoration

TINY_UNET = dict(
    image_size=32, num_channels=32, num_res_blocks=1, channel_mult="1,2", learn_sigma=True,
    class_cond=False, use_checkpoint=False, attention_resolutions="8", num_heads=4,
    num_head_channels=16, num_heads_upsample=-1, use_scale_shift_norm=True, dropout=0.0,
    resblock_updown=True, use_fp16=False, use_new_attention_order=False,
    model_path="/nonexistent/random_init.pt", pretrain_model="osmosis",
)


def _config(tmp_path, images, **overrides):
    cfg = dict(
        save_dir=str(tmp_path / "results"), degamma_input=False, manual_seed=0,
        rgb_guidance=False, save_singles=True, save_grids=True,
        record_process=True, record_every=5,
        change_input_output_channels=True, input_channels=4, output_channels=8,
        sample_pattern=dict(pattern="pcgs", update_start=0.7, update_end=0, global_N=2,
                            local_M=1, s_start=1, s_end=0, n_iter=2, start_guidance=1,
                            stop_guidance=0),
        unet_model=TINY_UNET,
        diffusion=dict(sampler="ddpm", steps=1000, noise_schedule="linear",
                       model_mean_type="epsilon", model_var_type="learned_range",
                       dynamic_threshold=False, clip_denoised=True, min_max_denoised=False,
                       rescale_timesteps=False, timestep_respacing=10),
        conditioning=dict(method="osmosis", params=dict(
            loss_function="norm", loss_weight="depth", weight_function="gamma,1.4,1.4,1",
            scale="7,7,7,0.9", gradient_x_prev=True, gradient_clip="True,0.005")),
        aux_loss=dict(aux_loss=dict(avrg_loss=0.5, val_loss=20)),
        data=dict(batch_size=1, name="tiny", root=images, stop_after=1, ground_truth=False),
        measurement=dict(
            operator=dict(
                name="underwater_physical_revised", optimizer="sgd", depth_type="gamma",
                value="1.4,1.4,1",
                phi_a="1.1,0.95,0.95", phi_a_eta=1e-5, phi_a_learn_flag=True,
                phi_b="0.95, 0.8, 0.8", phi_b_eta=1e-5, phi_b_learn_flag=True,
                phi_inf="0.14, 0.29, 0.49", phi_inf_eta=1e-5, phi_inf_learn_flag=True,
            ),
            noise=dict(name="clean"),
        ),
    )
    cfg.update(overrides)
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    return path


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny UNet runs fastest on one thread when test workers share the
    cores; the previous setting is restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def images(tmp_path):
    d = str(tmp_path / "images")
    os.makedirs(d)
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)).save(
            pjoin(d, f"img_{i}.png"))
    return d


def test_restoration_on_cpu_writes_the_run_dir(tmp_path, images):
    out = run_restoration(_config(tmp_path, images), device="cpu")
    assert os.path.exists(pjoin(out, "configurations.txt"))
    for sub in ("input", "rgb", "depth_color", "depth_raw"):
        assert os.path.exists(pjoin(out, "single_images", sub, "img_0.png")), sub
    assert not os.path.exists(pjoin(out, "single_images", "rgb", "img_1.png"))
    for g in (0, 1):
        assert os.path.exists(pjoin(out, "grid_results", f"img_0_g{g}_grid.png"))
    assert os.path.exists(pjoin(out, "grid_results", "img_0_process.png"))
    log = open(pjoin(out, "log.txt")).read()
    assert "Results values" in log and "Norm loss" in log and "global iteration: 1" in log
    with open(pjoin(out, "progress.json")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert [r["global_iter"] for r in rows] == [0, 1]
    assert all(r["chain_finite"] is True and np.isfinite(r["final_loss"]) for r in rows)
    # global_N warm start: the second chain starts from the first one's phi
    assert rows[0]["phi_a_0"] != rows[1]["phi_a_0"]
    rgb = np.asarray(Image.open(pjoin(out, "single_images", "rgb", "img_0.png")))
    assert rgb.shape == (32, 32, 3)


def test_cli_on_cpu(tmp_path, images):
    from osmosis_tpu_torch.sample import main

    out = main(["-c", _config(tmp_path, images), "--cpu"])
    assert os.path.exists(pjoin(out, "single_images", "rgb", "img_0.png"))


def test_entry_points_refuse_to_fall_back_to_the_cpu(tmp_path, images, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_restoration(_config(tmp_path, images))
    from osmosis_tpu_torch.sample import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-c", _config(tmp_path, images), "-d", "0"])


@pytest.mark.parametrize("override", [
    dict(rgb_guidance=True),
    dict(best_of=2),
    dict(progress_segments=4),
    dict(chain_checkpoint=True),
])
def test_restore_extensions_outside_the_slice_raise(tmp_path, images, override):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_restoration(_config(tmp_path, images, **override), device="cpu")
