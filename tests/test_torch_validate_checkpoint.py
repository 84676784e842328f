"""The port's ``validate_checkpoint`` on the CPU (after
tests/test_validate_checkpoint.py, without the reference checkout): the
``--tiny`` self-test through every stage, a ``.pt`` read under its own
names, and the bisection naming the block that holds a corrupted layer,
whether the reference weights or the converted ones were corrupted."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from osmosis_tpu_torch.models.convert import unet_from_msgpack
from osmosis_tpu_torch.tools import validate_checkpoint as V

TINY_UNET = dict(
    image_size=32, num_channels=32, num_res_blocks=1, channel_mult="1,2", learn_sigma=True,
    attention_resolutions="8", num_heads=4, num_head_channels=16, num_heads_upsample=-1,
    use_scale_shift_norm=True, dropout=0.0, resblock_updown=True, use_fp16=False,
    use_new_attention_order=False, pretrain_model="osmosis",
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_tiny_selftest_runs_every_stage(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the preset's save_dir is ./results
    out = str(tmp_path / "selftest.msgpack")
    rc = V.main(["--tiny", "--cpu", "--out", out, "--stop-after", "1", "--respacing", "4"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["parity_ok"] and summary["parity_rel_err"] < 1e-3
    assert summary["first_diverging_block"] is None and "random-init" in summary["weights"]
    assert os.path.exists(out) and os.path.isdir(summary["run_dir"])
    assert "psnr_mean" in summary and "ssim_mean" in summary


def test_a_pt_checkpoint_is_read_under_its_own_names(tmp_path, capsys):
    ref, cfg, _ = V.build_reference_model(TINY_UNET, None, "cpu")
    pt = str(tmp_path / "osmosis_outdoor.pt")
    torch.save(ref.state_dict(), pt)
    rc = V.main(["--tiny", "--cpu", "--checkpoint", pt, "--skip-sample", "--bisect",
                 "--out", str(tmp_path / "w.msgpack")])
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and summary["weights"] == pt and summary["parity_ok"]
    assert "[bisect] all blocks agree" in out and "run_dir" not in summary
    loaded = unet_from_msgpack(str(tmp_path / "w.msgpack"), cfg)
    for name, v in loaded.state_dict().items():
        assert torch.equal(v, ref.state_dict()[name]), name


def test_bisect_localizes_a_corrupted_reference_layer(tmp_path, capsys):
    """Corrupt one layer of the reference model after the conversion: the
    bisection names the first block that holds it (as the JAX test does)."""
    ref, cfg, _ = V.build_reference_model(TINY_UNET, None, "cpu")
    path = str(tmp_path / "w.msgpack")
    V.save_params_msgpack(V.params_from_state_dict(ref.state_dict(), cfg), path)
    model = unet_from_msgpack(path, cfg).eval()
    with torch.no_grad():
        ref.middle_block[0].in_layers[2].weight.add_(0.5)
    x, ts = V._probe(cfg, 32, "cpu")
    assert V.bisect_layers(ref, model, x, ts) == "middle_block"
    out = capsys.readouterr().out
    assert "input_blocks.0" in out and "DIVERGED" in out


def test_a_converter_fault_fails_parity_and_is_bisected(tmp_path, monkeypatch, capsys):
    """A conversion that writes one wrong kernel (the first output block's
    conv) fails stage 1, and the bisection, run because it failed, names
    that block."""
    convert = V.params_from_state_dict

    def faulty(sd, cfg):
        p = convert(sd, cfg)
        p["params"]["out_0_0"]["in_conv"]["kernel"] = p["params"]["out_0_0"]["in_conv"][
            "kernel"] * 1.5
        return p

    monkeypatch.setattr(V, "params_from_state_dict", faulty)
    ref, cfg, _ = V.build_reference_model(TINY_UNET, None, "cpu")
    ok, rel, first_bad = V.stage_convert_and_parity(ref, cfg, str(tmp_path / "w.msgpack"),
                                                    bisect=False, probe_size=32)
    assert not ok and rel > 1e-3 and first_bad == "output_blocks.0"
    assert "MISMATCH" in capsys.readouterr().out


def test_ensure_dataset_synthesizes_a_simulation_set():
    data = V.ensure_dataset({"data": dict(batch_size=1, name="simulation",
                                          root="/nonexistent/path", ground_truth=True)},
                            size=24, n=2)
    assert len(os.listdir(data["root"])) == 2 and data["ground_truth"]
    a = np.asarray(Image.open(os.path.join(data["root"], "sim_0.png")))
    b = np.asarray(Image.open(os.path.join(data["gt_rgb"], "sim_0.png")))
    d = np.asarray(Image.open(os.path.join(data["gt_depth"], "sim_0.png")))
    assert np.abs(a.astype(int) - b.astype(int)).mean() > 2  # the physics was applied
    assert d.dtype == np.uint16 and d.shape == (24, 24)
