"""Which convolution algorithms a restoration run takes (pipelines.restore):
on a card a fp32 run with ``chain_checkpoint`` takes cuDNN's deterministic
algorithms, so that a resumed fp32 chain writes the uninterrupted run's
bytes; other runs keep the default ones (the deterministic ones cost a fp32
guided step 40% at batch 1 on an H100, PERF.md); a caller's own setting
stands; the run's log says which. The card is stood in for by a device
object whose type is "cuda"."""

from os.path import join as pjoin
from types import SimpleNamespace

import pytest
import torch

from osmosis_tpu_torch.pipelines import restore as R
from tests.test_torch_pipeline import _config, images, one_torch_thread  # noqa: F401

CUDA = SimpleNamespace(type="cuda", index=0)
CPU = torch.device("cpu")


@pytest.mark.parametrize("dtype,chain_checkpoint,caller,want", [
    (torch.float32, True, False, True),
    (torch.float32, False, False, False),
    (torch.bfloat16, True, False, False),
    (torch.bfloat16, False, False, False),
    (torch.float32, False, True, True),
    (torch.bfloat16, False, True, True),
], ids=["fp32-checkpoint", "fp32", "bf16-checkpoint", "bf16", "fp32-caller-set",
        "bf16-caller-set"])
def test_the_choice_by_dtype_and_chain_checkpoint(dtype, chain_checkpoint, caller, want,
                                                  monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", caller)
    assert R.cudnn_deterministic(CUDA, dtype, chain_checkpoint) is want
    assert R.cudnn_deterministic(CPU, dtype, chain_checkpoint) is False
    line = R.algorithms_str(CUDA, want)
    assert line.startswith("cuDNN deterministic" if want else "cuDNN default")
    assert R.algorithms_str(CPU, want) == "cpu (no cuDNN)"


def test_the_block_restores_the_callers_settings(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    with R.cudnn_algorithms(True):
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert not torch.backends.cudnn.deterministic and torch.backends.cudnn.benchmark
    with R.cudnn_algorithms(False):
        assert not torch.backends.cudnn.deterministic and torch.backends.cudnn.benchmark
    with pytest.raises(KeyError), R.cudnn_algorithms(True):
        raise KeyError("a fault inside the run")
    assert not torch.backends.cudnn.deterministic and torch.backends.cudnn.benchmark


@pytest.mark.parametrize("chain_checkpoint", [False, True], ids=["plain", "chain-checkpoint"])
def test_a_run_logs_its_algorithms_and_host_ops(tmp_path, images, chain_checkpoint,  # noqa: F811
                                                monkeypatch):
    """The run header's lines, and the choice made from the run's dtype and
    chain_checkpoint: on the CPU no cuDNN, whatever it asks for."""
    asked = []
    choose = R.cudnn_deterministic
    monkeypatch.setattr(R, "cudnn_deterministic",
                        lambda dev, dtype, ck: asked.append((dev.type, dtype, ck)) or choose(
                            dev, dtype, ck))
    diffusion = dict(sampler="ddim", steps=1000, noise_schedule="linear",
                     model_mean_type="epsilon", model_var_type="learned_range",
                     dynamic_threshold=False, clip_denoised=True, min_max_denoised=False,
                     rescale_timesteps=False, timestep_respacing="ddim2")
    out = R.run_restoration(_config(tmp_path, images, diffusion=diffusion,
                                    chain_checkpoint=chain_checkpoint), device="cpu")
    assert asked == [("cpu", torch.float32, chain_checkpoint)]
    with open(pjoin(out, "log.txt")) as f:
        log = f.read()
    assert "Convolution algorithms: cpu (no cuDNN)\nHost ops: " in log
    assert log.index("Device: ") < log.index("Convolution algorithms: ")
