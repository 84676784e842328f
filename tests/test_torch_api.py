"""The port's lazy top-level API, that of ``osmosis_tpu/__init__.py``: each
name resolves to the port's object at first use, and importing the package
alone loads none of its pipelines."""

import subprocess
import sys

import pytest

NAMES = {
    "run_restoration": "osmosis_tpu_torch.pipelines.restore",
    "run_prior_sampling": "osmosis_tpu_torch.pipelines.prior",
    "UNetModel": "osmosis_tpu_torch.models.unet",
    "UNetConfig": "osmosis_tpu_torch.models.unet",
    "unet_config_from_yaml": "osmosis_tpu_torch.models.unet",
    "make_schedule": "osmosis_tpu_torch.diffusion.schedules",
    "SamplerConfig": "osmosis_tpu_torch.diffusion.sampler",
    "sample_loop": "osmosis_tpu_torch.diffusion.sampler",
    "GuidanceConfig": "osmosis_tpu_torch.diffusion.guided",
    "guided_sample_loop": "osmosis_tpu_torch.diffusion.guided",
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_name_resolves_to_the_port_object(name):
    import importlib

    import osmosis_tpu
    import osmosis_tpu_torch

    obj = getattr(osmosis_tpu_torch, name)
    assert obj is getattr(importlib.import_module(NAMES[name]), name)
    assert obj.__module__.startswith("osmosis_tpu_torch.")
    assert hasattr(osmosis_tpu, "__getattr__")  # the JAX package has the same names


def test_unknown_name_raises_attribute_error():
    import osmosis_tpu_torch

    with pytest.raises(AttributeError, match="no_such_name"):
        osmosis_tpu_torch.no_such_name  # noqa: B018
    assert not hasattr(osmosis_tpu_torch, "pipelines_typo")


def test_import_alone_loads_no_pipeline():
    code = ("import sys, osmosis_tpu_torch\n"
            "print(sorted(m for m in sys.modules if m.startswith('osmosis_tpu_torch.')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert out.strip() == "[]"
