"""The harness's own tests: on the CPU at a tiny UNet, and (marker ``cuda``)
on a card. Run from the repository's root:

    python -m pytest portbench/tests -q                 # CPU
    python -m pytest portbench/tests -q -m cuda         # on a card
"""

import json
import os
import sys

import pytest

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HOME)
for p in (ROOT, HOME):
    if p not in sys.path:
        sys.path.insert(0, p)

# a UNet small enough for the CPU, with every kind of layer of the real one
TINY = dict(image_size=32, model_channels=32, channel_mult=[1, 2], attention_resolutions=[16],
            num_head_channels=16, num_res_blocks=1)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(scope="session")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda:0"
