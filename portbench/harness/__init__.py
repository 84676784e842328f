"""The benchmark harness: program set-up, traffic, the window, the trace."""

import importlib.util
import os
import sys


def load(home: str, sub: str, name: str):
    """The module ``<home>/<sub>/<name>.py``, loaded by its path: a cell's
    family and metric readers are files found by the names that
    ``BENCHMARK.json`` and the configuration give, in the run's home. The
    module is registered under ``portbench_<sub>_<name>`` so that its
    dataclasses can resolve their annotations."""
    key = f"portbench_{sub}_{name}"
    spec = importlib.util.spec_from_file_location(key, os.path.join(home, sub, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
