"""``BENCHMARK.json`` against the shape the benchmark's table must have: its
keys, names, units and lengths, the files it names, and that every cell's
configuration, traffic mix and metric readers exist under ``portbench/``."""

import json
import os
import re

from conftest import HOME, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_table_shape(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert bench["paths"] == ["portbench"] and bench["command"][1] == "portbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not [k for k in c["reduced"] if k.endswith(("_dim", "_rank", "channels"))]
        names.add(c["name"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and TEXT.match(w["why"])
        assert w["chips"] in (1, 4) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(HOME, "traffic", w["traffic"] + ".json"))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and TEXT.match(m["layer"]) and set(m["workloads"]) <= cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(HOME, "metrics", m["name"] + ".py"))
    all_names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
                 for x in bench[k]]
    assert len(all_names) == len(set(all_names))


def test_configs_as_run(bench):
    for c in bench["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["preset"]["diffusion"]["clip_denoised"] is True
        assert set(cfg["reduced"]) == set(c["reduced"])
        assert cfg["limits"] and all(v > 0 for v in cfg["limits"].values())
