"""The port's run logger against ``osmosis_tpu.utils.logging``: for the same
calls, with ``time.time`` pinned in both modules, the same files with the
same bytes (tfevents included), under the same rank-suffixed names, and the
same module-level ``configure`` / ``get_current`` / ``log``."""

import os

import pytest

from osmosis_tpu.utils import logging as J
from osmosis_tpu_torch.utils import logging as L

ROWS = [{"loss": 0.5, "note": "not-a-number", "step": 1},
        {"loss": 0.25, "phi_a_0": 1.1, "step": 2},  # the schema grows
        {"phi_a_0": 0.9}]  # a row without the first keys


@pytest.fixture()
def pinned_time(monkeypatch):
    """``time.time`` in both modules reads one clock; the fixture's value
    restarts it, so each run reads the same times."""
    state = {"k": 0}

    def fake():
        state["k"] += 1
        return 1_700_000_000.0 + 0.125 * state["k"]

    for mod in (J, L):
        monkeypatch.setattr(mod.time, "time", fake)
    return lambda: state.update(k=0)


def _tree(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _drive(mod, root, **kw):
    lg = mod.RunLogger(str(root), **kw)
    lg.log("first line", 1, 2.5)
    for row in ROWS:
        for k, v in row.items():
            lg.logkv(k, v)
        lg.dumpkvs()
    lg.log("last line")
    lg.close()
    return _tree(str(root))


FORMATS = [None, ("log", "csv"), ("json",), ("stdout", "log", "json", "csv", "tensorboard"),
           ("tensorboard",)]


@pytest.mark.parametrize("suffix", ["", "-rank001"])
@pytest.mark.parametrize("formats", FORMATS, ids=lambda f: "default" if f is None else "+".join(f))
def test_run_logger_writes_the_jax_files(tmp_path, pinned_time, capsys, formats, suffix):
    pinned_time()
    want = _drive(J, tmp_path / "jax", format_strs=formats, rank_suffix=suffix)
    jax_out = capsys.readouterr().out
    pinned_time()
    got = _drive(L, tmp_path / "port", format_strs=formats, rank_suffix=suffix)
    assert capsys.readouterr().out == jax_out
    assert sorted(got) == sorted(want) and got == want
    names = {n.split(os.sep)[0] for n in got}
    fmts = ("stdout", "log", "json", "csv") if formats is None else formats
    expect = {f"log{suffix}.txt": "log", f"progress{suffix}.json": "json",
              f"progress{suffix}.csv": "csv", f"tb{suffix}": "tensorboard"}
    assert names == {n for n, f in expect.items() if f in fmts}
    if "csv" in fmts:  # schema growth: the wider header, old rows padded
        lines = got[f"progress{suffix}.csv"].decode().splitlines()
        assert lines[0] == "loss,note,step,_time,phi_a_0"
        assert [ln.count(",") for ln in lines] == [4] * 4
        assert lines[3].startswith(",,,") and lines[3].endswith(",0.9")


def test_tensorboard_writer_bytes(tmp_path, pinned_time):
    rows = [{"a": 1, "b": -2.5e-3, "skip": "x"}, {"long/tag/" * 20: 3.0}, {"skip": None}, {"c": 7}]
    out = {}
    for name, mod in (("jax", J), ("port", L)):
        pinned_time()
        w = mod.TensorBoardWriter(str(tmp_path / name))
        for r in rows:
            w.writekvs(r)
        assert w.step == 4  # the row with no number wrote no event
        w.close()
        out[name] = _tree(str(tmp_path / name))
    assert len(out["port"]) == 1 and out["port"] == out["jax"]


def test_tb_helpers_match():
    for n in (0, 1, 127, 128, 300, 2 ** 21, 2 ** 35 + 3):
        assert L._tb_varint(n) == J._tb_varint(n)
    for data in (b"", b"abc", bytes(range(256))):
        assert L._tb_masked_crc(data) == J._tb_masked_crc(data)
    assert L._tb_field(5, 2, b"xy") == J._tb_field(5, 2, b"xy")


def test_configure_get_current_and_log(tmp_path, monkeypatch, capsys):
    for mod, name in ((J, "jax"), (L, "port")):
        monkeypatch.setattr(mod, "_CURRENT", None)
        first = mod.get_current()
        assert first.dir is None and mod.get_current() is first  # stdout only, kept
        mod.log("to stdout", 3)
        lg = mod.configure(str(tmp_path / name), format_strs=("log",), rank_suffix="-rank002")
        assert mod.get_current() is lg
        mod.log("to the file")
        lg.close()
    out = capsys.readouterr().out
    assert out == "to stdout 3\n" * 2
    for name in ("jax", "port"):
        assert os.listdir(tmp_path / name) == ["log-rank002.txt"]
        assert (tmp_path / name / "log-rank002.txt").read_text() == "to the file\n"
