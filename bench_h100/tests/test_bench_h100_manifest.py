"""BENCHMARK.json and the data files it names: every file parses, every
cell resolves to a configuration, a traffic mix and its limits, every
per-layer metric to a reader that declares what BENCHMARK.json says of it,
and the manifest keeps the format's rules."""

import json
import re

import pytest

from bench_h100 import harness

ROOT = harness.ROOT
BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
PL_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert len({w["name"] for w in BENCH["workloads"]}) == \
        len(BENCH["workloads"])
    metric_names = [m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_metrics_follow_the_format():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= E2E_KEYS and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= PL_KEYS and UNIT.match(m["unit"])
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_resolves(w):
    c = harness.cell(w["name"])
    assert w["name"].startswith(w["config"] + ".")
    assert c["traffic"]["kind"] in harness.KINDS
    assert w["chips"] == 1
    assert len(w["why"]) <= 200
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
    assert c["limits"], "every cell has limits"
    assert all(v >= 0 for v in c["limits"].values())


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_file(conf):
    path = ROOT / conf["file"]
    assert path.is_file() and conf["file"].startswith("bench_h100/")
    data = json.loads(path.read_text())
    assert data["name"] == conf["name"]
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"] == []
    assert data["reference"] in ("nerf", "sinerf")
    assert data["model"]["d_filter"] == 256 and data["model"]["n_layers"] == 8
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_reader_declares_its_entry(m):
    mod = harness.reader(m["name"])
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        m["layer"], m["unit"], m["source"], m["moves"])
    assert callable(mod.read)
    assert mod.read({"kind": "none"}) is None


def test_every_data_file_parses():
    for sub in ("configs", "traffic", "limits"):
        files = sorted((ROOT / "bench_h100" / sub).glob("*.json"))
        assert files
        for f in files:
            json.loads(f.read_text())


def test_run_seconds_fit_a_full_check():
    # a full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s,
    # 2 x 90 s to compile a cell, 1200 s spare, within 43200 s
    r = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200
