"""Every file the benchmark names exists and loads, every configuration,
mix, driver and metric file is named (in BENCHMARK.json or, for the cells
no bound holds yet, in pending.json), and BENCHMARK.json keeps to the
limits of its contract."""

import json
import os
import re

import pytest

from port_bench import harness

ROOT = os.path.dirname(harness.BENCH_DIR)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
SPEC = harness.specification(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _stems(sub):
    return {f[:-len(ext)] for f in os.listdir(os.path.join(harness.BENCH_DIR,
                                                           sub))
            for ext in (".json", ".py") if f.endswith(ext)}


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_pending_adds_no_bound():
    pending = json.load(open(os.path.join(harness.BENCH_DIR,
                                          "pending.json")))
    assert all("bound" not in m for m in pending["end_to_end"])
    names = [x["name"] for k in ("workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_loads(cell):
    c = harness.Cell(ROOT, cell)
    assert os.path.isfile(c.driver_path)
    limits = c.config["limits"][c.driver().CHECKS]
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(c.metric_reader(m["name"]).read)
    assert limits and all(v is not None for v in limits.values())


def test_every_file_is_named():
    assert _stems("configs") == {c["name"] for c in SPEC["configs"]}
    assert _stems("traffic") == {w["traffic"] for w in SPEC["workloads"]}
    assert _stems("metrics") == {m["name"] for m in SPEC["per_layer"]}
    drivers = {json.load(open(os.path.join(harness.BENCH_DIR, "traffic",
                                           t + ".json")))["driver"]
               for t in _stems("traffic")}
    assert _stems("drivers") == drivers
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert c["reduced"] == cfg["reduced"]
        assert os.path.isfile(os.path.join(ROOT, cfg["tokenizer"]))
