"""Tiny CPU rehearsals of every driver, of the controls and of the faults,
and a cell added as new files only."""

import json
import os

import pytest

from port_bench import harness
from port_bench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = "3000000019"


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(str(tmp_path_factory.mktemp("checkout")))


def _run(checkout, cell, trace="0", seconds="6", module="port_bench.run",
         extra=()):
    rc, line, err = tiny.run(checkout, module, *extra, "--workload", cell,
                             "--seed", SEED, "--seconds", seconds,
                             "--trace", trace)
    assert rc == 0, err[-3000:]
    return line, err


@pytest.mark.parametrize("cell,trace", [
    ("tiny-train", "0"), ("tiny-train", "1"), ("tiny-question", "0"),
    ("tiny-question", "1"), ("tiny-report", "0")])
def test_rehearsal_line(checkout, cell, trace):
    line, err = _run(checkout, cell, trace)
    keys = list(line)
    assert keys[:5] == KEYS
    assert keys[5:] in (["checks"], ["breakdown", "checks"])
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    bench = harness.specification(checkout)
    if trace == "0":
        want = {m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == want
    else:
        # device numbers are never written from a CPU run
        sources = {m["name"]: m["source"] for m in bench["per_layer"]}
        assert all(sources[n].startswith("program")
                   for n in line["metrics"])
    # each compared number beside its limit, as the last lines of stderr
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and "(limit " in t for t in tail)


@pytest.mark.parametrize("cell,probe", [
    ("tiny-train", "control"), ("tiny-train", "state_unchanged"),
    ("tiny-train", "half_batch"), ("tiny-question", "control"),
    ("tiny-question", "token_altered")])
def test_control_and_faults_fail(checkout, cell, probe):
    line, _ = _run(checkout, cell, module="port_bench.probe",
                   extra=("--probe", probe))
    assert line["probe"] == probe
    assert line["correct"] is False, line["checks"]


def test_no_cuda_no_result(checkout):
    env_rc, line, err = tiny.run_without_device(checkout, "tiny-train")
    assert env_rc != 0 and line is None


def test_cell_added_as_new_files(checkout):
    """A throwaway configuration, mix, driver and per-layer metric, each a
    new file plus entries in BENCHMARK.json, run without an edit to any
    file the benchmark has."""
    before = {p: open(os.path.join(checkout, p), "rb").read()
              for p in _files(checkout)}
    bench = json.load(open(os.path.join(checkout, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(checkout, "port_bench", "configs",
                                      "dv-tiny.json")))
    cfg["model"] = dict(cfg["model"], name="dv-tiny2", n_layers=1)
    tiny.write_json(checkout, "port_bench/configs/dv-tiny2.json", cfg)
    bench["configs"].append(dict(bench["configs"][0], name="dv-tiny2",
                                 file="port_bench/configs/dv-tiny2.json"))
    mix = json.load(open(os.path.join(checkout, "port_bench", "traffic",
                                      "tiny-train-b8s2048.json")))
    mix.update(driver="train_again", batch=3, seq=48)
    tiny.write_json(checkout, "port_bench/traffic/throwaway.json", mix)
    with open(os.path.join(checkout, "port_bench", "drivers",
                           "train_again.py"), "w") as fh:
        fh.write("import os\n"
                 "from port_bench.harness import BENCH_DIR, load_module\n"
                 "CHECKS = 'train'\n"
                 "def run(ctx):\n"
                 "    return load_module(os.path.join(BENCH_DIR, 'drivers',"
                 " 'train.py'), 'train_inner').run(ctx)\n")
    with open(os.path.join(checkout, "port_bench", "metrics",
                           "steps.train.py"), "w") as fh:
        fh.write("def read(run):\n"
                 "    return float(run['counters']['steps'])\n")
    tiny.add_cell(bench, "tiny-throwaway", "throwaway", like="tiny-train",
                  config="dv-tiny2")
    bench["per_layer"].append({
        "name": "steps.train", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "model step",
        "moves": "train_tokens_per_s", "workloads": ["tiny-throwaway"]})
    tiny.write_json(checkout, "BENCHMARK.json", bench)
    line, _ = _run(checkout, "tiny-throwaway", trace="1")
    assert line["correct"] is True
    assert line["metrics"]["steps.train"]["value"] > 0
    line, _ = _run(checkout, "tiny-throwaway")
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    for p, data in before.items():
        if p != "BENCHMARK.json":
            assert open(os.path.join(checkout, p), "rb").read() == data, p


def _files(root):
    for d, _, names in os.walk(os.path.join(root, "port_bench")):
        if "cache" in d.split(os.sep) or "__pycache__" in d:
            continue
        for n in names:
            yield os.path.relpath(os.path.join(d, n), root)
