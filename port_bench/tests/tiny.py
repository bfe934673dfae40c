"""A throwaway checkout for the tests: ``port_bench`` copied beside links to
the program and its resources, with a tiny configuration and tiny mixes
added as new files and new entries of ``BENCHMARK.json`` (nothing of the
benchmark's own files is edited), run on the CPU in subprocesses."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

TINY_MODEL = {"name": "dv-tiny", "vocab_size": 16384, "d_model": 256,
              "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "d_ff": 512,
              "head_dim": 64, "rope_theta": 10000.0, "rms_eps": 1e-05,
              "max_seq_len": 2048, "tie_embeddings": True,
              "scale_embeddings": False, "logit_softcap": 0.0}
# set from the tiny cells' CPU readings: sound runs read logit_gap
# 0.026-0.027, the int8 control 0.077-0.083; the training numbers read
# 1e-4-1e-3 sound and over ten times the limits under the control and faults
TINY_LIMITS = {"serve": {"logit_gap": 0.05},
               "train": {"loss_rel": 2e-3, "grad_norm_gap": 0.01,
                         "update_norm_gap": 0.01}}
CELLS = {"tiny-train": "train-b8s2048", "tiny-question": "question-s64",
         "tiny-report": "report-c32"}


def _tiny_mix(name: str) -> dict:
    with open(os.path.join(BENCH, "traffic", name + ".json"),
              encoding="utf-8") as fh:
        mix = json.load(fh)
    if mix["driver"] == "train":
        mix.update(batch=2, seq=64, pool=4, trace_steps=2)
        return mix
    mix["engine"].update(max_slots=4, num_pages=256, warmup=False)
    mix.update(clients=6, settle_seconds=1, trace_seconds=0.5,
               check={"min_tokens": 1024, "max_requests": 64})
    mix["max_tokens"] = [8, 24] if mix["kind"] == "interview" else [16, 48]
    return mix


def make_checkout(root: str) -> str:
    shutil.copytree(BENCH, os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__",
                                                  "tests"))
    for name in ("deepvision_tpu_torch", "resources"):
        os.symlink(os.path.join(REPO, name), os.path.join(root, name))
    with open(os.path.join(REPO, "BENCHMARK.json"), encoding="utf-8") as fh:
        bench = json.load(fh)
    with open(os.path.join(BENCH, "pending.json"), encoding="utf-8") as fh:
        pending = json.load(fh)
    with open(os.path.join(BENCH, "configs", "dv-base.json"),
              encoding="utf-8") as fh:
        cfg = json.load(fh)
    cfg.update(model=TINY_MODEL, limits=TINY_LIMITS)
    write_json(root, "port_bench/configs/dv-tiny.json", cfg)
    bench["configs"].append(dict(bench["configs"][0], name="dv-tiny",
                                 file="port_bench/configs/dv-tiny.json"))
    for cell, mix in CELLS.items():
        write_json(root, f"port_bench/traffic/tiny-{mix}.json",
                   _tiny_mix(mix))
        spec = next(s for s in (bench, pending)
                    if any(w["traffic"] == mix for w in s["workloads"]))
        add_cell(spec, cell, "tiny-" + mix,
                 like=next(w["name"] for w in spec["workloads"]
                           if w["traffic"] == mix))
    write_json(root, "BENCHMARK.json", bench)
    write_json(root, "port_bench/pending.json", pending)
    return root


def add_cell(bench: dict, name: str, traffic: str, like: str,
             config: str = "dv-tiny") -> None:
    """A new cell that reports what the cell ``like`` reports (``bench``:
    BENCHMARK.json's or pending.json's entries)."""
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a tiny cell of the tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)


def write_json(root: str, rel: str, obj) -> None:
    with open(os.path.join(root, rel), "w", encoding="utf-8") as fh:
        json.dump(obj, fh, ensure_ascii=False, indent=1)


def run(root: str, module: str, *args: str, timeout: int = 600):
    """``python -m <module> <args> --device cpu`` in the checkout; returns
    (exit code, the last line of stdout as JSON or None, stderr)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", module, *args, "--device", "cpu"], cwd=root,
        env=env, capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, line, proc.stderr


def run_without_device(root: str, cell: str):
    """A run as the driver makes it (no ``--device``) on a machine with no
    CUDA: it must exit with an error and print no result."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", cell,
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
        env=env, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, (lines[-1] if lines else None), proc.stderr
