"""Run one cell of the benchmark once.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic
mix, its driver and its per-layer metrics are found by name from
``BENCHMARK.json``.  With ``--trace 0`` the result's metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiled slice of the window.  The last line of standard output is
the result; the numbers compared with the reference, each beside its
limit, are the last lines of standard error and the result's last key.

``--device cpu`` rehearses a cell on the CPU (the tests do, at a tiny
size); a result from it names the CPU and no device metric is measured.
"""

from __future__ import annotations

import argparse
import os
import sys

from port_bench import harness

ROOT = os.path.dirname(harness.BENCH_DIR)


class Context:
    """What a driver is given: the cell's files and the run's settings.
    ``engine_overrides`` and ``plant`` are empty except where a probe
    (``port_bench/probe.py``) runs the control or plants a fault."""

    def __init__(self, cell: harness.Cell, driver, args, *,
                 engine_overrides=None, plant=None):
        self.root = cell.root
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        # a configuration's limits, by the kind of comparison the driver
        # makes
        self.limits = cell.config["limits"][driver.CHECKS]
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.device = args.device
        self.engine_overrides = engine_overrides or {}
        self._plant = plant
        self.marks = [("imports and device", harness.process_age_s())]

    def mark(self, name: str) -> None:
        """Set-up's steps, by the process age at their end (on stderr)."""
        self.marks.append((name, harness.process_age_s()))

    def plant(self, system) -> None:
        if self._plant is not None:
            self._plant(system)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def _environment(root: str) -> None:
    """Caches inside the checkout, at fixed paths; no JAX behind a
    library's back."""
    cache = os.path.join(root, "port_bench", "cache")
    os.environ["DV_DFA_CACHE_DIR"] = os.path.join(cache, "dfa")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _device(args, chips: int) -> dict:
    import torch

    if args.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    if not torch.cuda.is_available():
        raise harness.SpecError("CUDA is not available")
    if torch.cuda.device_count() < chips:
        raise harness.SpecError(f"the cell asks for {chips} cards, "
                                f"{torch.cuda.device_count()} present")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def execute(argv=None, *, engine_overrides=None, plant=None,
            traffic_overrides=None) -> dict:
    """One run; returns the result's fields (see :func:`main`)."""
    args = parse(argv)
    _environment(ROOT)
    cell = harness.Cell(ROOT, args.workload)
    cell.traffic.update(traffic_overrides or {})
    device = _device(args, cell.chips)
    driver = cell.driver()
    ctx = Context(cell, driver, args, engine_overrides=engine_overrides,
                  plant=plant)
    record = driver.run(ctx)
    print("set-up: " + ", ".join(f"{n} {t:.2f} s" for n, t in ctx.marks),
          file=sys.stderr)
    record["config"] = cell.config["model"]
    record["traffic"] = cell.traffic
    device["memory_peak_bytes"] = int(record["memory_peak_bytes"])
    metrics, breakdown = {}, None
    if ctx.trace:
        t = record["trace"]
        if t is None:
            raise harness.SpecError("the traced slice never closed: the "
                                    "window is shorter than its offset and "
                                    "length")
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        for m in cell.per_layer:
            if args.device == "cpu" and m["source"] in ("device_trace",
                                                        "host_clock"):
                continue   # no device number from a CPU run
            value = cell.metric_reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        top = sorted(t["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [[k[:120], v] for k, v in top],
                     "idle_gaps": t["idle_gaps"]}
    else:
        values = dict(record["e2e"], setup_s=record["setup_s"])
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    checks = record["checks"]
    correct = all(c["value"] is not None and c["limit"] is not None
                  and c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "attempted": record["attempted"],
            "failed": record["failed"], "metrics": metrics,
            "device": device, "checks": checks, "breakdown": breakdown}


def main(argv=None) -> int:
    try:
        out = execute(argv)
    except harness.SpecError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"port_bench: the process holds {loaded} after the window",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(**out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
