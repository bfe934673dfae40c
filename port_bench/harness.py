"""What every cell shares: the specification read from ``BENCHMARK.json``,
the files found by name under ``port_bench/``, the device trace of a
``--trace 1`` run and the result line.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``); the mix names its driver
(``drivers/<driver>.py``); each per-layer metric is a reader of its own
(``metrics/<metric>.py``).  Nothing here imports the program or JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "deepvision_tpu")


class SpecError(RuntimeError):
    """The cell, its files or the device do not fit the specification."""


def process_age_s() -> float:
    """Seconds since this process started (``/proc``; 10 ms ticks)."""
    with open("/proc/self/stat", encoding="ascii") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime", encoding="ascii") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: str):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """A driver or metric file as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise SpecError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def specification(root: str) -> dict:
    """``BENCHMARK.json`` with the cells and metrics of
    ``port_bench/pending.json`` added: cells that run but that no bound
    holds yet."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    pending_path = os.path.join(root, "port_bench", "pending.json")
    if os.path.isfile(pending_path):
        pending = load_json(pending_path)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + pending.get(key, [])
    return bench


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, root: str, name: str):
        self.root = root
        bench = specification(root)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SpecError(f"unknown workload {name!r}; known: "
                            f"{sorted(cells)}")
        self.spec = cells[name]
        self.name = name
        self.chips = int(self.spec["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.spec["config"]]
        self.config = load_json(os.path.join(root,
                                             self.config_entry["file"]))
        self.traffic = load_json(os.path.join(
            BENCH_DIR, "traffic", self.spec["traffic"] + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"]
                          if self._reports_layer(m)]

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def _reports_layer(self, metric: dict) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return metric["moves"] in {m["name"] for m in self.end_to_end}

    @property
    def driver_path(self) -> str:
        return os.path.join(BENCH_DIR, "drivers",
                            self.traffic["driver"] + ".py")

    def driver(self):
        return load_module(self.driver_path,
                           "port_bench_driver_" + self.traffic["driver"])

    def metric_reader(self, name: str):
        return load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                           "port_bench_metric_" + name.replace(".", "_"))


# ---------------------------------------------------------------------------
# Device trace of a --trace 1 run
# ---------------------------------------------------------------------------

def busy_and_gaps(intervals):
    """The length of the union of ``(start, end, ...)`` intervals, and the
    gaps between them as ``(length, start, end)``."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, *_ in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


# ---------------------------------------------------------------------------
# The profiler
# ---------------------------------------------------------------------------

class DeviceTrace:
    """``torch.profiler`` over one slice of the window, started and stopped
    between two calls of the timed path so that the slice holds whole
    calls; :meth:`summary` reduces it to kernel times, the device's busy
    time (union of kernel and copy intervals) and the longest idle gaps,
    each named by the host's innermost torch op at its middle."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.prof = None
        self.t0 = self.t1 = None
        self.done = False

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.t0 = time.monotonic()

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def _sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.monotonic()
        self.prof.__exit__(None, None, None)
        self.done = True

    def summary(self) -> dict:
        from torch.autograd import DeviceType

        kernels, host = [], []
        events = self.prof.events()
        # a record_function range shows on the device's timeline too
        annotations = {e.name for e in events
                       if e.device_type == DeviceType.CPU
                       and getattr(e, "is_user_annotation", False)}
        annotations.update(("runner.decode", "runner.prefill_batch",
                            "runner.prefill"))
        for e in events:
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False) and \
                        e.name not in annotations:
                    kernels.append((tr.start, tr.end, e.name))
            elif e.device_type == DeviceType.CPU:
                host.append((tr.start, tr.end, e.name))
        busy_us, gaps = busy_and_gaps(kernels)
        by_name: dict = {}
        count: dict = {}
        for s, e, name in kernels:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
            count[name] = count.get(name, 0) + 1
        gaps.sort(reverse=True)
        idle = []
        for dur, a, b in gaps[:10]:
            mid = (a + b) / 2
            inner = [(e - s, name) for s, e, name in host if s <= mid <= e]
            label = min(inner)[1] if inner else "python (no torch op)"
            idle.append([label, dur / 1e6])
        return {
            "window_s": self.t1 - self.t0,
            "busy_s": busy_us / 1e6,
            "kernel_s": by_name,
            "kernel_n": count,
            "n_kernels": len(kernels),
            "idle_gaps": idle,
        }


# ---------------------------------------------------------------------------
# Result line
# ---------------------------------------------------------------------------

def forbidden_loaded() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out, ensure_ascii=False)
