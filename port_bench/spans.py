"""The program's spans in a profiled slice: each device kernel put down to
the span that launched it, and the slice's device idle time to the span
open on the host.

The port marks the phases of its training step and scheduler step with
``train.*`` and ``sched.*`` ranges (``deepvision_tpu_torch/engine/
spans.py``), recorded while a ``torch.profiler`` runs.  :func:`account`
reduces a profiler's ``events()`` to:

- ``spans``: for each span name, ``n`` ranges, ``host_s`` (their host
  time), ``host_self_s`` (host time less the part their child spans on the
  same thread cover), ``kernel_n`` and ``device_s``: the union of the
  device intervals of the kernels and copies launched inside a range of
  that name, its child spans' included; ``device_self_s`` counts only the
  kernels whose innermost span it is.  A kernel's launch is the CUDA
  runtime call that shares its correlation id; the kernel counts for every span whose
  host interval holds the launch's start, on any thread, so backward
  kernels launched by autograd's thread fall in ``train.backward``, and a
  kernel that runs after its span closed on the host still counts for it.
  Kernels launched in no span go under ``"(none)"``.
- ``idle_by_span``: the device's idle gaps between kernels, in seconds,
  by the innermost span open on the host at each gap's middle.

:func:`step_ms` turns a span's ``device_s`` into milliseconds per traced
step.  ``harness.DeviceTrace.summary`` does not call :func:`account` yet;
run a cell with the account added:

    python3 -m port_bench.spans --workload <cell> --seed <n> \\
        --seconds <s> [--spans off] [--set trace_steps=16] [--device cpu]

It prints the cell's ``--trace 1`` result line with ``"spans"``,
``"idle_by_span"`` and ``"step_ms"`` added.  ``--spans off`` forces every
span to the program's no-op while the profiler runs, which measures what
the spans cost when on.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

from port_bench import harness

PREFIXES = ("train.", "sched.")
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")
NONE = "(none)"
# the four splits of a training step (ms of device time per traced step)
TRAIN_SPLITS = {"forward": ("train.forward",), "loss": ("train.loss",),
                "backward": ("train.backward",),
                "optimizer": ("train.clip", "train.optimizer")}


def _device(e) -> bool:
    return e.device_type.name == "CUDA"


def _cpu(e) -> bool:
    return e.device_type.name == "CPU"


def _annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False))


def kernels(events) -> list:
    """The device's kernels and copies, as ``harness.DeviceTrace.summary``
    counts them: device events that are no record_function range."""
    names = {e.name for e in events if _cpu(e) and _annotation(e)}
    names.update(("runner.decode", "runner.prefill_batch", "runner.prefill"))
    return [e for e in events
            if _device(e) and not _annotation(e) and e.name not in names]


def program_spans(events) -> list:
    """The program's ``train.*`` and ``sched.*`` ranges on the host."""
    return [e for e in events if _cpu(e) and e.name.startswith(PREFIXES)]


def launch_times(events, device_events) -> list:
    """Each device event's launch start on the host (None if unknown): the
    CUDA API call (``cudaLaunchKernel``, ``cuLaunchKernel``,
    ``cudaMemcpyAsync``, ...) whose correlation id is the device event's."""
    runtime = {e.id: e.time_range.start for e in events
               if _cpu(e) and RUNTIME_CALL.match(e.name)}
    return [runtime.get(k.id) for k in device_events]


def _open_at(times, ranges):
    """For each time, the indices of the ``(start, end)`` ranges that hold
    it (the ranges in any order)."""
    order = sorted(range(len(ranges)), key=lambda i: ranges[i][0])
    result = [()] * len(times)
    active, j = [], 0
    for t, i in sorted((t, i) for i, t in enumerate(times) if t is not None):
        while j < len(order) and ranges[order[j]][0] <= t:
            active.append(order[j])
            j += 1
        active = [r for r in active if ranges[r][1] >= t]
        result[i] = tuple(active)
    return result


def _self_times(spans) -> list:
    """Each span's host time less its direct children's on its thread."""
    own = [s.time_range.end - s.time_range.start for s in spans]
    by_thread: dict = {}
    for i, s in enumerate(spans):
        by_thread.setdefault(s.thread, []).append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (spans[i].time_range.start,
                                -spans[i].time_range.end))
        stack = []
        for i in idx:
            tr = spans[i].time_range
            while stack and spans[stack[-1]].time_range.end < tr.end:
                stack.pop()
            if stack:
                own[stack[-1]] -= tr.end - tr.start
            stack.append(i)
    return own


def _innermost(held, ranges):
    """The shortest of the ranges ``held`` (None if there are none)."""
    if not held:
        return None
    return min(held, key=lambda r: ranges[r][1] - ranges[r][0])


def attribute(events):
    """``(spans, [(kernel, launch start, names of the spans holding the
    launch, name of the innermost)])`` of one profiled slice; a kernel in
    no span has no names and the innermost ``"(none)"``."""
    events = list(events)
    spans = program_spans(events)
    ranges = [(s.time_range.start, s.time_range.end) for s in spans]
    ks = kernels(events)
    launches = launch_times(events, ks)
    tied = []
    for k, t, held in zip(ks, launches, _open_at(launches, ranges)):
        inner = _innermost(held, ranges)
        tied.append((k, t, {spans[r].name for r in held},
                     NONE if inner is None else spans[inner].name))
    return spans, tied


def account(events) -> dict:
    """``{"spans": ..., "idle_by_span": ...}`` of one profiled slice (see
    the module's docstring); times in seconds."""
    spans, tied = attribute(events)
    ranges = [(s.time_range.start, s.time_range.end) for s in spans]
    out: dict = {}
    for s, self_us in zip(spans, _self_times(spans)):
        row = out.setdefault(s.name, {"n": 0, "host_s": 0.0,
                                      "host_self_s": 0.0, "kernel_n": 0,
                                      "device_s": 0.0, "device_self_s": 0.0})
        row["n"] += 1
        row["host_s"] += (s.time_range.end - s.time_range.start) / 1e6
        row["host_self_s"] += self_us / 1e6
    inside: dict = {}
    own: dict = {}
    for k, _, names, inner in tied:
        iv = (k.time_range.start, k.time_range.end)
        for name in names or (NONE,):
            inside.setdefault(name, []).append(iv)
        own.setdefault(inner, []).append(iv)
    for name, ivs in inside.items():
        row = out.setdefault(name, {"kernel_n": 0, "device_s": 0.0,
                                    "device_self_s": 0.0})
        row["kernel_n"] = len(ivs)
        row["device_s"] = harness.busy_and_gaps(ivs)[0] / 1e6
    for name, ivs in own.items():
        out[name]["device_self_s"] = harness.busy_and_gaps(ivs)[0] / 1e6
    _, gaps = harness.busy_and_gaps(
        [(k.time_range.start, k.time_range.end) for k, *_ in tied])
    mids = [(a + b) / 2 for _, a, b in gaps]
    idle: dict = {}
    for (dur, _, _), held in zip(gaps, _open_at(mids, ranges)):
        inner = _innermost(held, ranges)
        label = NONE if inner is None else spans[inner].name
        idle[label] = idle.get(label, 0.0) + dur / 1e6
    return {"spans": out, "idle_by_span": idle}


def step_ms(spans: dict, names, steps: int):
    """Device ms per step of the spans ``names`` (None where none ran)."""
    rows = [spans[n] for n in names if n in spans]
    if not rows or steps <= 0:
        return None
    return 1e3 * sum(r["device_s"] for r in rows) / steps


# ---------------------------------------------------------------------------
# A cell's --trace 1 run with the account added
# ---------------------------------------------------------------------------

def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spans", choices=("on", "off"), default="on")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=JSON", help="a value of the traffic mix")
    return ap.parse_known_args(argv)


def main(argv=None) -> int:
    from port_bench import run as bench_run

    args, rest = _parse(argv)
    overrides = {}
    for item in args.set:
        key, value = item.split("=", 1)
        overrides[key] = json.loads(value)
    if args.spans == "off":
        from deepvision_tpu_torch.engine import spans as program

        program.recording = lambda: False
    summary, traced = harness.DeviceTrace.summary, {}

    def summary_with_spans(self):
        traced.update(summary(self), **account(self.prof.events()))
        return dict(traced)

    harness.DeviceTrace.summary = summary_with_spans
    try:
        out = bench_run.execute(rest + ["--trace", "1"],
                                traffic_overrides=overrides)
        cell = harness.Cell(bench_run.ROOT, bench_run.parse(
            rest + ["--trace", "1"]).workload)
    except harness.SpecError as e:
        print(f"port_bench.spans: {e}", file=sys.stderr)
        return 2
    out = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                               "device", "breakdown", "checks")}
    out.update(spans_mode=args.spans, spans=traced["spans"],
               idle_by_span=traced["idle_by_span"])
    steps = dict(cell.traffic, **overrides).get("trace_steps", 0)
    if cell.traffic["driver"] == "train" and steps:
        out["step_ms"] = dict(
            window=1e3 * traced["window_s"] / steps,
            busy=1e3 * traced["busy_s"] / steps,
            kernel_n=traced["n_kernels"] / steps,
            **{k: step_ms(traced["spans"], v, steps)
               for k, v in TRAIN_SPLITS.items()})
    print(json.dumps(out, ensure_ascii=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
