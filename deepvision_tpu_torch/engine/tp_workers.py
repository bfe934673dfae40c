"""The worker ranks of a tensor-parallel engine.

``LLMEngine(EngineConfig(tp=n))`` keeps one entry point: its process is
rank 0 and owns the tokenizer, the scheduler and a runner on its shard.
On ``start()`` it spawns ``n - 1`` workers (:class:`TPWorkers`, start
method ``spawn``).  Each builds its own shard from the same checkpoint or
seed (no weights cross a process boundary), a runner on it, and joins the
gloo group (``parallel.TPGroup``) of the step collectives.

Control plane: one ``multiprocessing`` pipe per worker.  Rank 0's runner
sends every step's host inputs down the pipes before it runs the step
(``ModelRunner._mirror``); a worker runs the same step on its runner, and
the ranks meet in the step's collectives.  The pipes carry small pickled
messages: ops and numpy arrays, never tensors.  A worker replies only when
asked (its launch counts) or when it fails.

Lifetime: ``stop()`` ends the workers (a ``stop`` message, a join with a
timeout, then terminate and kill).  A worker also ends when the engine's
process dies: its pipe then reads end-of-file, and a collective with a
vanished peer raises.  The workers are daemonic, so an interpreter that
exits normally ends them too.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import tempfile
import threading
import time
import traceback
from typing import List, Optional

import torch

from deepvision_tpu_torch.engine.kernels.flash_attention import (
    flash_attention,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from deepvision_tpu_torch.engine.kernels.paged_attention import (
    paged_attention,
    paged_attention_update,
)
from deepvision_tpu_torch.engine.kernels.paged_chunk import (
    paged_chunk_attention,
)

# How long rank 0 waits for a worker: to build its shard (load weights,
# build the kernel library) and to answer a request, and to end after a
# stop message before it is terminated.
BUILD_TIMEOUT_S = 600.0
REPLY_TIMEOUT_S = 30.0
JOIN_TIMEOUT_S = 10.0

# (name, wrapper, attribute) of every launch counter of the kernels
COUNTERS = (
    ("paged_attention_update", paged_attention_update, "launches"),
    ("paged_attention_update.bkv", paged_attention_update, "bkv_launches"),
    ("flash_attention", flash_attention, "launches"),
    ("paged_chunk_attention", paged_chunk_attention, "launches"),
    ("paged_attention", paged_attention, "launches"),
    ("flash_bwd_dq", flash_bwd_dq, "launches"),
    ("flash_bwd_dkv", flash_bwd_dkv, "launches"),
)


def launch_counts() -> dict:
    """This process's kernel launch counters."""
    return {name: getattr(fn, attr) for name, fn, attr in COUNTERS}


def add_launches(counts: dict) -> None:
    """Add ``counts`` to this process's counters."""
    for name, fn, attr in COUNTERS:
        setattr(fn, attr, getattr(fn, attr) + counts.get(name, 0))


def rank_device(device: torch.device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % device_count)`` on CUDA (one
    card runs every rank), the CPU otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


class WorkerError(RuntimeError):
    """A worker rank failed; the message holds its traceback."""


class TPWorkers:
    """Rank 0's handle on ranks ``1 .. size - 1``.

    ``spec`` is what a worker needs to build its runner (see
    :func:`worker_main`); ``store_path`` the rendezvous file of the
    group, in a directory this object makes and removes.
    """

    def __init__(self, spec: dict, size: int):
        self.dir = tempfile.mkdtemp(prefix="dv_tp_")
        self.store_path = os.path.join(self.dir, "rendezvous")
        self._lock = threading.Lock()
        self._seen: List[dict] = []
        self.devices: List[str] = []      # each worker's device
        self.boot_s: List[dict] = []      # each worker's boot, by stage
        ctx = multiprocessing.get_context("spawn")
        self._conns, self._procs = [], []
        try:
            for rank in range(1, size):
                here, there = ctx.Pipe()
                proc = ctx.Process(
                    target=worker_main, name=f"dv-tp-rank{rank}",
                    args=(there, dict(spec, rank=rank, size=size,
                                      store_path=self.store_path,
                                      spawned_at=time.time())),
                    daemon=True)
                proc.start()
                there.close()
                self._conns.append(here)
                self._procs.append(proc)
                self._seen.append({})
        except BaseException:
            self.stop()
            raise

    def wait_built(self, timeout: float = BUILD_TIMEOUT_S) -> None:
        """Wait until every worker has built its runner (then it joins the
        group)."""
        built = [self._expect(conn, rank, "built", timeout)
                 for rank, conn in enumerate(self._conns, 1)]
        self.devices = [b["device"] for b in built]
        self.boot_s = [b["seconds"] for b in built]

    def _expect(self, conn, rank: int, kind: str, timeout: float):
        if not conn.poll(timeout):
            raise WorkerError(f"TP rank {rank}: no {kind!r} within "
                              f"{timeout:.0f}s")
        try:
            got, payload = conn.recv()
        except EOFError:
            raise WorkerError(f"TP rank {rank} exited") from None
        if got == "error":
            raise WorkerError(f"TP rank {rank} failed:\n{payload}")
        if got != kind:
            raise WorkerError(f"TP rank {rank}: {got!r} where {kind!r} was "
                              "expected")
        return payload

    def send(self, op: str, kw: dict) -> None:
        """Send one step to every worker."""
        with self._lock:
            for rank, conn in enumerate(self._conns, 1):
                try:
                    conn.send((op, kw))
                except OSError as e:
                    raise WorkerError(f"TP rank {rank} is gone: {e}") from e

    def collect_launches(self) -> List[dict]:
        """Each worker's kernel launch counts.  The launches a worker made
        since the last call are added to this process's counters, so the
        kernels' ``.launches`` here count every rank's launches."""
        with self._lock:
            counts = []
            for i, conn in enumerate(self._conns):
                conn.send(("launches", None))
                now = self._expect(conn, i + 1, "launches", REPLY_TIMEOUT_S)
                add_launches({k: v - self._seen[i].get(k, 0)
                              for k, v in now.items()})
                self._seen[i] = now
                counts.append(now)
        return counts

    def stop(self) -> None:
        """End the workers and remove the rendezvous directory."""
        for conn in self._conns:
            try:
                conn.send(("stop", None))
            except OSError:
                pass
        for proc in self._procs:
            proc.join(JOIN_TIMEOUT_S)
            if proc.is_alive():
                proc.terminate()
                proc.join(JOIN_TIMEOUT_S)
            if proc.is_alive():
                proc.kill()
                proc.join(JOIN_TIMEOUT_S)
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        shutil.rmtree(self.dir, ignore_errors=True)


def build_runner(spec: dict, device: torch.device, rank: int):
    """A worker rank's runner: the weights loaded as rank 0 loaded them
    (``load_or_init`` of the same checkpoint or seed), quantized as there,
    cut to the rank's shard."""
    from deepvision_tpu_torch.engine.parallel import shard_params
    from deepvision_tpu_torch.engine.quant import quantize_params
    from deepvision_tpu_torch.engine.runner import ModelRunner
    from deepvision_tpu_torch.engine.weights import load_or_init

    model_cfg, plan = spec["model_cfg"], spec["plan"]
    params = load_or_init(model_cfg, spec["checkpoint_dir"], spec["seed"],
                          device=device)
    if spec["quantize"] == "int8":
        params = quantize_params(params)
    params = shard_params(params, plan, model_cfg, rank)
    return ModelRunner(model_cfg, spec["cache_cfg"], params, device=device,
                       plan=plan, rank=rank, **spec["runner_kw"])


def worker_main(conn, spec: dict) -> None:
    """A worker rank's process: build the runner, join the group, then run
    the steps rank 0 sends until it says stop or goes away."""
    from deepvision_tpu_torch.engine.parallel import TPGroup

    rank, size = spec["rank"], spec["size"]
    t0 = time.monotonic()
    seconds = {"start": time.time() - spec["spawned_at"]}
    try:
        device = rank_device(spec["device"], rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.empty(1, device=device)
            from deepvision_tpu_torch.engine.kernels import _build

            _build.library()    # built by rank 0 before it spawned us
        seconds["device"] = time.monotonic() - t0
        runner = build_runner(spec, device, rank)
        seconds["runner"] = time.monotonic() - t0 - seconds["device"]
        # one thread from here on: the rank's work is the card's, or in
        # tests a small CPU model beside other ranks and test workers
        torch.set_num_threads(1)
        conn.send(("built", {"device": str(device), "seconds": seconds}))
        runner.group = TPGroup.join(spec["store_path"], rank, size, device)
        while True:
            try:
                op, kw = conn.recv()
            except EOFError:
                return          # the engine's process is gone
            if op == "stop":
                return
            if op == "launches":
                conn.send(("launches", launch_counts()))
                continue
            getattr(runner, op)(**kw)
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
        raise


def start_workers(spec: dict, size: int,
                  build_first: Optional[torch.device] = None) -> TPWorkers:
    """Spawn the workers and wait until they have built their runners.
    ``build_first``: a CUDA device whose kernel library is built here
    before the spawn, so the workers load it and no rank compiles while
    another waits in a collective."""
    if build_first is not None and build_first.type == "cuda":
        from deepvision_tpu_torch.engine.kernels import _build

        _build.library()
    workers = TPWorkers(spec, size)
    try:
        workers.wait_built()
    except BaseException:
        workers.stop()
        raise
    return workers
