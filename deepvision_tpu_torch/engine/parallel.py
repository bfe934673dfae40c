"""Tensor and data parallelism: the mesh, the shard plan, the ranks'
process groups and the launcher that spawns them.

The counterpart of the JAX package's ``engine/parallel.py``.  The JAX
package is one process that drives a device mesh (``shard_map`` for
serving, GSPMD for training); here each rank is a process of its own and
the collectives run over ``torch.distributed`` gloo groups.  Serving's
ranks are an engine's process and its workers (``engine/tp_workers.py``);
training's are ``make_mesh`` places, one a process (:class:`RankProcesses`
spawns them), each with a model group (TP) and a data group (DP).

Megatron-style tensor parallelism, with the JAX package's rules:

* q/k/v and gate/up projections shard their output columns, the attention
  out-projection and the MLP down-projection their input rows; one
  ``all_reduce`` after each of the two sums the partial products;
* the KV pools shard their kv-head axis when the kv heads divide by the
  TP degree; otherwise the pools (and ``wk``/``wv``) are replicated and
  only query heads shard, which serves MQA models (one kv head);
* with vocab sharding the embedding's rows (and an untied ``lm_head``'s
  columns) shard: each rank computes logits of its own slice of the vocab,
  and sampling merges the ranks' top candidates (``engine/sampling.py``).

Shard "specs" are per-leaf dims (the axis a leaf is cut along, or None for
a replicated leaf) in place of ``PartitionSpec``s.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import multiprocessing.connection
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, ClassVar, Iterable, Optional

import torch

from deepvision_tpu_torch.engine.config import ModelConfig
from deepvision_tpu_torch.engine.quant import QUANT_LEAVES, is_quantized

# A rank waits this long for the others at the rendezvous and inside one
# collective.  A serving step's collectives meet within milliseconds; the
# slow parts of a worker's life (loading weights, building kernels) happen
# before it joins the group.
GROUP_TIMEOUT_S = 30.0
# Training's groups wait longer.  A training rank's first step sets up
# cuBLAS and the kernel library while the others may already wait in its
# first collective, and under pipeline parallelism the other stages wait in
# the next command while rank 0 writes a checkpoint or samples a batch.
TRAIN_GROUP_TIMEOUT_S = 300.0

DATA_AXIS = "data"
MODEL_AXIS = "model"


class KVGroupError(ValueError):
    """A geometry whose replicated K/V the decode kernels would pair with
    the wrong query heads.

    With ``n_kv_heads % tp != 0`` the plan replicates every kv head on
    every rank, and the attention kernels pair local query head ``j`` with
    kv head ``j // (H_local // KV)``.  That is right for ``KV == 1`` (MQA)
    only: at ``H=8, KV=2, tp=4`` rank 0's second query head reads kv head
    1 where the model means kv head 0.  The JAX engine serves such a
    geometry with other tokens than at ``tp=1``
    (``tests/test_torch_parallel_plan.py``); the port refuses it.
    """


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How a model shards over ``n_model`` ranks."""

    n_model: int
    kv_sharded: bool
    vocab_sharded: bool = False

    # Below this vocab the replicated lm_head costs little, and sharding it
    # only adds collectives.
    VOCAB_SHARD_MIN: ClassVar[int] = 32768

    @classmethod
    def for_model(cls, cfg: ModelConfig, n_model: int,
                  vocab_sharded: Optional[bool] = None) -> "ShardPlan":
        if cfg.n_heads % n_model != 0:
            raise ValueError(
                f"n_heads={cfg.n_heads} not divisible by TP degree {n_model}")
        if cfg.d_ff % n_model != 0:
            raise ValueError(
                f"d_ff={cfg.d_ff} not divisible by TP degree {n_model}")
        if vocab_sharded is None:
            vocab_sharded = (cfg.vocab_size >= cls.VOCAB_SHARD_MIN
                             and cfg.vocab_size % n_model == 0)
        elif vocab_sharded and cfg.vocab_size % n_model != 0:
            raise ValueError(
                f"vocab_size={cfg.vocab_size} not divisible by TP degree "
                f"{n_model}")
        return cls(n_model=n_model,
                   kv_sharded=cfg.n_kv_heads % n_model == 0,
                   vocab_sharded=vocab_sharded)

    def check_kv_groups(self, cfg: ModelConfig) -> None:
        """Raise :class:`KVGroupError` for replicated K/V with more than
        one kv head (see there)."""
        if not self.kv_sharded and cfg.n_kv_heads > 1:
            raise KVGroupError(
                f"n_kv_heads={cfg.n_kv_heads} at TP degree {self.n_model}: "
                "the kv heads do not divide by the TP degree, and replicated "
                "K/V is served right only for one kv head (MQA); pick a TP "
                "degree that divides n_kv_heads")

    # -- shard dims ---------------------------------------------------------

    def param_dims(self, cfg: ModelConfig, quantized: bool = False) -> dict:
        """The axis each param leaf is cut along (None: replicated), in the
        params tree's layout (block leaves ``[L, in, out]``)."""
        kv = 2 if self.kv_sharded else None
        dims = {
            "embed": 0 if self.vocab_sharded else None,
            "final_norm": None,
            "blocks": {
                "ln1": None, "ln2": None,
                "wq": 2, "wk": kv, "wv": kv, "wo": 1,
                "w_gate": 2, "w_up": 2, "w_down": 1,
            },
        }
        if not cfg.tie_embeddings:
            dims["lm_head"] = 1 if self.vocab_sharded else None
        if quantized:
            # an int8 leaf's scale drops the weight's input axis: it is cut
            # with an output-sharded weight and replicated with an
            # input-sharded one (so the scale commutes with the all_reduce)
            def qdims(d, ndim):
                if d is None or d == ndim - 2:
                    return {"q8": d, "scale": None}
                return {"q8": d, "scale": d - 1 if d == ndim - 1 else d}

            dims["blocks"] = {
                name: (qdims(d, 3) if name in QUANT_LEAVES else d)
                for name, d in dims["blocks"].items()}
            if "lm_head" in dims:
                dims["lm_head"] = qdims(dims["lm_head"], 2)
        return dims

    def dfa_dim(self) -> Optional[int]:
        """Grammar table ``[S, V]``: cut on its vocab axis with the logits,
        so the grammar mask applies rank-locally."""
        return 1 if self.vocab_sharded else None

    def cache_dims(self, n_layers: int, kv_quantized: bool = False) -> dict:
        """Per-layer pools ``[KV, N_PAGES, PAGE, HD]`` are cut on their
        kv-head axis when it divides; int8 pools' ``[KV]`` scales follow."""
        d = 0 if self.kv_sharded else None
        out = {"k": (d,) * n_layers, "v": (d,) * n_layers}
        if kv_quantized:
            out["ks"] = (d,) * n_layers
            out["vs"] = (d,) * n_layers
        return out


def shard(t: torch.Tensor, dim: Optional[int], rank: int,
          n: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous ``1/n`` of ``t`` along ``dim`` (a copy,
    so the full tensor can be freed), or ``t`` itself when ``dim`` is
    None."""
    if dim is None:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size).contiguous()


def shard_params(params: dict, plan: ShardPlan, cfg: ModelConfig,
                 rank: int) -> dict:
    """Rank ``rank``'s shard of a full params tree, cut where the JAX
    package's ``shard_params`` places each leaf's slices on the mesh."""
    dims = plan.param_dims(cfg, quantized=is_quantized(params))

    def walk(node, d):
        if isinstance(node, dict):
            return {k: walk(v, d[k]) for k, v in node.items()}
        return shard(node, d, rank, plan.n_model)

    return walk(params, dims)


class TPGroup:
    """One rank's view of a tensor-parallel group: its rank, the group's
    size, its device, and the collectives a serving step needs, over a
    gloo process group.

    The group is set up through a file rendezvous (``torch.distributed
    .FileStore`` in a fresh directory that the engine makes), never a TCP
    port, and gloo connects the ranks over the loopback device.  It is
    built with the same ``ProcessGroupGloo`` constructor that
    ``init_process_group`` uses, without registering a default group, so
    one process can hold the rank 0 of several engines (the app's lanes).
    CUDA tensors go through gloo as they are.

    ``calls`` and ``wait_s`` count the collectives and the host seconds
    spent in them (waiting for the other ranks included).
    """

    backend = "gloo"

    def __init__(self, pg, rank: int, size: int, device: torch.device):
        self.pg = pg
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.calls = 0
        self.wait_s = 0.0

    def _run(self, work) -> None:
        t0 = time.perf_counter()
        work.wait()
        self.wait_s += time.perf_counter() - t0
        self.calls += 1

    @classmethod
    def join(cls, store_path: str, rank: int, size: int, device,
             timeout_s: float = GROUP_TIMEOUT_S) -> "TPGroup":
        """Meet the other ranks at the file ``store_path`` (blocks until all
        ``size`` ranks have joined, at most ``timeout_s``)."""
        return cls.connect(_file_store(store_path, size, timeout_s), rank,
                           size, device, timeout_s)

    @classmethod
    def connect(cls, store, rank: int, size: int, device,
                timeout_s: float = GROUP_TIMEOUT_S) -> "TPGroup":
        """A group of ``size`` ranks over ``store`` (a file store, or a
        prefix of one for a subgroup); blocks until all have joined."""
        import torch.distributed as dist

        timeout = datetime.timedelta(seconds=timeout_s)
        opts = dist.ProcessGroupGloo._Options()
        opts._devices = [dist.ProcessGroupGloo.create_device(
            hostname="127.0.0.1")]
        opts._timeout = timeout
        pg = dist.ProcessGroupGloo(store, rank, size, opts)
        group = cls(pg, rank, size, device)
        group._store = store       # the store lives as long as the group
        return group

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (``op="max"``: the maximum) of ``x`` over the ranks (in
        place; returns ``x``)."""
        import torch.distributed as dist

        opts = dist.AllreduceOptions()
        opts.reduceOp = {"sum": dist.ReduceOp.SUM,
                         "max": dist.ReduceOp.MAX}[op]
        x = x.contiguous()
        self._run(self.pg.allreduce([x], opts))
        return x

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order."""
        x = x.contiguous()
        outs = [torch.empty_like(x) for _ in range(self.size)]
        self._run(self.pg.allgather([outs], [x]))
        return torch.cat(outs, dim=dim)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank (in place; returns ``x``)."""
        import torch.distributed as dist

        opts = dist.BroadcastOptions()
        opts.rootRank = src
        x = x.contiguous()
        self._run(self.pg.broadcast([x], opts))
        return x

    # Point to point.  Gloo sends and receives host memory only, so a CUDA
    # tensor goes through a host copy on either side.

    def send(self, x: torch.Tensor, dst: int, tag: int = 0):
        """Start sending ``x`` to rank ``dst``; returns the pending send,
        whose ``wait()`` must be called (the data stays alive until then)."""
        buf = x.detach().to("cpu").contiguous()
        return _Pending(self, self.pg.send([buf], dst, tag), buf)

    def recv(self, like: torch.Tensor, src: int, tag: int = 0
             ) -> torch.Tensor:
        """A tensor of ``like``'s shape, dtype and device from rank
        ``src``."""
        buf = torch.empty(like.shape, dtype=like.dtype)
        self._run(self.pg.recv([buf], src, tag))
        return buf.to(like.device)

    def sendrecv(self, x: torch.Tensor, dst: int, src: int,
                 tag: int = 0) -> torch.Tensor:
        """Send ``x`` to ``dst`` and receive its like from ``src`` at once
        (a ring's shift: every rank sends and receives)."""
        pending = self.send(x, dst, tag)
        got = self.recv(x, src, tag)
        pending.wait()
        return got


class _Pending:
    """A send in flight (:meth:`TPGroup.send`)."""

    def __init__(self, group: TPGroup, work, buf: torch.Tensor):
        self.group, self.work, self.buf = group, work, buf

    def wait(self) -> None:
        self.group._run(self.work)
        self.buf = None


def _file_store(store_path: str, size: int, timeout_s: float):
    import torch.distributed as dist

    store = dist.FileStore(store_path, size)
    store.set_timeout(datetime.timedelta(seconds=timeout_s))
    return store


# ---------------------------------------------------------------------------
# The (data, model) mesh of a training step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Mesh:
    """One rank's place in a ``(data, model)`` mesh of ``n_data *
    n_model`` ranks, its device, and its two groups.

    Ranks follow the JAX mesh's device order (the devices reshaped to
    ``(n_data, n_model)``): rank ``r`` is data index ``r // n_model`` and
    model index ``r % n_model``, so data index ``d`` takes the batch rows
    that ``P(DATA_AXIS, None)`` gives device row ``d``.  ``model`` holds
    the ``n_model`` ranks of this rank's data row (the tensor-parallel
    collectives, ranked by model index); ``data`` the ``n_data`` ranks of
    its model column (gradient averaging, ranked by data index).
    """

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    model: TPGroup
    data: TPGroup

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_model: int, n_data: int = 1, *, rank: int, store_path: str,
              device="cuda", timeout_s: float = TRAIN_GROUP_TIMEOUT_S
              ) -> Mesh:
    """Rank ``rank``'s place in an ``(n_data, n_model)`` mesh, meeting the
    other ranks at the file ``store_path`` (blocks until every rank has
    joined both its groups).  ``device``: ``"cuda"`` (rank ``r`` on
    ``cuda:(r % device_count)``; one card holds every rank) or ``"cpu"``."""
    import torch.distributed as dist

    size = n_model * n_data
    device = _rank_device(device, rank, size, "mesh")
    store = _file_store(store_path, size, timeout_s)
    d, m = divmod(rank, n_model)
    model = TPGroup.connect(dist.PrefixStore(f"model{d}", store), m,
                            n_model, device, timeout_s)
    data = TPGroup.connect(dist.PrefixStore(f"data{m}", store), d, n_data,
                           device, timeout_s)
    return Mesh(n_data, n_model, rank, device, model, data)


def _rank_device(device, rank: int, size: int, what: str) -> torch.device:
    """Rank ``rank``'s device of ``size``: ``cuda:(rank % device_count)``
    (one card holds every rank) or the CPU."""
    from deepvision_tpu_torch.engine.engine import resolve_device
    from deepvision_tpu_torch.engine.tp_workers import rank_device

    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a {what} of {size} ranks")
    return rank_device(resolve_device(device), rank)


def join_axis(n: int, *, rank: int, store_path: str, device="cuda",
              what: str = "group") -> TPGroup:
    """Rank ``rank``'s group of a one-axis mesh of ``n`` ranks (a sequence
    or pipeline axis), meeting the others at the file ``store_path`` with
    training's timeout; the rank on its device as :func:`make_mesh`'s."""
    return TPGroup.join(store_path, rank, n,
                        _rank_device(device, rank, n, what),
                        TRAIN_GROUP_TIMEOUT_S)


def gather_params(params: dict, dims: dict, group: TPGroup) -> dict:
    """The inverse of :func:`shard_params` (and of the pipeline's
    ``place_pp_params``): the full tree, each cut leaf gathered from the
    ``group``'s ranks along its dim in rank order, as new tensors (no view
    of a live param).  Every rank of the group must call it."""
    def walk(node, d):
        if isinstance(node, dict):
            return {k: walk(v, d[k]) for k, v in node.items()}
        node = node.detach()
        return node.clone() if d is None else group.all_gather(node, dim=d)

    return walk(params, dims)


# ---------------------------------------------------------------------------
# Collectives that autograd sees (Megatron's f and g)
# ---------------------------------------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(
            g.clone(memory_format=torch.contiguous_format)), None


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """The ranks' slices concatenated along ``dim`` forward; the backward
    keeps this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return group.all_gather(x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.group.rank * ctx.size,
                        ctx.size).contiguous(), None, None


def _single(group) -> bool:
    return group is None or group.size == 1


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*, in front of a column-parallel projection: ``x``
    itself forward, its gradient summed over ``group`` backward (each rank
    holds only its heads' or columns' part of it)."""
    if _single(group) or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*, after a row-parallel projection: the sum of the
    ranks' partial products forward, the gradient as it is backward."""
    if _single(group):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromGroup.apply(x, group)
    return group.all_reduce(x)


def gather_from_group(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``; backward, this rank's
    slice of the gradient."""
    if _single(group):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherFromGroup.apply(x, group, dim % x.dim())
    return group.all_gather(x, dim=dim)


# ---------------------------------------------------------------------------
# Launcher: ranks as spawned processes
# ---------------------------------------------------------------------------

# How long a stopped rank gets to exit before it is terminated, then killed
RANK_JOIN_S = 10.0


class RankError(RuntimeError):
    """A rank process failed; the message holds its traceback."""


def _rank_main(conn, fn, rank, store_path, args) -> None:
    try:
        result = fn(rank, store_path, *args)
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        conn.close()
        raise
    conn.send(("ok", result))
    conn.close()


class RankProcesses:
    """``fn(rank, store_path, *args)`` in one spawned process a rank, for
    ``ranks``; the ranks meet at ``store_path`` (by default a file in a
    fresh temporary directory that :meth:`stop` removes).

    :meth:`results` waits for every rank's return value (sent back
    pickled: keep it to numpy arrays and plain values).  When one rank
    fails the others are stopped at once, not left waiting in a collective
    for its timeout, and its traceback is raised as :class:`RankError`.
    :meth:`stop` ends every rank still alive (terminate, then kill) and
    leaves no child behind; the processes are daemonic, so an interpreter
    that exits ends them too.  A caller that is itself a rank (rank 0 of a
    pipeline) spawns the others and runs its own part in between.

    ``build_kernels``: build (or load) the CUDA kernel library here before
    the spawn, so the ranks load it and none compiles while the others
    wait for it in a collective.
    """

    def __init__(self, fn: Callable, ranks: Iterable[int], args=(),
                 store_path: Optional[str] = None,
                 build_kernels: bool = False):
        if build_kernels:
            from deepvision_tpu_torch.engine.kernels import _build

            _build.library()
        self.dir = None
        if store_path is None:
            self.dir = tempfile.mkdtemp(prefix="dv_ranks_")
            store_path = os.path.join(self.dir, "rendezvous")
        self.store_path = store_path
        ctx = multiprocessing.get_context("spawn")
        self._procs, self._conns = {}, {}
        try:
            for rank in ranks:
                here, there = ctx.Pipe(duplex=False)
                proc = ctx.Process(target=_rank_main,
                                   args=(there, fn, rank, store_path,
                                         tuple(args)),
                                   name=f"dv-rank{rank}", daemon=True)
                proc.start()
                there.close()
                self._procs[rank], self._conns[rank] = proc, here
        except BaseException:
            self.stop()
            raise

    def results(self, timeout_s: float) -> dict:
        """``{rank: return value}`` once every rank has returned; raises
        :class:`RankError` (after stopping every rank) when one fails, dies
        or outlasts ``timeout_s``."""
        pending = {conn: rank for rank, conn in self._conns.items()}
        out, deadline = {}, time.monotonic() + timeout_s
        try:
            while pending:
                left = deadline - time.monotonic()
                ready = multiprocessing.connection.wait(list(pending),
                                                        max(left, 0.0))
                if not ready:
                    raise RankError(
                        f"ranks {sorted(pending.values())} did not finish "
                        f"within {timeout_s:.0f}s")
                for conn in ready:
                    rank = pending.pop(conn)
                    try:
                        kind, payload = conn.recv()
                    except EOFError:
                        raise RankError(f"rank {rank} exited without a "
                                        "result") from None
                    if kind == "error":
                        raise RankError(f"rank {rank} failed:\n{payload}")
                    out[rank] = payload
        except BaseException:
            self.stop()
            raise
        for proc in self._procs.values():
            proc.join(RANK_JOIN_S)
        return out

    def stop(self) -> None:
        """End every rank still running and remove the store's directory."""
        for proc in self._procs.values():
            if proc.is_alive():
                proc.terminate()
        for proc in self._procs.values():
            proc.join(RANK_JOIN_S)
            if proc.is_alive():
                proc.kill()
                proc.join(RANK_JOIN_S)
        for conn in self._conns.values():
            conn.close()
        self._procs, self._conns = {}, {}
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None

    def __enter__(self) -> "RankProcesses":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def launch(fn: Callable, n: int, args=(), timeout_s: float = 1800.0,
           build_kernels: bool = False) -> list:
    """``fn(rank, store_path, *args)`` on ``n`` spawned ranks; their return
    values in rank order.  Every rank has exited when it returns.
    ``build_kernels``: as :class:`RankProcesses`'s."""
    with RankProcesses(fn, range(n), args,
                       build_kernels=build_kernels) as ranks:
        got = ranks.results(timeout_s)
    return [got[r] for r in range(n)]
