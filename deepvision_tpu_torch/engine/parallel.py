"""Tensor-parallel serving: the shard plan and the ranks' process group.

The counterpart of the JAX package's ``engine/parallel.py``.  The JAX
engine is one process that drives a device mesh through ``shard_map``;
here each rank is a process of its own (rank 0 is the engine's, the others
are its workers, ``engine/tp_workers.py``), and the collectives of a step
run over a ``torch.distributed`` gloo group.

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
import time
from typing import ClassVar, Optional

import torch

from deepvision_tpu_torch.engine.config import ModelConfig
from deepvision_tpu_torch.engine.quant import QUANT_LEAVES, is_quantized

# A rank waits this long for the others at the rendezvous and inside one
# collective.  A serving step's collectives meet within milliseconds; the
# slow parts of a worker's life (loading weights, building kernels) happen
# before it joins the group.
GROUP_TIMEOUT_S = 30.0


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
        import torch.distributed as dist

        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.FileStore(store_path, size)
        store.set_timeout(timeout)
        opts = dist.ProcessGroupGloo._Options()
        opts._devices = [dist.ProcessGroupGloo.create_device(
            hostname="127.0.0.1")]
        opts._timeout = timeout
        pg = dist.ProcessGroupGloo(store, rank, size, opts)
        group = cls(pg, rank, size, device)
        group._store = store       # the store lives as long as the group
        return group

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (in place; returns ``x``)."""
        x = x.contiguous()
        self._run(self.pg.allreduce([x]))
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
