"""Training / fine-tuning step, on one device or one rank of a DP x TP mesh.

Counterpart of the JAX package's ``engine/training.py``: the loss, a train
step and a ``Trainer`` over the same parameter tree (a dict of stacked
``[L, ...]`` leaves, here leaf tensors with ``requires_grad``).  Where the
JAX package chains optax transformations, the port runs
``torch.optim.AdamW`` behind the same settings (:class:`AdamW`), with the
defaults of ``optax.adamw`` and, for ``scripts/train_model.py``'s chain,
global-norm clipping and a warmup-cosine schedule
(:func:`train_model_chain`).  ``use_kernel=True`` trains through the flash
attention kernels (forward and both backward kernels); on CPU tensors they
run their plain versions.

The trainer runs on a CUDA device unless the caller passes
``device="cpu"``.  ``Trainer(cfg, mesh=make_mesh(...), plan=ShardPlan
.for_model(...))`` is one rank of the JAX package's DP x TP step: every
rank of the mesh builds its own ``Trainer`` (the ranks are processes,
``parallel.RankProcesses``).  A rank holds its model index's shard of the
params, takes its data index's rows of each global batch, averages the
gradients over its data group, clips by the norm of the logical leaves and
returns the global batch's mean loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from deepvision_tpu_torch.engine import model as model_lib
from deepvision_tpu_torch.engine.config import ModelConfig
from deepvision_tpu_torch.engine.engine import resolve_device
from deepvision_tpu_torch.engine.parallel import (
    reduce_from_group,
    shard_params,
)
from deepvision_tpu_torch.engine.spans import span
from deepvision_tpu_torch.engine.weights import init_params


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       group=None) -> torch.Tensor:
    """Mean next-token cross-entropy from float32 logits ``[..., V]``.

    With ``group``, ``logits`` are this rank's slice of a vocab sharded
    over the group (rank ``r`` holds ids ``r * V_local ...``): the row
    maximum is reduced over the ranks, then the sum of exponentials and the
    target's logit (from the rank that owns it) in one sum, whose backward
    leaves each rank the gradient of its own slice."""
    if group is None or group.size == 1:
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, targets.long()[..., None])[..., 0]
        return -ll.mean()
    z = logits.float()
    v_local = z.shape[-1]
    m = group.all_reduce(z.detach().amax(dim=-1, keepdim=True), op="max")
    local = targets.long() - group.rank * v_local
    owns = (local >= 0) & (local < v_local)
    picked = z.gather(-1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    parts = torch.stack([torch.exp(z - m).sum(dim=-1),
                         torch.where(owns, picked, torch.zeros_like(picked))])
    sum_exp, target = reduce_from_group(parts, group).unbind(0)
    return (torch.log(sum_exp) + m[..., 0] - target).mean()


# ---------------------------------------------------------------------------
# Optimizer: optax's adamw (+ clip_by_global_norm) on torch.optim.AdamW
# ---------------------------------------------------------------------------

def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine down to ``end_value``
    at ``decay_steps`` (which includes the warmup), constant after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw`` (optionally after ``optax.clip_by_global_norm``)
    with optax's defaults (weight decay 1e-4, not torch's 0.01): the
    settings, with :meth:`init` giving the state bound to a params tree
    and :meth:`update` applying one step to it in place.

    ``learning_rate`` is a float or a schedule of the update count (the
    first update reads ``schedule(0)``, as optax does).  Decoupled weight
    decay applies to every leaf, as optax's unmasked ``adamw``.
    """

    learning_rate: Union[float, Callable[[int], float]]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    max_grad_norm: Optional[float] = None

    def init(self, params: dict) -> "OptState":
        leaves = list(_leaves(params))
        sched = self.learning_rate if callable(self.learning_rate) else None
        # with a schedule the base lr is 1 and LambdaLR sets lr = schedule(t)
        opt = torch.optim.AdamW(
            leaves, lr=1.0 if sched else float(self.learning_rate),
            betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay)
        lr_sched = (torch.optim.lr_scheduler.LambdaLR(opt, sched)
                    if sched else None)
        return OptState(leaves, opt, lr_sched)

    def update(self, state: "OptState",
               grad_norm: Optional[Callable] = None) -> None:
        """One step from the gradients in the leaves' ``.grad`` (clipped by
        their global norm first when ``max_grad_norm`` is set), without a
        host sync.  ``grad_norm(leaves)`` gives that norm where the leaves
        are shards (:func:`global_grad_norm`)."""
        if self.max_grad_norm is not None:
            with span("train.clip"):
                clip_by_global_norm_(
                    [p.grad for p in state.leaves if p.grad is not None],
                    self.max_grad_norm,
                    grad_norm(state.leaves) if grad_norm is not None
                    else None)
        with span("train.optimizer"):
            state.optimizer.step()
            if state.lr_schedule is not None:
                state.lr_schedule.step()


@dataclasses.dataclass
class OptState:
    leaves: list
    optimizer: torch.optim.Optimizer
    lr_schedule: Optional[torch.optim.lr_scheduler.LRScheduler]


def train_model_chain(learning_rate: float, warmup_steps: int,
                      total_steps: int) -> AdamW:
    """``scripts/train_model.py``'s optimizer:
    ``chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay_schedule(
    0, lr, warmup, total, end_value=0.05 * lr), weight_decay=0.01))``."""
    sched = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, total_steps,
        end_value=learning_rate * 0.05)
    return AdamW(sched, weight_decay=0.01, max_grad_norm=1.0)


def clip_by_global_norm_(grads, max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> None:
    """``optax.clip_by_global_norm`` in place: scale every gradient by
    ``max_norm / norm`` when the global norm reaches ``max_norm`` (on the
    device; nothing is read back).  ``norm``: the global norm, where it is
    not the norm of ``grads`` alone (shards)."""
    if norm is None:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float())
                         for g in grads]))
    coef = torch.where(norm < max_norm, torch.ones_like(norm),
                       max_norm / norm)
    for g in grads:
        g.mul_(coef.to(g.dtype))


def global_grad_norm(leaves, dims, group) -> torch.Tensor:
    """The global norm of the logical params' gradients where ``leaves``
    are one rank's shards (``dims``: each leaf's cut dim or None, in the
    same order): the squares of the cut leaves summed over ``group``, each
    replicated leaf (whole and equal on every rank) counted once."""
    cut = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    whole = torch.zeros_like(cut)
    for p, d in zip(leaves, dims):
        if p.grad is None:
            continue
        sq = p.grad.float().square().sum()
        if d is None:
            whole = whole + sq
        else:
            cut = cut + sq
    if group is not None and group.size > 1:
        cut = group.all_reduce(cut)
    return torch.sqrt(cut + whole)


def sum_grads_(leaves, group, scale: float = 1.0) -> None:
    """Every leaf's gradient summed over ``group`` and scaled, in place:
    one ``all_reduce`` over the gradients laid end to end."""
    grads = [p.grad for p in leaves if p.grad is not None]
    flat = group.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    if scale != 1.0:
        flat.mul_(scale)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


# ---------------------------------------------------------------------------
# Train step and trainer
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, optimizer: AdamW, *,
                    use_kernel: bool = False,
                    act_dtype=torch.bfloat16, mesh=None, plan=None):
    """Returns ``step(params, opt_state, tokens) -> loss``: one forward and
    backward of next-token cross-entropy on ``tokens [B, S + 1]`` and one
    optimizer update of ``params`` in place (``opt_state`` from
    ``optimizer.init(params)``).  The loss comes back as a device tensor.

    ``use_kernel=True`` runs attention through the flash kernels, whose
    residuals are O(S) per layer instead of the plain path's O(S^2) scores:
    that is what lets dv-base train at its 2,048-token window.

    With ``mesh`` and ``plan`` the step is one rank's (``params`` its
    shard, ``tokens`` its data index's rows): the forward's collectives run
    over the model group, the gradients are averaged over the data group,
    clipping takes the logical leaves' norm, and the loss returned is the
    mean over the data group (the global batch's loss).
    """
    group = mesh.model if mesh is not None else None
    vocab_sharded = bool(plan is not None and plan.vocab_sharded)
    grad_norm = None
    if mesh is not None:
        dims = list(_leaves(plan.param_dims(cfg)))

        def grad_norm(leaves):
            return global_grad_norm(leaves, dims, group)

    def step(params, opt_state: OptState, tokens):
        with span("train.zero_grad"):
            opt_state.optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            logits = model_lib.forward_train(
                params, tokens[:, :-1], cfg=cfg, act_dtype=act_dtype,
                use_kernel=use_kernel, group=group,
                vocab_sharded=vocab_sharded, local_logits=True)
        with span("train.loss"):
            loss = cross_entropy_loss(logits, tokens[:, 1:],
                                      group if vocab_sharded else None)
        del logits
        with span("train.backward"):
            loss.backward()
        loss = loss.detach()
        if mesh is not None and mesh.n_data > 1:
            with span("train.grad_sync"):
                sum_grads_(opt_state.leaves, mesh.data, 1.0 / mesh.n_data)
                loss = mesh.data.all_reduce(loss.clone()) / mesh.n_data
        optimizer.update(opt_state, grad_norm)
        return loss

    return step


def _leaves(tree: dict):
    for name in sorted(tree):
        leaf = tree[name]
        if isinstance(leaf, dict):
            yield from _leaves(leaf)
        else:
            yield leaf


def as_trainable(tree: dict, device, dtype=None) -> dict:
    """Copies of a params tree on ``device`` (in ``dtype``, if given) as
    leaf tensors that require grad."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = as_trainable(leaf, device, dtype)
            continue
        t = leaf.detach().to(device=device, dtype=dtype or leaf.dtype)
        out[name] = t.clone().requires_grad_(True)
    return out


class Trainer:
    """Minimal fine-tuning harness on one device, or one rank of a DP x TP
    mesh (``mesh`` from ``parallel.make_mesh`` and ``plan`` a
    ``ShardPlan`` for ``mesh.n_model``; the device is the mesh's)."""

    def __init__(
        self,
        cfg: ModelConfig,
        mesh=None,
        plan=None,
        learning_rate: float = 1e-4,
        seed: int = 0,
        tx: Optional[AdamW] = None,
        param_dtype=None,
        use_kernel: bool = False,
        init: Optional[dict] = None,
        *,
        device="cuda",
        act_dtype=torch.bfloat16,
    ):
        if (mesh is None) != (plan is None):
            raise ValueError("Trainer: pass mesh and plan together")
        if mesh is not None and mesh.n_model != plan.n_model:
            raise ValueError(f"Trainer: a plan for TP degree {plan.n_model} "
                             f"on a mesh of {mesh.n_model} model ranks")
        self.cfg = cfg
        self.mesh = mesh
        self.plan = plan
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self.tx = tx if tx is not None else AdamW(learning_rate)
        if init is None:
            # the full tree from the seed (drawn on the host, the same on
            # every rank), then this rank's shard
            init = init_params(
                cfg, device="cpu" if mesh is not None else self.device,
                seed=seed, dtype=param_dtype or torch.bfloat16)
        if mesh is not None:
            init = shard_params(init, plan, cfg, mesh.model_index)
        self.params = as_trainable(init, self.device, param_dtype)
        self.opt_state = self.tx.init(self.params)
        self._step = make_train_step(cfg, self.tx, use_kernel=use_kernel,
                                     act_dtype=act_dtype, mesh=mesh,
                                     plan=plan)
        self.step_count = 0

    def place_batch(self, tokens) -> torch.Tensor:
        """``tokens`` on the device; on a mesh, this rank's data index's
        contiguous rows of the global batch."""
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens))
        if self.mesh is not None and self.mesh.n_data > 1:
            rows = tokens.shape[0]
            if rows % self.mesh.n_data:
                raise ValueError(f"batch of {rows} rows over "
                                 f"{self.mesh.n_data} data ranks")
            per = rows // self.mesh.n_data
            tokens = tokens[self.mesh.data_index * per:
                            (self.mesh.data_index + 1) * per]
        return tokens.to(self.device, torch.int32)

    def full_params(self) -> dict:
        """On a mesh: a copy of the full params tree, gathered over the
        model group (every rank of the group must call it)."""
        from deepvision_tpu_torch.engine.parallel import gather_params

        return gather_params(self.params, self.plan.param_dims(self.cfg),
                             self.mesh.model)

    def train_step(self, tokens) -> float:
        return float(self.train_step_async(tokens))

    def train_step_async(self, tokens) -> torch.Tensor:
        """Like :meth:`train_step` but returns the loss as a device tensor,
        without a host sync; hot loops read losses only at log points."""
        with span("train.step", step=self.step_count):
            loss = self._step(self.params, self.opt_state,
                              self.place_batch(tokens))
        self.step_count += 1
        return loss
