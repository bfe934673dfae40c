"""Training / fine-tuning step on one device.

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
``device="cpu"``; the multi-device (mesh / shard plan) path comes with the
multi-device slice.
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
from deepvision_tpu_torch.engine.weights import init_params


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy from float32 logits ``[..., V]``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -ll.mean()


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

    def update(self, state: "OptState") -> None:
        """One step from the gradients in the leaves' ``.grad`` (clipped by
        their global norm first when ``max_grad_norm`` is set), without a
        host sync."""
        if self.max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in state.leaves
                                  if p.grad is not None], self.max_grad_norm)
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


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: scale every gradient by
    ``max_norm / norm`` when the global norm reaches ``max_norm`` (on the
    device; nothing is read back)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    coef = torch.where(norm < max_norm, torch.ones_like(norm),
                       max_norm / norm)
    for g in grads:
        g.mul_(coef.to(g.dtype))


# ---------------------------------------------------------------------------
# Train step and trainer
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, optimizer: AdamW, *,
                    use_kernel: bool = False,
                    act_dtype=torch.bfloat16):
    """Returns ``step(params, opt_state, tokens) -> loss``: one forward and
    backward of next-token cross-entropy on ``tokens [B, S + 1]`` and one
    optimizer update of ``params`` in place (``opt_state`` from
    ``optimizer.init(params)``).  The loss comes back as a device tensor.

    ``use_kernel=True`` runs attention through the flash kernels, whose
    residuals are O(S) per layer instead of the plain path's O(S^2) scores:
    that is what lets dv-base train at its 2,048-token window.
    """

    def step(params, opt_state: OptState, tokens):
        opt_state.optimizer.zero_grad(set_to_none=True)
        logits = model_lib.forward_train(
            params, tokens[:, :-1], cfg=cfg, act_dtype=act_dtype,
            use_kernel=use_kernel)
        loss = cross_entropy_loss(logits, tokens[:, 1:])
        del logits
        loss.backward()
        optimizer.update(opt_state)
        return loss.detach()

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
    """Minimal fine-tuning harness on one device."""

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
        if mesh is not None or plan is not None:
            raise NotImplementedError(
                "Trainer(mesh=..., plan=...): sharded training comes with "
                "the multi-device slice")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tx = tx if tx is not None else AdamW(learning_rate)
        if init is None:
            init = init_params(cfg, device=self.device, seed=seed,
                               dtype=param_dtype or torch.bfloat16)
        self.params = as_trainable(init, self.device, param_dtype)
        self.opt_state = self.tx.init(self.params)
        self._step = make_train_step(cfg, self.tx, use_kernel=use_kernel,
                                     act_dtype=act_dtype)
        self.step_count = 0

    def place_batch(self, tokens) -> torch.Tensor:
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens))
        return tokens.to(self.device, torch.int32)

    def train_step(self, tokens) -> float:
        return float(self.train_step_async(tokens))

    def train_step_async(self, tokens) -> torch.Tensor:
        """Like :meth:`train_step` but returns the loss as a device tensor,
        without a host sync; hot loops read losses only at log points."""
        loss = self._step(self.params, self.opt_state,
                          self.place_batch(tokens))
        self.step_count += 1
        return loss
