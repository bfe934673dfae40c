"""Training window: ``Trainer.train_step_async`` on a pool of batches.

Set-up builds one ``Trainer`` on the benchmark's float32 weights with the
mix's settings and ``train_model``'s optimizer chain, and drives it through
its first ``checked_steps`` steps on the pool's first batches, keeping each
step's loss, every leaf's first gradient as the optimizer got it (its first
moment after one step, over ``1 - b1``) and every leaf's change after the
checked steps.  The same object then steps through the window, a fresh
batch of the pool each step; the window closes when the last step enqueued
before its end has finished on the device.  Then the trainer is freed and
the reference repeats the checked steps from the same weights and batches.
"""

from __future__ import annotations

import gc
import math
import os
import statistics
import sys
import time

import torch

from port_bench import weights as bench_weights
from port_bench.harness import DeviceTrace, process_age_s
from port_bench.reference import model as ref
from port_bench.traffic_gen.streams import train_pool

CHECKS = "train"   # the configuration's limits this driver takes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_trainer(ctx, init):
    from deepvision_tpu_torch.engine.config import ModelConfig
    from deepvision_tpu_torch.engine.training import (
        Trainer,
        train_model_chain,
    )

    t = dict(ctx.traffic["trainer"], **ctx.engine_overrides)
    o = ctx.traffic["optimizer"]
    tx = train_model_chain(o["learning_rate"], o["warmup_steps"],
                           o["total_steps"])
    return Trainer(ModelConfig(**ctx.config["model"]), tx=tx,
                   param_dtype=DTYPES[t["param_dtype"]],
                   act_dtype=DTYPES[t["act_dtype"]],
                   use_kernel=t["use_kernel"], init=init, device=ctx.device)


def _sync(ctx):
    if ctx.device == "cuda":
        torch.cuda.synchronize()


def run(ctx) -> dict:
    from deepvision_tpu_torch.engine.tokenizer import get_tokenizer

    mix = ctx.traffic
    tokenizer = get_tokenizer(os.path.join(ctx.root, ctx.config["tokenizer"]))
    pool = torch.tensor(train_pool(mix, ctx.seed, tokenizer),
                        dtype=torch.int32, device=ctx.device)
    ctx.mark("batches")
    init = bench_weights.make_params(ctx.config["model"], ctx.seed,
                                     ctx.device, torch.float32)
    ctx.mark("weights")
    trainer = build_trainer(ctx, init)
    ctx.mark("trainer")
    ctx.plant(trainer)
    names = [n for n, _ in bench_weights.leaves(init)]
    prog_leaves = [p for _, p in bench_weights.leaves(trainer.params)]
    b1 = mix["optimizer"]["b1"]
    losses, grad_norms = [], None
    for i in range(mix["checked_steps"]):
        losses.append(trainer.train_step_async(pool[i]))
        if i == 0:
            state = trainer.opt_state.optimizer.state
            grad_norms = [float(state[p]["exp_avg"].norm()) / (1 - b1)
                          if p in state else 0.0 for p in prog_leaves]
    change_norms = [float((p.detach().float() - q).norm())
                    for p, (_, q) in zip(prog_leaves,
                                         bench_weights.leaves(init))]
    checked_losses = [float(x) for x in losses]
    ctx.mark("checked steps")

    trace = DeviceTrace(ctx.device == "cuda")
    _sync(ctx)
    setup_peak = (torch.cuda.max_memory_allocated()
                  if ctx.device == "cuda" else 0)
    if ctx.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    setup_s = process_age_s()
    step, window_losses = mix["checked_steps"], []
    while time.monotonic() < t0 + ctx.seconds:
        window_losses.append(
            trainer.train_step_async(pool[step % len(pool)]))
        step += 1
    _sync(ctx)
    t1 = time.monotonic()
    steps_done = len(window_losses)
    window_peak = (torch.cuda.max_memory_allocated()
                   if ctx.device == "cuda" else 0)
    if ctx.trace:
        # the traced steps follow the window, so the profiler's start and
        # stop stall no part of it
        trace.start()
        for _ in range(mix["trace_steps"]):
            window_losses.append(
                trainer.train_step_async(pool[step % len(pool)]))
            step += 1
        trace.stop()
    B, S = mix["batch"], mix["seq"]
    tokens = steps_done * B * S
    counters = {"steps": steps_done, "batch": B, "seq": S,
                "window_s": t1 - t0, "tokens": tokens,
                "window_peak_bytes": window_peak,
                "trace_steps": mix["trace_steps"] if trace.done else 0}
    failed = sum(1 for x in torch.stack(window_losses).tolist()
                 if not math.isfinite(x))
    print(f"train: {steps_done} steps in {t1 - t0:.3f} s, checked losses "
          f"{checked_losses}", file=sys.stderr)
    del trainer, losses, window_losses, prog_leaves
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    checks = _check(ctx, init, pool, names, checked_losses, grad_norms,
                    change_norms)
    return {
        "setup_s": setup_s,
        "window_s": t1 - t0,
        "e2e": {"train_tokens_per_s": tokens / (t1 - t0)},
        "attempted": steps_done,
        "failed": failed,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "counters": counters,
        "trace": trace.summary() if trace.done else None,
        "checks": checks,
    }


def _check(ctx, init, pool, names, losses, grad_norms, change_norms):
    """The reference's checked steps from the same weights and batches.

    ``loss_rel``: the widest relative gap of a step's loss.
    ``grad_norm_gap`` / ``update_norm_gap``: the worst leaf's gap between
    the program's and the reference's norm of the first gradient (as the
    optimizer got it) / of the change after the checked steps, over the
    larger of that leaf's reference norm and the median leaf's.  Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out of the change (they move by round-off alone)."""
    ref.exact_float32()
    params = {}
    for name, leaf in bench_weights.leaves(init):
        node = params
        *path, last = name.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf.detach().clone().requires_grad_(True)
    leaves = [p for _, p in bench_weights.leaves(params)]
    start = [p.detach().clone() for p in leaves]
    chain = ref.AdamWChain(leaves, ctx.traffic["optimizer"])
    ref_losses, ref_grads = [], None
    for i in range(len(losses)):
        loss, grads = ref.loss_and_grads(params, pool[i], ctx.config["model"])
        clipped = chain.step(leaves, grads)
        ref_losses.append(loss)
        if i == 0:
            ref_grads = [float(g.norm()) for g in clipped]
        del grads, clipped
    ref_change = [float((p.detach() - q).norm())
                  for p, q in zip(leaves, start)]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    g_med = statistics.median(ref_grads)
    grad_gap = max(abs(a - b) / max(b, g_med)
                   for a, b in zip(grad_norms, ref_grads))
    moved = [i for i, g in enumerate(ref_grads) if g >= 1e-3 * g_med]
    c_med = statistics.median(ref_change[i] for i in moved)
    change_gap = max(abs(change_norms[i] - ref_change[i])
                     / max(ref_change[i], c_med) for i in moved)
    worst = max(range(len(names)),
                key=lambda i: abs(grad_norms[i] - ref_grads[i])
                / max(ref_grads[i], g_med))
    print(f"train check: reference losses {ref_losses}; worst gradient "
          f"leaf {names[worst]}; {len(names) - len(moved)} leaves left out "
          "of the change", file=sys.stderr)
    lim = ctx.limits
    return {
        "loss_rel": {"value": loss_rel, "limit": lim["loss_rel"]},
        "grad_norm_gap": {"value": grad_gap, "limit": lim["grad_norm_gap"]},
        "update_norm_gap": {"value": change_gap,
                            "limit": lim["update_norm_gap"]},
    }
