"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its own seconds:

1. device  — the card's name and power limit;
2. build   — the CUDA kernels compiled from ``csrc/`` (nvcc + ctypes);
   each attention kernel's registers, shared memory, spills and blocks an
   SM (the flash forward and backward, the paged chunk, the decode
   kernels), and the
   tensor-core instructions (HMMA/HGMMA) ``cuobjdump`` finds in each (the
   bf16 kernels must have some);
3. kernels — every kernel of the serving and training paths against its
   plain PyTorch version on the card, at the main paths' shapes (bf16 and
   int8 pools; the flash forward and the backward kernels at the training
   shape, ragged, f32, head dims 32/64/256, a batch with a length-0 and a
   length-1 sequence, S = 1,001 at G = 1, the backward also at HD 256 and
   S = 2,048; the paged chunk at head dims 32/64/256, int8 pools, 16-row
   pages and a padded last chunk; the decode step (#1), the read-only
   paged attention (#6) and the (B, KV)-grid decode update (#7) at the
   report lane's shape (B=8, len 1,024) in bf16 and int8 pools, at B=1
   and B=32, ragged and at head dims 32/64/256, each with the wrapper's
   column split and with splits forced to 1, the write's destination row
   poisoned, #7 also against #1; then the split's edges: lengths 1, P,
   P+1 and P*MP beside an inactive slot at every split count from 1 to
   more splits than pages, GQA groups 1/2/3/8 at head dims 32-256), with
   times for the kernel, the plain version and, where one exists, the
   PyTorch library call that computes the same function (for the flash
   forward without padded rows also SDPA's causal flash backend); the
   bf16 split of training's float32 products (``csrc/bf16_split.cu``) at
   dv-base's weights and logit gradient, in every layout, bit for bit
   against its plain version, with its time and HBM bound.  The
   flash forward, the paged chunk attention and the decode kernels, and
   their library calls, are timed from CUDA graphs (``graph_ms``): at a
   few microseconds of device time a host-timed loop measures the
   wrappers' Python;
4. engine  — ``LLMEngine.generate_text`` on dv-base at its full width and
   depth (12 layers) with random weights from a seed and the dv_bpe_16k
   tokenizer: 8 concurrent json_mode report prompts of 300-900 tokens,
   max_tokens=256, greedy.  Every output must parse, a greedy replay must
   repeat itself, the kernel-path prefill logits must agree with the plain
   ``forward_train``, and both kernels' launch counts over the served
   requests must be above 0;
5. engine_prefix — the same model with chunked prefill and the prefix
   cache (the app's default serving settings), serving 4 interview
   sessions x 3 turns through ``submit_tokens(prefix_key=...)`` and one
   ``generate_text(prefix_key=...)``: every output must parse, the prefix
   cache must hit (>= 8 hits, tokens saved), the paged chunk kernel must
   have been launched by the served traffic, and the last-position logits
   of a chunked prefill from 0 and of a resume from a page boundary must
   agree with ``forward_train``;
6. engine_prefix_trained — phase ``engine_prefix`` again on the trained
   ``resources/checkpoints/dv-base.npz``, with the readings that classify
   ROADMAP §3 fault 1: the first token where session 0's turn 3 resumed
   through the prefix cache and its cold rerun differ, the cold context's
   top-2 logit gap there against the logits' error, and each layer's
   attention output at the resumed positions on the warm path (#3 over the
   pages) and the cold one (#2) against bound A, on their own residual
   streams and on the same q/k/v; the verdict is reported;
7. paged_api — the kernels package's public paged attention
   (``paged_attention``) and ``paged_attention_update(grid_mode="bkv")``
   over 16 decode steps of dv-base's 12 layers at the report lane's shape:
   the two must agree bit for bit, match the grid-"b" kernel, and launch
   once per layer and step;
8. gateway — the app's main path: ``build_gateway`` (dv-fast on the
   question lanes, dv-base on the report lanes, the app's other defaults)
   -> ``call_model`` for a question, a report draft and the session's
   follow-up question (resumed through the prefix cache); every text must
   parse, lanes, models and decode windows must be the app's, and the
   flash, decode and chunk kernels must have run; then ``embed_texts`` on
   20 document chunks and a query: unit vectors ``[21, d_model]`` through
   the flash kernel;
9. gateway_int8 — the report draft again through a gateway with
   ``ENGINE_KV_QUANTIZE=int8``: it must parse; the calibrated scales and
   the first token that differs from the bf16 run are reported;
10. engine_w8 — phase ``engine``'s traffic under three serving settings:
   fused projections; int8 weights, fused; int8, fused and pipelined (4
   chained decode calls).  Every output must parse, the int8 block
   weights must take at most 0.55x the bf16 bytes, and prompt 0 replayed
   alone must give the same tokens with and without pipelining; the
   parameter bytes, the decode step, kernel launches a decode step
   (``torch.profiler``, beside phase ``engine``'s unfused bf16 count, which
   phase ``engine`` now also reports), the pipelined readback wait and the
   first token that differs from phase ``engine`` are reported.  It first
   holds ``qdot``'s int8 form (a bf16 GEMM with a float32 output) against
   the float32 product on the card;
11. gateway_w8 — ``build_gateway`` with ``ENGINE_QUANTIZE=int8``,
   ``ENGINE_FUSE_PROJECTIONS=1`` and ``ENGINE_PIPELINE_DECODE=1``: a
   question and the report draft must parse, ``embed_texts`` must give
   None (as in the JAX app);
12. app     — the interview app on the card through its entry points:
   ``create_app`` in engine mode (dv-fast on the question lanes, dv-base
   on the report lanes, random weights from the seed, the app's
   defaults, warmup on; lanes capped at 128 new tokens) and its test client: login, a session, a reference
   document of several KB (chunked, summarised, embedded by the interview
   assistant), next-question, submit-answer, a second next-question,
   generate-report polled to completion, the report, a docx export,
   ``/api/status`` and ``/api/metrics``.  Every status must be the JAX
   app's, the report job must complete, #1, #2 and #3 must have been
   launched by the HTTP traffic, and the second question's model work
   must have resumed the session's cached prompt head through #3 exactly
   where the app's path does; each request's latency and launches, the
   AI calls' lanes and models and ``ai_generated`` per answer are
   reported.  Then
   ``python -m deepvision_tpu_torch.web.server`` in a subprocess on a free
   port of 127.0.0.1 answers a question over real HTTP and exits when
   stopped;
13. ops     — the engine-driven ops and eval CLIs through their own
   ``main``: ``python -m deepvision_tpu_torch.report_generator`` (template
   readiness in a subprocess, then ``generate --all --workers 2`` in
   engine mode on its default dv-1b at full width, random weights, lanes
   capped at 128 new tokens: both reports saved and bound, the reports/min
   line), ``eval_generation_quality`` (trained dv-fast question lane and
   dv-base report lane, 8 generations each) and ``eval_quant_quality``
   (trained dv-base, bf16 against int8 weights, 2 prompts); #1, #2 and #3
   must each have been launched;
14. hf_import — an HF-named state dict of seeded random tensors (2-layer
   Llama shape, head_dim 128, GQA, untied ``lm_head``) through the
   importer into ``LLMEngine(quantize="int8")``: 16 greedy tokens, and the
   kernel-path prefill logits against the plain float32 forward of the
   same int8 params; then through the importer CLI's ``write_checkpoint``
   into an orbax directory, whose engine must give the 16 tokens of a
   ``.npz`` of the same bf16 params;
15. orbax   — orbax checkpoints: the compiled zstd decoder
   (``csrc/zstd_decode.cu``, host code built into the kernel library)
   byte-equal to the plain one on every frame of the committed JAX-written
   checkpoint and the committed ``zstandard`` frames, with both decoders'
   MB/s; that checkpoint read onto the card bit-equal to its ``.npz``
   twin; the trained dv-base written with the port's ``save_checkpoint``
   and read back onto the card bit for bit (seconds and MB/s of both); and
   ``LLMEngine`` booted from that directory giving the greedy tokens of
   the ``.npz`` boot (2 report prompts, json_mode, 64 tokens), #1 and #2
   launched (wrapper counts and ``torch.profiler``);
16. engine_tp — tensor-parallel serving, two ranks on ``cuda:0`` over
   gloo (the engine's process and one spawned worker): the trained
   dv-base at ``tp=2, vocab_sharded=True`` through ``LLMEngine`` (4
   json_mode report drafts of 64 tokens, a session's two turns, the
   second resumed through the prefix cache), then the same at tp=1; then
   ``build_gateway`` with ``ENGINE_TP=2`` (a JSON-mode question, a report
   draft, 64 tokens each); then dv-gemma-2b at full width, 2 of its 18 layers, random
   weights, at tp=2 (auto vocab sharding, its one kv head replicated, head
   dim 256) and at tp=1, 32 greedy tokens and a follow-up through the
   prefix cache.  Every JSON output must parse, #1, #2 and #3 must launch
   on every rank (the gateway's fresh prompts: #1 and #2), the
   teacher-forced logits must agree with tp=1 on the same weights within
   5 % of their range, and no worker may outlive its engine; each rank's
   backend and device, the launches summed over the ranks, the first
   greedy divergence from tp=1 with its top-2 gap, the decode step and
   the host time in the step's collectives are reported.  Phase
   ``kernels`` also runs #1, #2 and #3 at the two models' shard shapes;
17. train   — dv-base fine-tuning through the port's ``Trainer`` at its
   full width and depth: float32 params (random, seed 0), bf16
   activations, batch 8 x 2,049 tokens of seeded interview text through
   the dv_bpe_16k tokenizer, ``train_model.py``'s optimizer chain, the
   flash forward and both backward kernels.  The loss must be finite and
   fall over 8 steps on the batch, each backward kernel must run 12 times
   a step, every float32 product must take ``f32_matmul``'s split route
   (85 a step) with the split kernel launched 50 times a step and no
   float32 GEMM on the CUDA cores, one step at B=2 must agree with the
   plain attention and cuBLAS float32 products through autograd (loss
   and every gradient leaf), and ``save_npz`` ->
   ``load_or_init`` must give back the same bits; one step is profiled;
18. train_parallel — multi-device training, every rank a spawned process
   on ``cuda:0`` over gloo: dv-base at full width and depth through
   ``Trainer(mesh, plan)`` on a DP2 x TP2 mesh (float32 params from seed
   0, batch 8 x 2,049, ``train_model.py``'s chain, the flash kernels, 3
   steps): the losses must be finite and equal on every rank, the first
   step's loss and gradients within phase ``train``'s bf16 bounds of a
   one-rank ``Trainer`` on the same weights and batch and the params after
   it bit-equal to the one rank's, and #2, #4 and #5 must launch 12 times
   a step on every rank (step ms, host ms in collectives, the ranks' skew
   and peak memory are reported); ``ring_attention`` over 2 ranks at
   dv-base's attention width (B 1, H 6, KV 2, HD 128, S 8,192, the row
   padded to 7,000) within 2e-5 of plain float32 attention, and its
   backward (the ring run again, dK/dV travelling with their K/V chunk)
   from a seeded cotangent: each rank's dq, dk and dv, joined along S,
   within 2e-5 x max(max|g|, 1) of autograd through plain float32
   attention on every row (forward and backward ms and their send/recv
   ms per rank, and one device's plain times, are reported); ``python -m
   deepvision_tpu_torch.train_model --pp 2 --pp-micro 4`` on dv-base
   (batch 8 x 2,048, 2 steps, a seeded corpus) must exit 0 with its
   stages line and a checkpoint of 12-layer stacks, and the pipeline's
   float32 loss on fixed weights and batch must equal one device's at
   1e-5 relative.  Phase ``kernels`` also runs #2, #4 and #5 at the DP2 x
   TP2 shard shape;
19. the card's name and power limit again, then the ``kernels`` line the
   benchmark contract reads (seven kernels, each with its achieved
   TFLOP/s, whether it computes on the tensor cores or in fp32 on the
   CUDA cores and, for the kernels that split columns, the split count
   and the time unsplit, phases ``app``'s and ``ops``' launches of #1-#3,
   phase ``engine_tp``'s launches and shard-shape cases of #1-#3, and
   phase ``train_parallel``'s launches and shard-shape cases of #2, #4
   and #5), after the whole run's seconds;
20. shutdown, then the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line.  Without CUDA it exits 2 before any phase.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import glob
import importlib
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_HBM_BYTES_S = 3.35e12       # NVIDIA H100 SXM data sheet
H100_BF16_FLOP_S = 989e12        # dense tensor-core bf16
H100_F32_FLOP_S = 67e12          # fp32 outside the tensor cores
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj, ensure_ascii=False), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (after one
    warm-up call), from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` with the host's launch cost left out:
    ``iters`` calls captured in one CUDA graph (after a warm-up call on a
    side stream), replayed, and timed with CUDA events.  For a call of a
    few microseconds of device time, :func:`cuda_ms` measures the
    wrapper's host time instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, by_kernel: bool = False):
    """Device time of one ``fn()``: the sum of the kernels it launches
    over ``iters`` calls (torch.profiler), per call.  Unlike
    :func:`cuda_ms` it leaves out the host's launch cost, which bounds
    back-to-back calls of a short kernel.  With ``by_kernel`` also the
    time a call of each kernel, by the start of its name:
    ``(total, {name: ms})``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, kernels = 0.0, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            total += us
            name = e.key[:60]
            kernels[name] = kernels.get(name, 0.0) + us / 1e3 / iters
    if by_kernel:
        return total / 1e3 / iters, kernels
    return total / 1e3 / iters


def bound(bytes_moved: float, flops: float, flop_rate: float):
    t_bytes = bytes_moved / H100_HBM_BYTES_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    t0 = time.monotonic()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    info = {
        "phase": "device", "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "nvidia_smi": smi[:1],
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }
    info["seconds"] = time.monotonic() - t0
    emit(info)
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    return info


# a mangled attention kernel name: ..flash_bwd_dq_tc_kernelILi128EE..,
# ..flash_fwd_f32_kernelIfLi128EE.., ..paged_chunk_tc_kernelIaLi128EE..
_ATTN_KERNEL = re.compile(
    r"((?:flash_bwd_(?:dq|dkv)|flash_fwd|paged_chunk)_(?:tc|f32)_kernel)"
    r"I(f|a|13__nv_bfloat16)?Li(\d+)E")
_MANGLED_TYPES = {"f": "float,", "a": "int8,", "13__nv_bfloat16": "bf16,"}


def _sass_mma_counts(so_path: str) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in each attention kernel of
    the built library (the flash forward and backward, the paged chunk),
    from ``cuobjdump -sass``; empty where the toolkit has no cuobjdump."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                     "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = _ATTN_KERNEL.search(line)
            name = (f"{m.group(1)}<{_MANGLED_TYPES.get(m.group(2), '')}"
                    f"{m.group(3)}>" if m else None)
            if name:
                counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif name:
            for op in ("HGMMA", "HMMA"):
                if op + "." in line:
                    counts[name][op] += 1
                    break
    return counts


def phase_build() -> dict:
    from deepvision_tpu_torch.engine.kernels import _build
    from deepvision_tpu_torch.engine.kernels.flash_attention import (
        HEAD_DIMS,
        flash_bwd_kernel_info,
        flash_fwd_kernel_info,
    )
    from deepvision_tpu_torch.engine.kernels.paged_attention import (
        paged_attention_kernel_info,
        paged_decode_kernel_info,
    )
    from deepvision_tpu_torch.engine.kernels.paged_chunk import (
        paged_chunk_kernel_info,
    )

    t0 = time.monotonic()
    _build.library()
    info = _build.build_info()
    regs = []
    if os.path.isfile(info["log_path"]):
        with open(info["log_path"]) as fh:
            for line in fh:
                if "registers" in line or ("spill" in line
                                           and " 0 bytes spill" not in line):
                    regs.append(line.strip().replace("ptxas info    : ", ""))
    # each attention kernel as the card runs it: registers, dynamic shared
    # memory, local (spill) bytes and blocks an SM
    bf16, f32 = torch.bfloat16, torch.float32
    bwd = {f"{kind}_{dtype}_hd{hd}": flash_bwd_kernel_info(kind, hd, dtype)
           for kind in ("dq", "dkv") for dtype in (bf16, f32)
           for hd in HEAD_DIMS}
    fwd = {f"{dtype}_hd{hd}": flash_fwd_kernel_info(hd, dtype)
           for dtype in (bf16, f32) for hd in HEAD_DIMS}
    chunk = {f"{pool}_hd{hd}": paged_chunk_kernel_info(hd, pool)
             for pool in (bf16, torch.int8) for hd in HEAD_DIMS}
    # the split decode kernels: #1 at every head dim and pool dtype for
    # the served groups (dv-fast 2, dv-base 3) and the largest (8); #6 and
    # #7 at the report lane's page size (64) and group (3), which size
    # their shared memory
    decode = {f"{pool}_hd{hd}_g{g}": paged_decode_kernel_info(hd, pool, g)
              for pool in (bf16, torch.int8) for hd in HEAD_DIMS
              for g in (2, 3, 8)}
    paged = {f"{'write' if w else 'read'}_{pool}_hd{hd}":
             paged_attention_kernel_info(hd, pool, w, 64, 3)
             for w in (False, True) for pool in (bf16, torch.int8)
             for hd in HEAD_DIMS}
    spills = {f"{group}/{n}": v["local_bytes"]
              for group, table in (("flash_fwd", fwd), ("flash_bwd", bwd),
                                   ("paged_chunk", chunk),
                                   ("paged_decode", decode))
              for n, v in table.items()
              if ("bfloat16" in n or group in ("paged_chunk", "paged_decode"))
              and v["local_bytes"]}
    if spills:  # the tensor-core and decode kernels keep state in registers
        raise AssertionError(f"attention kernels with local (spill) "
                             f"memory: {spills}")
    mma = _sass_mma_counts(info["so_path"])
    # the bf16 tensor-core kernels: dQ, dK/dV and the forward at every head
    # dim, the chunk kernel for both pool dtypes
    tc = {n: c for n, c in mma.items() if "_tc_kernel" in n}
    if mma and (len(tc) != 5 * len(HEAD_DIMS)
                or min(c["HMMA"] + c["HGMMA"] for c in tc.values()) <= 0):
        raise AssertionError(f"bf16 attention kernels without tensor-core "
                             f"instructions: {tc}")
    out = {"phase": "build", "seconds": time.monotonic() - t0,
           "sources": [os.path.relpath(p, ROOT) for p in _build.sources()],
           "ptxas": regs[:48], "flash_fwd_kernels": fwd,
           "flash_bwd_kernels": bwd, "paged_chunk_kernels": chunk,
           "paged_decode_kernels": decode, "paged_attention_kernels": paged,
           "attention_sass_mma": mma or "cuobjdump not found"}
    emit(out)
    return out


def _flash_case(name, B, H, KV, S, HD, lens, dtype, gen, iters=20,
                profiled=False):
    from deepvision_tpu_torch.engine.kernels import flash_attention as fa

    dev = torch.device("cuda")
    q = torch.randn(B, H, S, HD, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, KV, S, HD, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, KV, S, HD, generator=gen, device=dev).to(dtype)
    seq = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = fa.flash_attention(q, k, v, seq)
    want = fa.flash_attention_reference(q, k, v, seq)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    # bf16: both sides round the same fp32 value once (1 bf16 ulp of an
    # O(1) output is 2^-8); fp32: summation order only.
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    if not err <= tol or not torch.isfinite(got).all():
        raise AssertionError(f"flash {name}: max_abs_err {err} > {tol}")
    # the kernel and the library call timed alike: launches replayed from
    # a CUDA graph (graph_ms); back-to-back from the host too (events_ms)
    ms = graph_ms(lambda: fa.flash_attention(q, k, v, seq), iters)
    events_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, seq), iters)
    ms_lse = graph_ms(lambda: fa.flash_forward(q, k, v, seq, with_lse=True),
                      iters)
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, seq),
                       max(2, iters // 5))
    idx = torch.arange(S, device=dev)
    mask = ((idx[None, :] <= idx[:, None])[None]
            & (idx[None, None, :] < seq.long()[:, None, None]))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = graph_ms(
        lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True), iters)
    library_events_ms = cuda_ms(
        lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True), iters)
    # a second yardstick where no row is padded: SDPA's causal flash backend
    sdpa_causal_ms = None
    if all(n == S for n in lens):
        sdpa_causal_ms = graph_ms(
            lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), iters)
    # device time alone (the profiler's kernel sums): back-to-back calls of
    # a short kernel are bound by the wrapper's host time
    dev_ms = library_dev_ms = None
    if profiled:
        dev_ms = device_ms(lambda: fa.flash_attention(q, k, v, seq), iters)
        library_dev_ms = device_ms(
            lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True), iters)
    itemsize = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * itemsize + 4 * B
    pairs = sum(sum(min(r + 1, n) for r in range(S)) for n in lens)
    flops = 4.0 * H * HD * pairs
    rate = H100_BF16_FLOP_S if dtype == torch.bfloat16 else H100_F32_FLOP_S
    bound_ms, bound_by = bound(nbytes, flops, rate)
    out = {"case": name, "shape": [B, H, KV, S, HD], "seq_lens": lens,
           "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
           "tol": tol, "ms": ms, "ms_with_lse": ms_lse, "events_ms": events_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_events_ms": library_events_ms,
           "sdpa_causal_ms": sdpa_causal_ms,
           "device_ms": dev_ms, "library_device_ms": library_dev_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
           "tflops": flops / 1e9 / ms}
    emit({"phase": "kernels", "kernel": "flash_fwd", **out})
    return out


def _bwd_case(name, B, H, KV, S, HD, lens, dtype, gen, iters=10):
    """The dQ and dK/dV kernels against their plain versions on the same
    inputs (a cotangent that is nonzero on padded rows too; lse from the
    forward kernel, itself held against the plain row logsumexp)."""
    from deepvision_tpu_torch.engine.kernels import flash_attention as fa

    dev = torch.device("cuda")
    q = torch.randn(B, H, S, HD, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, KV, S, HD, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, KV, S, HD, generator=gen, device=dev).to(dtype)
    g = torch.randn(B, H, S, HD, generator=gen, device=dev).to(dtype)
    seq = torch.tensor(lens, dtype=torch.int32, device=dev)
    out, lse = fa.flash_forward(q, k, v, seq, with_lse=True)
    lse_err = (lse - fa.row_logsumexp_reference(q, k, seq)).abs().max().item()
    # lse is O(10) and summed in another order: 1e-3 absolute
    if not lse_err <= 1e-3:
        raise AssertionError(f"flash lse {name}: max_abs_err {lse_err}")
    delta = fa.flash_bwd_delta(out, g)
    args = (q, k, v, seq, g, lse, delta)
    got = {"flash_bwd_dq": (fa.flash_bwd_dq(*args),),
           "flash_bwd_dkv": fa.flash_bwd_dkv(*args)}
    want = {"flash_bwd_dq": (fa.flash_bwd_dq_reference(*args),),
            "flash_bwd_dkv": fa.flash_bwd_dkv_reference(*args)}
    torch.cuda.synchronize()
    itemsize = q.element_size()
    rate = H100_BF16_FLOP_S if dtype == torch.bfloat16 else H100_F32_FLOP_S
    # dQ walks every row (padded rows too); dK/dV only rows < len
    pairs_dq = sum(sum(min(r + 1, n) for r in range(S)) for n in lens)
    pairs_dkv = sum(n * (n + 1) // 2 for n in lens)
    work = {
        "flash_bwd_dq": (3 * 2.0 * H * HD * pairs_dq,
                         (3 * q.numel() + k.numel() + v.numel()) * itemsize
                         + 8 * B * H * S + 4 * B),
        "flash_bwd_dkv": (4 * 2.0 * H * HD * pairs_dkv,
                          (2 * q.numel() + 4 * k.numel()) * itemsize
                          + 8 * B * H * S + 4 * B),
    }
    fns = {"flash_bwd_dq": (fa.flash_bwd_dq, fa.flash_bwd_dq_reference),
           "flash_bwd_dkv": (fa.flash_bwd_dkv, fa.flash_bwd_dkv_reference)}
    # library yardstick: SDPA's backward alone (dQ, dK and dV together)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if all(n == S for n in lens):
        ref_out = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)
    else:
        idx = torch.arange(S, device=dev)
        mask = ((idx[None, :] <= idx[:, None])[None]
                & (idx[None, None, :] < seq.long()[:, None, None]))[:, None]
        ref_out = sdpa(qg, kg, vg, attn_mask=mask, enable_gqa=True)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        ref_out, (qg, kg, vg), g, retain_graph=True), iters)
    outs = {}
    for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
        # bf16: both sides round one fp32 value per element, so they may
        # land one bf16 step apart: 2^-7 of the output's largest gradient;
        # fp32: summation order only (1e-4 of its largest gradient)
        rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
        err = scale = tol = 0.0
        for a, b_ in zip(got[kname], want[kname]):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{kname} {name}: non-finite output")
            e = (a.float() - b_.float()).abs().max().item()
            m = b_.float().abs().max().item()
            if not e <= rel * max(m, 1.0):
                raise AssertionError(f"{kname} {name}: max_abs_err {e} > "
                                     f"{rel} x max(|plain| {m}, 1)")
            err, scale = max(err, e), max(scale, m)
            tol = max(tol, rel * max(m, 1.0))
        kern, plain = fns[kname]
        ms = cuda_ms(lambda: kern(*args), iters)
        plain_ms = cuda_ms(lambda: plain(*args), max(2, iters // 5))
        flops, nbytes = work[kname]
        bound_ms, bound_by = bound(nbytes, flops, rate)
        outs[kname] = {
            "case": name, "shape": [B, H, KV, S, HD], "seq_lens": lens,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
            "max_abs_plain": scale, "tol": tol, "lse_err": lse_err,
            "ms": ms, "plain_ms": plain_ms,
            # SDPA gives dQ, dK and dV in one call: set it beside the sum
            # of the two kernels
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "gflop": flops / 1e9,
            "tflops": flops / 1e9 / ms,
            "compute_route": ("tensor_core" if dtype == torch.bfloat16
                              else "f32_cuda_core")}
        emit({"phase": "kernels", "kernel": kname, **outs[kname]})
    return outs


def bwd_cases(gen) -> dict:
    """Every backward case; returns the main one, the training shape
    (dv-base, B=8, S=2048, bf16, full lengths)."""
    bf16 = torch.bfloat16
    main = _bwd_case("train_b8_s2048", 8, 6, 2, 2048, 128, [2048] * 8, bf16,
                     gen, iters=5)
    _bwd_case("ragged_gqa", 4, 6, 2, 1024, 128, [1024, 901, 640, 300], bf16,
              gen)
    _bwd_case("f32", 2, 6, 2, 512, 128, [512, 333], torch.float32, gen)
    _bwd_case("s200_partial_tiles", 2, 4, 2, 200, 64, [200, 150], bf16, gen)
    _bwd_case("hd32", 2, 4, 2, 256, 32, [256, 131], bf16, gen)
    _bwd_case("hd64_g8", 2, 8, 1, 256, 64, [256, 77], bf16, gen)
    _bwd_case("hd256", 1, 8, 1, 512, 256, [390], bf16, gen)
    # the tensor-core tiling's edges: a length-0 and a length-1 sequence in
    # one batch; S a multiple of neither tile (64, 32) at G=1; HD 256 at
    # the full 2,048 tokens
    _bwd_case("len0_len1", 4, 6, 2, 256, 128, [256, 0, 1, 97], bf16, gen)
    _bwd_case("s1001_g1", 2, 4, 4, 1001, 128, [1001, 777], bf16, gen)
    _bwd_case("hd256_s2048", 1, 8, 1, 2048, 256, [2048], bf16, gen, iters=3)
    return main


def _decode_inputs(B, H, KV, HD, P, MP, lens, pool_dtype, gen,
                   inactive=()):
    """Inputs of one decode step on the card: each sequence owns MP
    distinct pages, entries past its live pages are 0 (the trash page), as
    in the scheduler's block tables; an ``inactive`` slot (len 1) points
    at the trash page only.  int8 pools are quantized with a scale of
    3 / 127 and take float rows (the wrapper quantizes them)."""
    from deepvision_tpu_torch.engine.kv_cache import quantize_rows

    dev = torch.device("cuda")
    N = B * MP + 1
    q = torch.randn(B, H, HD, generator=gen, device=dev).to(torch.bfloat16)
    nk = torch.randn(B, KV, HD, generator=gen, device=dev).to(torch.bfloat16)
    nv = torch.randn(B, KV, HD, generator=gen, device=dev).to(torch.bfloat16)
    kf = torch.randn(KV, N, P, HD, generator=gen, device=dev)
    vf = torch.randn(KV, N, P, HD, generator=gen, device=dev)
    ks = vs = None
    if pool_dtype == torch.int8:
        ks = torch.full((KV,), 3.0 / 127, device=dev)
        vs = torch.full((KV,), 3.0 / 127, device=dev)
        kp, vp = quantize_rows(kf, ks, 0), quantize_rows(vf, vs, 0)
    else:
        kp, vp = kf.to(pool_dtype), vf.to(pool_dtype)
    bt = (1 + torch.randperm(B * MP, generator=gen, device=dev)
          ).reshape(B, MP).to(torch.int32)
    for i, n in enumerate(lens):
        bt[i, -(-n // P):] = 0
        if i in inactive:
            bt[i] = 0
    seq = torch.tensor(lens, dtype=torch.int32, device=dev)
    return dict(q=q, nk=nk, nv=nv, kp=kp, vp=vp, ks=ks, vs=vs, bt=bt,
                seq=seq, lens=list(lens), inactive=tuple(inactive), P=P)


def _poison_rows(inp):
    """Fill each active sequence's destination row in the pools before the
    step: NaN in bf16 pools; in int8 pools a K row of +-127 with the signs
    of the kv head's summed q (its score dwarfs every other column's) and
    a V row of 127.  A block that read the row from the pool instead of
    new_k / new_v would miss the plain version, which writes first."""
    q, kp, vp, bt, P = inp["q"], inp["kp"], inp["vp"], inp["bt"], inp["P"]
    KV = kp.shape[0]
    for i, n in enumerate(inp["lens"]):
        if i in inp["inactive"]:
            continue
        dst, off = int(bt[i, (n - 1) // P]), (n - 1) % P
        if kp.dtype == torch.int8:
            sign = q[i].float().reshape(KV, -1, q.shape[-1]).sum(1)
            kp[:, dst, off] = torch.where(sign < 0, -127, 127).to(torch.int8)
            vp[:, dst, off] = 127
        else:
            kp[:, dst, off] = float("nan")
            vp[:, dst, off] = float("nan")


def _decode_fns(kind, inp):
    """``(kernel(splits), plain())`` of one decode entry point on fresh
    copies of the pools: ``decode`` is #1 (``paged_attention_update``,
    grid "b"), ``bkv`` #7 (grid "bkv"), ``paged`` #6 (read-only).  Each
    returns ``(out, k_pages, v_pages)``."""
    pa = importlib.import_module(
        "deepvision_tpu_torch.engine.kernels.paged_attention")
    g = {k: inp[k] for k in ("q", "nk", "nv", "bt", "seq")}
    sc = dict(k_scale=inp["ks"], v_scale=inp["vs"])
    kp1, vp1 = inp["kp"].clone(), inp["vp"].clone()
    kp2, vp2 = inp["kp"].clone(), inp["vp"].clone()
    if kind == "paged":
        def kern(splits=None):
            return (pa.paged_attention(g["q"], kp1, vp1, g["bt"], g["seq"],
                                       splits=splits, **sc), kp1, vp1)

        def plain():
            return (pa.paged_attention_reference(
                g["q"], kp2, vp2, g["bt"], g["seq"], inp["ks"], inp["vs"]),
                kp2, vp2)
        return kern, plain

    def kern(splits=None):
        return pa.paged_attention_update(
            g["q"], g["nk"], g["nv"], kp1, vp1, g["bt"], g["seq"],
            grid_mode="b" if kind == "decode" else "bkv", splits=splits,
            **sc)

    def plain():
        return pa.paged_attention_update_reference(
            g["q"], g["nk"], g["nv"], kp2, vp2, g["bt"], g["seq"], **sc)
    return kern, plain


def _split_check(kind, inp, splits_list, tol=2e-2):
    """The kernel of ``kind`` at each split count against its plain
    version on the same inputs, the write's destination rows poisoned
    (#1, #7): outputs of the compared rows within ``tol`` and finite, the
    pools equal outside trash page 0.  Returns the worst error by split
    count."""
    if kind != "paged":
        inp = dict(inp, kp=inp["kp"].clone(), vp=inp["vp"].clone())
        _poison_rows(inp)
    compared = [i for i in range(len(inp["lens"]))
                if kind == "paged" or i not in inp["inactive"]]
    errs = {}
    for splits in splits_list:
        kern, plain = _decode_fns(kind, inp)
        got, gkp, gvp = kern(splits)
        want, wkp, wvp = plain()
        torch.cuda.synchronize()
        err = (got[compared].float() - want[compared].float()).abs().max()
        errs[splits] = err.item()
        if not errs[splits] <= tol or not torch.isfinite(got[compared]).all():
            raise AssertionError(f"{kind} splits {splits} lens {inp['lens']}"
                                 f": max_abs_err {errs[splits]} > {tol}")
        for a, b_ in ((gkp, wkp), (gvp, wvp)):
            if not torch.equal(a[:, 1:], b_[:, 1:]):
                raise AssertionError(f"{kind} splits {splits}: pools differ "
                                     f"outside page 0")
    return errs


_KIND_NAMES = {"decode": "paged_decode_update", "bkv": "paged_update_bkv",
               "paged": "paged_attention"}


def _decode_case(name, kind, B, H, KV, HD, P, MP, lens, pool_dtype, gen,
                 iters=50, profiled=False, inactive=None, active_hint=False):
    """One entry point (``kind``, as :func:`_decode_fns`) against its plain
    version with the wrapper's column split and without one, the write's
    destination rows poisoned; timed from CUDA graphs (``ms``, and
    ``ms_one_split`` with splits forced to 1), from the host
    (``events_ms``) and, ``profiled``, by the profiler's device time; #7
    also against #1 on the same inputs; #6 beside SDPA on K/V gathered
    dense.  A len-1 slot is inactive (trash page only, output not compared
    for the writes) unless ``inactive`` names the slots.  With
    ``active_hint`` the split count is the engine runner's, from the slots
    that decode, and the wrapper's own (from B) is timed beside it."""
    pa = importlib.import_module(
        "deepvision_tpu_torch.engine.kernels.paged_attention")
    dev = torch.device("cuda")
    if inactive is None:
        inactive = tuple(i for i, n in enumerate(lens) if n == 1)
    inp = _decode_inputs(B, H, KV, HD, P, MP, lens, pool_dtype, gen,
                         inactive)
    splits = pa.decode_splits(
        B - len(inactive) if active_hint else B, KV, MP, dev)
    tol = 2e-2  # bf16 outputs: one ulp of an O(1) value, summing order
    errs = _split_check(kind, inp, sorted({splits, 1}), tol)
    out = {"case": name, "shape": [B, H, KV, HD, P, MP], "seq_lens": lens,
           "pool_dtype": str(pool_dtype).split(".")[-1],
           "max_abs_err": max(errs.values()), "max_abs_err_by_splits": errs,
           "splits": splits, "tol": tol}
    if kind == "bkv":  # the same function as #1 on the same inputs
        k7, _ = _decode_fns("bkv", inp)
        k1, _ = _decode_fns("decode", inp)
        compared = [i for i in range(B) if i not in inactive]
        out["max_abs_err_vs_grid_b"] = (
            k7()[0][compared].float() - k1()[0][compared].float()
        ).abs().max().item()
        if not out["max_abs_err_vs_grid_b"] <= tol:
            raise AssertionError(f"bkv {name}: against the grid-b kernel "
                                 f"{out['max_abs_err_vs_grid_b']} > {tol}")
    kern_b, plain = _decode_fns(kind, inp)
    kern = lambda: kern_b(splits)  # noqa: E731
    out["ms"] = graph_ms(kern, iters)
    out["ms_one_split"] = graph_ms(lambda: kern_b(1), iters)
    if active_hint:  # the wrapper's own choice, from B
        out["splits_from_b"] = pa.decode_splits(B, KV, MP, dev)
        out["ms_splits_from_b"] = graph_ms(kern_b, iters)
    out["events_ms"] = cuda_ms(kern, iters)
    out["plain_ms"] = cuda_ms(plain, max(2, iters // 10))
    out["device_ms"] = out["device_by_kernel"] = None
    if profiled:  # the split kernel and the merge apart
        out["device_ms"], out["device_by_kernel"] = device_ms(
            kern, iters, by_kernel=True)
    out["device_ms_one_split"] = (device_ms(lambda: kern_b(1), iters)
                                  if profiled else None)
    out["library_ms"] = None
    if kind == "paged":
        # library yardstick: SDPA on K/V already gathered dense (the
        # gather is left out of its time), with a bool length mask
        L = max(lens)
        bt, seq = inp["bt"], inp["seq"]

        def dense(pool, scale):
            x = pool.float() * (scale[:, None, None, None]
                                if scale is not None else 1.0)
            return (x[:, bt.long()].permute(1, 0, 2, 3, 4)
                    .reshape(B, KV, MP * P, HD)[:, :, :L]
                    .to(torch.bfloat16).contiguous())

        kd, vd = dense(inp["kp"], inp["ks"]), dense(inp["vp"], inp["vs"])
        mask = (torch.arange(L, device=dev)[None, :]
                < seq.long()[:, None])[:, None, None, :]
        q4 = inp["q"][:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out["library_ms"] = graph_ms(
            lambda: sdpa(q4, kd, vd, attn_mask=mask, enable_gqa=True), iters)
    itemsize = inp["kp"].element_size()
    live = sum(lens)
    row = KV * HD * itemsize
    # q read and out written; the live K/V rows read; for the writes this
    # step's rows read (in place of one live row each) and written into
    # the pools; the live block-table entries, lengths and scales
    nbytes = (2 * inp["q"].numel() * 2 + 2 * live * row
              + (2 * B * row if kind != "paged" else 0)
              + sum(-(-n // P) for n in lens) * 4 + 4 * B
              + (8 * KV if inp["ks"] is not None else 0))
    flops = 4.0 * H * HD * live
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, H100_BF16_FLOP_S)
    out.update(gflop=flops / 1e9, mbytes=nbytes / 1e6,
               kernel_info=(pa.paged_decode_kernel_info(HD, pool_dtype,
                                                        H // KV)
                            if kind == "decode" else
                            pa.paged_attention_kernel_info(
                                HD, pool_dtype, kind == "bkv", P, H // KV)))
    emit({"phase": "kernels", "kernel": _KIND_NAMES[kind], **out})
    return out


def decode_cases(gen) -> dict:
    """#1, #6 and #7: the report lane's shape (B=8, H=6, KV=2, HD=128,
    P=64, MP=32, every len 1,024) in bf16 (the main cases) and int8 pools,
    then B=1 and B=32, ragged batches and small head dims; returns the
    main cases by kernel name."""
    bf16, i8 = torch.bfloat16, torch.int8
    ragged = [2048, 1, 64, 65, 700, 1024, 1500, 33]
    main = {}
    for kind in ("decode", "paged", "bkv"):
        main[_KIND_NAMES[kind]] = _decode_case(
            "main_b8_len1024", kind, 8, 6, 2, 128, 64, 32, [1024] * 8, bf16,
            gen, profiled=True)
        _decode_case("main_b8_len1024_int8", kind, 8, 6, 2, 128, 64, 32,
                     [1024] * 8, i8, gen, profiled=True)
        _decode_case("b1_len1024", kind, 1, 6, 2, 128, 64, 32, [1024], bf16,
                     gen, profiled=True)
        _decode_case("b32_len1024", kind, 32, 6, 2, 128, 64, 32, [1024] * 32,
                     bf16, gen, profiled=True)
        # the gateway's 32 slots with two requests decoding
        _decode_case("b32_2active", kind, 32, 6, 2, 128, 64, 32,
                     [1024, 700] + [1] * 30, bf16, gen, profiled=True,
                     active_hint=True)
        _decode_case("b8_ragged", kind, 8, 6, 2, 128, 64, 32, ragged, bf16,
                     gen)
        _decode_case("b8_ragged_int8", kind, 8, 6, 2, 128, 64, 32, ragged, i8,
                     gen)
        _decode_case("hd32", kind, 4, 4, 2, 32, 16, 8, [128, 1, 17, 100],
                     bf16, gen, iters=20)
        _decode_case("hd256_g8", kind, 2, 8, 1, 256, 64, 4, [256, 130], bf16,
                     gen, iters=20)
        _decode_case("hd256_g8_int8", kind, 2, 8, 1, 256, 64, 4, [256, 130],
                     i8, gen, iters=20)
        _decode_case("hd64", kind, 2, 8, 2, 64, 16, 8, [100, 37], bf16, gen,
                     iters=20)
    # the split count against time at the report shape and at 32 slots,
    # every len 1,024 (what decode_splits chooses from)
    for kind in ("decode", "paged"):
        for B in (8, 32):
            inp = _decode_inputs(B, 6, 2, 128, 64, 32, [1024] * B, bf16, gen)
            kern, _ = _decode_fns(kind, inp)
            emit({"phase": "kernels", "kernel": "decode_split_sweep",
                  "entry": _KIND_NAMES[kind], "B": B,
                  "ms_by_splits": {sp: graph_ms(lambda: kern(sp), 50)
                                   for sp in (1, 2, 4, 8, 16, 32)}})
    return main


def split_cases(gen) -> dict:
    """The column split's edges for #1, #6 and #7, each against its plain
    version within 2e-2 with the pools equal outside page 0 and the
    write's destination rows poisoned: lengths 1 (on a real page), P, P+1
    and P*MP beside an inactive slot on the trash page at every split
    count from 1 to more splits than pages; GQA groups 1/2/3/8 at head
    dims 32/64/128/256 at the wrapper's split count, 1 and 3.  Emits and
    returns the number of checks and the worst error by kernel."""
    t0 = time.monotonic()
    P, MP = 16, 8
    worst, checks = {}, 0
    for pool in (torch.bfloat16, torch.int8):
        for kind in ("decode", "bkv", "paged"):
            inp = _decode_inputs(5, 6, 2, 128, P, MP, [1, P, P + 1, P * MP, 1],
                                 pool, gen, inactive=(4,))
            errs = _split_check(kind, inp, range(1, MP + 3))
            for H, KV, HD in ((2, 2, 32), (4, 2, 64), (6, 2, 128),
                              (8, 1, 256), (8, 1, 32), (3, 3, 256)):
                inp = _decode_inputs(4, H, KV, HD, P, MP, [1, 37, 100, P * MP],
                                     pool, gen, inactive=(0,))
                errs.update({f"g{H // KV}_hd{HD}_s{k}": v for k, v in
                             _split_check(kind, inp, (None, 1, 3)).items()})
            name = _KIND_NAMES[kind]
            worst[name] = max(worst.get(name, 0.0), max(errs.values()))
            checks += len(errs)
    out = {"phase": "kernels", "kernel": "decode_split_edges",
           "checks": checks, "worst_abs_err": worst, "tol": 2e-2,
           "seconds": time.monotonic() - t0}
    emit(out)
    return out


def _chunk_case(name, B, C, H, KV, HD, P, MP, starts, ends, pool_dtype, gen,
                iters=20, profiled=False):
    """``paged_chunk_attention`` against its plain version: every output
    row (both compute the padded rows of a last chunk with one formula)."""
    from deepvision_tpu_torch.engine.kernels import paged_chunk as pc
    from deepvision_tpu_torch.engine.kv_cache import quantize_rows

    dev = torch.device("cuda")
    N = B * MP + 1
    q = torch.randn(B, C, H, HD, generator=gen, device=dev).to(torch.bfloat16)
    kf = torch.randn(KV, N, P, HD, generator=gen, device=dev)
    vf = torch.randn(KV, N, P, HD, generator=gen, device=dev)
    ks = vs = None
    if pool_dtype == torch.int8:
        ks = torch.full((KV,), 3.0 / 127, device=dev)
        vs = torch.full((KV,), 3.0 / 127, device=dev)
        kp, vp = quantize_rows(kf, ks, 0), quantize_rows(vf, vs, 0)
    else:
        kp, vp = kf.to(pool_dtype), vf.to(pool_dtype)
    # each sequence owns MP distinct pages; entries past its live pages
    # are 0 (the trash page), as in the scheduler's block tables
    bt = (1 + torch.randperm(B * MP, generator=gen, device=dev)
          ).reshape(B, MP).to(torch.int32)
    for i, n in enumerate(ends):
        bt[i, -(-n // P):] = 0
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    en = torch.tensor(ends, dtype=torch.int32, device=dev)
    splits = pc.chunk_splits(B, C, H, KV, HD, P * MP, dev)
    want = pc.paged_chunk_attention_reference(q, kp, vp, bt, st, en,
                                              k_scale=ks, v_scale=vs)
    # bf16 outputs: both sides round one fp32 value (1 bf16 ulp of an O(1)
    # output is 2^-8) after summing in another order; the kernel with the
    # wrapper's column split and without one (what a large grid runs)
    tol = 2e-2
    errs = {}
    for n_split in sorted({splits, 1}):
        got = pc.paged_chunk_attention(q, kp, vp, bt, st, en, k_scale=ks,
                                       v_scale=vs, splits=n_split)
        torch.cuda.synchronize()
        errs[n_split] = (got.float() - want.float()).abs().max().item()
        if not errs[n_split] <= tol or not torch.isfinite(got).all():
            raise AssertionError(f"chunk {name} (splits {n_split}): "
                                 f"max_abs_err {errs[n_split]} > {tol}")
    err = max(errs.values())
    # timed as in _flash_case: from a CUDA graph, and from the host
    ms = graph_ms(lambda: pc.paged_chunk_attention(
        q, kp, vp, bt, st, en, k_scale=ks, v_scale=vs), iters)
    events_ms = cuda_ms(lambda: pc.paged_chunk_attention(
        q, kp, vp, bt, st, en, k_scale=ks, v_scale=vs), iters)
    plain_ms = cuda_ms(lambda: pc.paged_chunk_attention_reference(
        q, kp, vp, bt, st, en, k_scale=ks, v_scale=vs), max(2, iters // 5))
    # library yardstick: SDPA on K/V already gathered dense (the gather
    # itself is left out of its time), with the causal-offset bool mask
    L = max(ends)

    def dense(pool, scale):
        x = pool.float() * (scale[:, None, None, None] if scale is not None
                            else 1.0)
        # [KV, B, MP, P, HD] -> [B, KV, MP * P, HD], cut to L columns
        return (x[:, bt.long()].permute(1, 0, 2, 3, 4)
                .reshape(B, KV, MP * P, HD)[:, :, :L].to(torch.bfloat16)
                .contiguous())

    kd, vd = dense(kp, ks), dense(vp, vs)
    col = torch.arange(L, device=dev)
    q_pos = st.long()[:, None] + torch.arange(C, device=dev)[None, :]
    mask = ((col[None, None, :] <= q_pos[:, :, None])
            & (col[None, None, :] < en.long()[:, None, None]))[:, None]
    qt = q.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = graph_ms(
        lambda: sdpa(qt, kd, vd, attn_mask=mask, enable_gqa=True), iters)
    library_events_ms = cuda_ms(
        lambda: sdpa(qt, kd, vd, attn_mask=mask, enable_gqa=True), iters)
    dev_ms = dev_ms_one_split = library_dev_ms = None
    if profiled:  # device time alone, as in _flash_case
        dev_ms = device_ms(lambda: pc.paged_chunk_attention(
            q, kp, vp, bt, st, en, k_scale=ks, v_scale=vs), iters)
        dev_ms_one_split = device_ms(lambda: pc.paged_chunk_attention(
            q, kp, vp, bt, st, en, k_scale=ks, v_scale=vs, splits=1), iters)
        library_dev_ms = device_ms(
            lambda: sdpa(qt, kd, vd, attn_mask=mask, enable_gqa=True), iters)
    itemsize = kp.element_size()
    live_cols = sum(ends)
    nbytes = (2 * q.numel() * 2 + 2 * live_cols * KV * HD * itemsize
              + sum(-(-n // P) for n in ends) * 4 + 8 * B
              + (8 * KV if ks is not None else 0))
    pairs = sum(min(s0 + c + 1, n) for s0, n in zip(starts, ends)
                for c in range(C))
    flops = 4.0 * H * HD * pairs
    bound_ms, bound_by = bound(nbytes, flops, H100_BF16_FLOP_S)
    out = {"case": name, "shape": [B, C, H, KV, HD, P, MP],
           "starts": starts, "ends": ends,
           "pool_dtype": str(pool_dtype).split(".")[-1], "max_abs_err": err,
           "max_abs_err_by_splits": errs, "splits": splits,
           "tol": tol, "ms": ms, "events_ms": events_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_events_ms": library_events_ms,
           "device_ms": dev_ms, "device_ms_one_split": dev_ms_one_split,
           "library_device_ms": library_dev_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
           "tflops": flops / 1e9 / ms}
    emit({"phase": "kernels", "kernel": "paged_chunk", **out})
    return out


def chunk_cases(gen) -> dict:
    """Every ``paged_chunk`` case; returns the main one, dv-base's prefix
    resume (B=1, C=256, start 640 -> n 896, bf16 pools)."""
    bf16, i8 = torch.bfloat16, torch.int8
    main = None
    for pool in (bf16, i8):
        tag = "" if pool == bf16 else "_int8"
        for start, n in ((640, 896), (0, 256), (1792, 1900)):
            out = _chunk_case(f"main_s{start}_n{n}{tag}", 1, 256, 6, 2, 128,
                              64, 32, [start], [n], pool, gen,
                              profiled=start == 640)
            if main is None:
                main = out
    _chunk_case("b2_ragged", 2, 256, 6, 2, 128, 64, 32, [256, 1024],
                [512, 1100], bf16, gen)
    _chunk_case("hd32", 1, 64, 4, 2, 32, 16, 8, [64], [100], bf16, gen,
                iters=10)
    _chunk_case("hd64_g8", 1, 32, 8, 1, 64, 16, 8, [16], [40], bf16, gen,
                iters=10)
    _chunk_case("hd256", 1, 64, 8, 1, 256, 64, 4, [64], [128], bf16, gen,
                iters=10)
    # the tensor-core tiling's edges: int8 pools at head dims 64 and 256,
    # 16-row pages under 64-column tiles at head dim 128
    _chunk_case("hd64_g8_int8", 1, 32, 8, 1, 64, 16, 8, [16], [40], i8, gen,
                iters=10)
    _chunk_case("hd256_int8", 1, 64, 8, 1, 256, 64, 4, [64], [128], i8, gen,
                iters=10)
    _chunk_case("p16", 1, 128, 6, 2, 128, 16, 64, [300], [428], bf16, gen,
                iters=10)
    return main


def tp_shard_cases(gen) -> dict:
    """#1, #2 and #3 at the shard shapes tensor-parallel serving at tp=2
    gives them (phase ``engine_tp``): dv-base's H 6 / KV 2 cut to 3 / 1 a
    rank at head dim 128, and dv-gemma-2b's H 8 cut to 4 a rank on its one
    replicated kv head at head dim 256; the main paths' batch and lengths.
    Returns the cases by kernel name, then model."""
    bf16 = torch.bfloat16
    out = {"paged_decode_update": {}, "flash_fwd": {}, "paged_chunk": {}}
    out["paged_decode_update"]["dv-base"] = _decode_case(
        "tp2_dvbase_b8_len1024", "decode", 8, 3, 1, 128, 64, 32, [1024] * 8,
        bf16, gen, profiled=True)
    out["paged_decode_update"]["dv-gemma-2b"] = _decode_case(
        "tp2_gemma_b8_len1024", "decode", 8, 4, 1, 256, 64, 32, [1024] * 8,
        bf16, gen)
    out["flash_fwd"]["dv-base"] = _flash_case(
        "tp2_dvbase_b4_s1024", 4, 3, 1, 1024, 128, [1024, 901, 640, 300],
        bf16, gen, profiled=True)
    out["flash_fwd"]["dv-gemma-2b"] = _flash_case(
        "tp2_gemma_b2_s512", 2, 4, 1, 512, 256, [512, 300], bf16, gen)
    out["paged_chunk"]["dv-base"] = _chunk_case(
        "tp2_dvbase_s640_n896", 1, 256, 3, 1, 128, 64, 32, [640], [896],
        bf16, gen, profiled=True)
    out["paged_chunk"]["dv-gemma-2b"] = _chunk_case(
        "tp2_gemma_s256_n400", 1, 256, 4, 1, 256, 64, 8, [256], [400], bf16,
        gen)
    return out


def train_shard_cases(gen) -> dict:
    """#2, #4 and #5 at the shard shape phase ``train_parallel``'s DP2 x
    TP2 step gives them on dv-base: 4 of the batch's 8 rows a data rank,
    H 6 / KV 2 cut to 3 / 1 a model rank, S 2,048, head dim 128, bf16.
    Returns the cases by kernel name."""
    bf16 = torch.bfloat16
    out = {"flash_fwd": _flash_case(
        "dp2tp2_dvbase_b4_s2048", 4, 3, 1, 2048, 128, [2048] * 4, bf16, gen,
        iters=10, profiled=True)}
    out.update(_bwd_case("dp2tp2_dvbase_b4_s2048", 4, 3, 1, 2048, 128,
                         [2048] * 4, bf16, gen, iters=5))
    return out


def _bits16(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor's bits, whatever its layout."""
    return t.contiguous().view(torch.int16)


def bf16_split_cases(gen) -> dict:
    """The split kernel (``csrc/bf16_split.cu``) at the shapes dv-base's
    training step gives it: each block weight as the products take it
    (q/k/v and gate/up side by side), the tied head as its transposed
    view, both layouts from one pass, and the float32 logit gradient
    ``[B*S, V]`` in one layout; every layout (stacked along the rows, along
    the columns, both at once), read as it lies and transposed, bit for bit
    against :func:`split_bf16_reference` on the card.  Bound: HBM bytes,
    4 read and 6 written a value, 12 written with two layouts.  Returns
    the logit gradient's case."""
    from deepvision_tpu_torch.engine.config import get_model_config
    from deepvision_tpu_torch.engine.kernels.bf16_split import (
        split_bf16,
        split_bf16_both,
        split_bf16_reference,
    )

    cfg = get_model_config("dv-base")
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    dev = torch.device("cuda")
    shapes = [("w_qkv", (D, q + 2 * kv), 0.02), ("wo", (q, D), 0.02),
              ("w_gate_up", (D, 2 * F), 0.02), ("w_down", (F, D), 0.02),
              ("head", (V, D), 0.02), ("dlogits", (8 * 2048, V), 1e-6)]
    out = {}
    for name, shape, scale in shapes:
        t = torch.randn(*shape, generator=gen, device=dev) * scale
        if name == "head":      # the products take the tied embedding as E.T
            t = t.t()
        for view in (t, t.t()):
            for dim in (0, 1):
                want = _bits16(split_bf16_reference(view, dim))
                if not torch.equal(_bits16(split_bf16(view, dim)), want):
                    raise AssertionError(f"bf16_split {name} {dim}: not "
                                         f"the plain version's bits")
            both = split_bf16_both(view)
            for dim in (0, 1):
                if not torch.equal(_bits16(both[dim]), _bits16(
                        split_bf16_reference(view, dim))):
                    raise AssertionError(f"bf16_split {name} both[{dim}]: "
                                         f"not the plain version's bits")
            del both, want
        # what the step runs: a weight's two layouts from one pass, the
        # logit gradient stacked along its rows
        two = name != "dlogits"
        iters = 5 if name in ("dlogits", "head") else 20
        if two:
            fn = lambda: split_bf16_both(t)   # noqa: E731
            plain = lambda: (split_bf16_reference(t, 0),   # noqa: E731
                             split_bf16_reference(t, 1))
        else:
            fn = lambda: split_bf16(t, 0)   # noqa: E731
            plain = lambda: split_bf16_reference(t, 0)   # noqa: E731
        ms = cuda_ms(fn, iters)
        plain_ms = cuda_ms(plain, max(2, iters // 5))
        bound_ms, bound_by = bound(t.numel() * (16 if two else 10), 0.0,
                                   H100_BF16_FLOP_S)
        out[name] = {"case": name, "shape": list(t.shape),
                     "transposed": not t.is_contiguous(),
                     "layouts": 2 if two else 1, "bit_equal": True,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "share_of_bound": bound_ms / ms}
        emit({"phase": "kernels", "kernel": "bf16_split", **out[name]})
        del t
    torch.cuda.empty_cache()
    return out["dlogits"]


def phase_kernels() -> dict:
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    bf16 = torch.bfloat16
    flash = [
        _flash_case("main_b4_s1024", 4, 6, 2, 1024, 128,
                    [1024, 901, 640, 300], bf16, gen, profiled=True),
        _flash_case("b4_s2048", 4, 6, 2, 2048, 128,
                    [2048, 1500, 977, 300], bf16, gen, iters=10),
        _flash_case("train_b8_s2048", 8, 6, 2, 2048, 128, [2048] * 8, bf16,
                    gen, iters=10, profiled=True),
        _flash_case("b4_s256", 4, 6, 2, 256, 128, [256, 200, 77, 1], bf16,
                    gen),
        _flash_case("hd32", 2, 4, 2, 256, 32, [256, 131], bf16, gen),
        _flash_case("hd256", 1, 8, 1, 512, 256, [390], bf16, gen),
        _flash_case("hd64_f32", 2, 4, 2, 256, 64, [256, 99], torch.float32,
                    gen),
        # the tensor-core tiling's edges: a length-0 and a length-1
        # sequence in one batch; S a multiple of no tile at G = 1; head
        # dim 64 at G = 8
        _flash_case("len0_len1", 4, 6, 2, 256, 128, [256, 0, 1, 97], bf16,
                    gen),
        _flash_case("s1001_g1", 2, 4, 4, 1001, 128, [1001, 777], bf16, gen),
        _flash_case("hd64_g8", 2, 8, 1, 256, 64, [256, 77], bf16, gen),
    ]
    decode = decode_cases(gen)
    split_cases(gen)
    chunk = chunk_cases(gen)
    bwd = bwd_cases(gen)
    tp = tp_shard_cases(gen)
    train_shard = train_shard_cases(gen)
    split = bf16_split_cases(gen)
    emit({"phase": "kernels_done", "seconds": time.monotonic() - t0})
    return {"flash_fwd": flash[0], "paged_chunk": chunk, **bwd, **decode,
            "tp_shard": tp, "train_shard": train_shard, "bf16_split": split}


def _report_prompts(tokenizer, targets):
    """Report-style Chinese prompts built from the in-repo scenarios, cut
    to the target token counts."""
    files = sorted(glob.glob(os.path.join(ROOT, "resources", "scenarios",
                                          "builtin", "*.json")))
    if not files:
        raise FileNotFoundError("resources/scenarios/builtin/*.json")
    prompts = []
    for i, target in enumerate(targets):
        with open(files[i % len(files)], encoding="utf-8") as fh:
            sc = json.load(fh)
        head = (f"你是一名资深需求分析师。请根据以下访谈记录撰写《{sc['name']}》"
                f"报告草稿。\n访谈主题：{sc['name']}\n{sc['description']}\n\n")
        body = []
        for r in range(64):
            d = sc["dimensions"][r % len(sc["dimensions"])]
            body.append(f"问题{r + 1}（{d['name']}）：请具体说明{d['description']}。"
                        f"\n回答：关于{'、'.join(d['key_aspects'])}，"
                        f"目前第{r + 1}轮访谈确认了现状与期望。\n")
        tail = "\n请输出 JSON 报告：{\"overview\": \"...\", \"risks\": [...]}"
        ids_tail = tokenizer.encode(tail)
        ids = tokenizer.encode(head + "".join(body))
        ids = ids[: target - len(ids_tail)] + ids_tail
        prompts.append(tokenizer.decode(ids))
    return prompts


def phase_engine() -> dict:
    from deepvision_tpu_torch.engine import model as model_lib
    from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine
    from deepvision_tpu_torch.engine.kernels.flash_attention import (
        flash_attention,
    )
    from deepvision_tpu_torch.engine.kernels.paged_attention import (
        paged_attention_update,
    )
    from deepvision_tpu_torch.engine.kv_cache import CacheConfig, init_cache
    from deepvision_tpu_torch.engine.weights import count_params, param_bytes

    t0 = time.monotonic()
    tok_path = os.path.join(ROOT, "resources", "tokenizer", "dv_bpe_16k.json")
    eng = LLMEngine(EngineConfig(
        model="dv-base", tokenizer=tok_path, checkpoint_dir=None,
        device="cuda", max_slots=8, num_pages=1024, page_size=64,
        max_pages_per_seq=32, decode_steps_per_call=16,
        chunked_prefill=False, json_dfa=True, warmup=True, seed=SEED))
    t_boot = time.monotonic() - t0
    try:
        eng.start()
        t_warm = time.monotonic() - t0 - t_boot
        targets = [300, 380, 460, 540, 620, 700, 800, 900]
        prompts = _report_prompts(eng.tokenizer, targets)

        def run(p):
            return eng.generate_text(p, max_tokens=256, temperature=0.0,
                                     json_mode=True, timeout=600)

        flash_attention.launches = 0
        paged_attention_update.launches = 0
        t_serve = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
            results = list(ex.map(run, prompts))
        serve_s = time.monotonic() - t_serve
        launches = {"flash_fwd": flash_attention.launches,
                    "paged_decode_update": paged_attention_update.launches}
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel was not launched: {launches}")
        for text, meta in results:
            json.loads(text)  # raises on unparseable output
            if meta["completion_tokens"] <= 0:
                raise AssertionError(f"empty completion: {meta}")

        # greedy replay of prompt 0, twice, alone
        ids0 = eng.tokenizer.encode(prompts[0])
        replays = []
        for _ in range(2):
            res = eng.submit_tokens(ids0, max_tokens=256, temperature=0.0,
                                    json_mode=True).wait(600)
            if res is None or not res.ok:
                raise AssertionError(f"replay failed: {res}")
            replays.append(res.token_ids)
        if replays[0] != replays[1]:
            raise AssertionError("greedy replay gave different token ids")
        replay_matches_batch = (eng.tokenizer.decode(replays[0])
                                == results[0][0])

        # kernel-path prefill logits vs the plain full-sequence forward
        cfg = eng.model_cfg
        params = eng.runner.params
        n = len(ids0)
        bucket = 512
        cache = init_cache(cfg, CacheConfig(num_pages=bucket // 64 + 1,
                                            page_size=64,
                                            max_pages_per_seq=bucket // 64),
                           device="cuda")
        toks = torch.zeros(1, bucket, dtype=torch.int32, device="cuda")
        toks[0, :n] = torch.tensor(ids0, dtype=torch.int32)
        pages = torch.arange(1, bucket // 64 + 1, dtype=torch.int32,
                             device="cuda")[None]
        lens = torch.tensor([n], dtype=torch.int32, device="cuda")
        got = model_lib.forward_prefill(params, cache, toks, lens, pages,
                                        cfg=cfg)[0]
        with torch.no_grad():
            want = model_lib.forward_train(params, toks[:, :n],
                                           cfg=cfg)[0, -1]
        logit_err = (got - want).abs().max().item()
        # two bf16 paths through 12 layers that differ in attention
        # kernel, padding and GEMM shapes: allow 5% of the logit range
        logit_tol = 0.05 * want.abs().max().item() + 0.05
        if not logit_err <= logit_tol:
            raise AssertionError(
                f"prefill logits vs forward_train: {logit_err} > {logit_tol}")

        ttft = sorted(m["queue_wait_ms"] + m["prefill_ms"] for _, m in results)
        completion = sum(m["completion_tokens"] for _, m in results)
        stats = eng.stats()
        decode_profile = _decode_profile(eng)
        out = {
            "phase": "engine", "model": cfg.name, "params": count_params(params),
            "weights": f"random (seed {SEED})", "boot_s": t_boot,
            "warmup_s": t_warm, "requests": len(results),
            "json_parsed": len(results),
            "prompt_tokens": [m["prompt_tokens"] for _, m in results],
            "completion_tokens": completion,
            "finish_reasons": [m["finish_reason"] for _, m in results],
            "serve_s": serve_s,
            "ttft_ms_p50": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
            "decode_tokens_per_s": completion / serve_s,
            "decode_time_s": stats["decode_time_s"],
            "decode_steps": stats["decode_steps"],
            "launches": launches, "replay_identical": True,
            "replay_matches_batch": replay_matches_batch,
            "prefill_logit_err": logit_err, "prefill_logit_tol": logit_tol,
            "decode_ms_per_step": stats["decode_time_s"] * 1e3
            / max(1, stats["decode_steps"]),
            "decode_profile": decode_profile,
            "param_bytes": param_bytes(params),
            "block_bytes": param_bytes(params["blocks"]),
        }
    finally:
        eng.shutdown()
    out["seconds"] = time.monotonic() - t0
    emit(out)
    # phase engine_w8 compares its settings' outputs with these
    out["texts"] = [text for text, _ in results]
    out["replay_ids"] = replays[0]
    return out


def _first_diff(a, b):
    """The first index where two token sequences differ (None: equal)."""
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if i is None and len(a) != len(b):
        i = min(len(a), len(b))
    return i


def _decode_profile(eng, n_steps: int = 16) -> dict:
    """CUDA kernel launches and device time per decode step, from
    ``torch.profiler`` over one ``runner.decode`` call of ``n_steps``
    steps with every slot active at length 600 (the writes land in the
    trash page); the call is run once before, unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runner = eng.runner
    B, MP = eng.cfg.max_slots, eng.cache_cfg.max_pages_per_seq
    args = (np.ones(B, np.int32), np.full(B, 600, np.int32),
            np.zeros((B, MP), np.int32), np.zeros(B, np.float32),
            np.zeros(B, np.int32), np.ones(B, np.float32))
    runner.decode(*args, n_steps=n_steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.decode(*args, n_steps=n_steps)
        torch.cuda.synchronize()
    kernels = copies = 0
    device_us = 0.0
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.count
            continue
        kernels += e.count
        by_name[e.key[:70]] = by_name.get(e.key[:70], 0) + e.count
        us = getattr(e, "self_device_time_total", None)
        device_us += e.self_cuda_time_total if us is None else us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"n_steps": n_steps, "kernels_per_step": kernels / n_steps,
            "copies_per_step": copies / n_steps,
            "device_ms_per_step": device_us / 1e3 / n_steps,
            "top_kernels_per_step": [[n, c / n_steps] for n, c in top]}


def _interview_sessions(tokenizer, n_turns=3):
    """Token ids of 4 interview sessions' turns: turn 1 is a report-style
    prompt of 600/700/800/900 tokens; every later turn is the previous
    turn's prompt plus a ~200-token answer, so the head's ids are stable."""
    files = sorted(glob.glob(os.path.join(ROOT, "resources", "scenarios",
                                          "builtin", "*.json")))
    sessions = []
    for i, text in enumerate(_report_prompts(tokenizer, [600, 700, 800, 900])):
        with open(files[i % len(files)], encoding="utf-8") as fh:
            sc = json.load(fh)
        turns = [tokenizer.encode(text)]
        for t in range(1, n_turns):
            dims = sc["dimensions"]
            answer = "".join(
                f"\n补充回答{t}-{k + 1}（{dims[(t + k) % len(dims)]['name']}）："
                f"{dims[(t + k) % len(dims)]['description']}，"
                f"现场确认{'、'.join(dims[(t + k) % len(dims)]['key_aspects'])}。"
                for k in range(12))
            turns.append(turns[-1] + tokenizer.encode(answer)[:200])
        sessions.append(turns)
    return sessions


def _chunked_logits(model_lib, params, cfg, ids, head_n):
    """Last-position logits of ``ids`` on a fresh cache: ``head_n`` tokens
    (page-aligned, may be 0) written by ``forward_prefill``, the rest by
    ``forward_prefill_chunk`` in chunks of 256 from ``head_n``."""
    from deepvision_tpu_torch.engine.kv_cache import CacheConfig, init_cache

    dev, P, MP, C = "cuda", 64, 32, 256
    n = len(ids)
    cache = init_cache(cfg, CacheConfig(num_pages=MP + 1, page_size=P,
                                        max_pages_per_seq=MP), device=dev)
    bt = torch.arange(1, MP + 1, dtype=torch.int32, device=dev)[None]
    toks = torch.tensor(ids, dtype=torch.int32, device=dev)[None]
    if head_n:
        model_lib.forward_prefill(
            params, cache, toks[:, :head_n],
            torch.tensor([head_n], dtype=torch.int32, device=dev),
            bt[:, : head_n // P], cfg=cfg)
    for start in range(head_n, n, C):
        chunk = torch.zeros(1, C, dtype=torch.int32, device=dev)
        piece = toks[:, start:start + C]
        chunk[:, : piece.shape[1]] = piece
        logits = model_lib.forward_prefill_chunk(
            params, cache, chunk,
            torch.tensor([start], dtype=torch.int32, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev), bt, cfg=cfg)
    return logits[0]


def phase_engine_prefix(checkpoint=None, phase="engine_prefix",
                        readings=None) -> dict:
    """Phase ``engine_prefix`` on random weights from the seed, or on the
    ``.npz`` at ``checkpoint``; ``readings(eng, sessions, warm, cold,
    logit_err)``, when given, runs before the engine shuts down and its
    dict is reported under ``"readings"``."""
    from deepvision_tpu_torch.engine import model as model_lib
    from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine
    from deepvision_tpu_torch.engine.kernels.flash_attention import (
        flash_attention,
    )
    from deepvision_tpu_torch.engine.kernels.paged_attention import (
        paged_attention_update,
    )
    from deepvision_tpu_torch.engine.kernels.paged_chunk import (
        paged_chunk_attention,
    )

    # the first engine's pools and weights must be gone before this one
    gc.collect()
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    if checkpoint is not None and not os.path.isfile(checkpoint):
        raise AssertionError(f"{phase}: no checkpoint at {checkpoint}")
    t0 = time.monotonic()
    tok_path = os.path.join(ROOT, "resources", "tokenizer", "dv_bpe_16k.json")
    eng = LLMEngine(EngineConfig(
        model="dv-base", tokenizer=tok_path, checkpoint_dir=checkpoint,
        device="cuda", max_slots=8, num_pages=1024, page_size=64,
        max_pages_per_seq=32, decode_steps_per_call=16,
        chunked_prefill=True, prefill_chunk_size=256, json_dfa=True,
        warmup=True, seed=SEED))
    t_boot = time.monotonic() - t0
    try:
        eng.start()
        t_warm = time.monotonic() - t0 - t_boot
        tok = eng.tokenizer
        sessions = _interview_sessions(tok)

        def turn(i, t):
            res = eng.submit_tokens(
                sessions[i][t], max_tokens=128, temperature=0.0,
                json_mode=True, prefix_key=f"sess-{i}").wait(600)
            if res is None or not res.ok:
                raise AssertionError(f"session {i} turn {t + 1}: {res}")
            return res

        flash_attention.launches = 0
        paged_attention_update.launches = 0
        paged_chunk_attention.launches = 0
        waves = []
        t_serve = time.monotonic()
        for t in range(3):
            with concurrent.futures.ThreadPoolExecutor(4) as ex:
                waves.append(list(ex.map(lambda i: turn(i, t), range(4))))
        text_g, meta_g = eng.generate_text(
            tok.decode(sessions[1][2]) + "\n请给出下一步访谈建议。",
            max_tokens=128, temperature=0.0, json_mode=True, timeout=600,
            prefix_key="sess-1")
        serve_s = time.monotonic() - t_serve
        launches = {"flash_fwd": flash_attention.launches,
                    "paged_decode_update": paged_attention_update.launches,
                    "paged_chunk": paged_chunk_attention.launches}
        if launches["paged_chunk"] <= 0:
            raise AssertionError(f"the chunk kernel was not launched: "
                                 f"{launches}")
        prefix = eng.stats()["prefix_cache"]
        outputs = [tok.decode(r.token_ids) for w in waves for r in w]
        for text in outputs + [text_g]:
            json.loads(text)  # raises on unparseable output
        if prefix["hits"] < 8 or prefix["tokens_saved"] <= 0:
            raise AssertionError(f"prefix cache did not hit: {prefix}")

        # warm (resumed) session 0 turn 3 against a cold rerun, alone
        warm = waves[2][0].token_ids
        cold = eng.submit_tokens(sessions[0][2], max_tokens=128,
                                 temperature=0.0, json_mode=True).wait(600)
        if cold is None or not cold.ok:
            raise AssertionError(f"cold rerun failed: {cold}")
        diverge = next((k for k, (a, b) in enumerate(zip(warm, cold.token_ids))
                        if a != b), None)
        if diverge is None and len(warm) != len(cold.token_ids):
            diverge = min(len(warm), len(cold.token_ids))

        # logits of session 0's turn-3 prompt: chunks of 256 from 0, and a
        # resume at the page boundary of turn 2's cached head
        cfg, params = eng.model_cfg, eng.runner.params
        ids = sessions[0][2]
        head_n = len(sessions[0][1]) // 64 * 64
        with torch.no_grad():
            want = model_lib.forward_train(
                params, torch.tensor([ids], dtype=torch.int32, device="cuda"),
                cfg=cfg)[0, -1]
        logit_tol = 0.05 * want.abs().max().item() + 0.05
        logit_err = {}
        for name, head in (("chunked_from_0", 0), ("resume", head_n)):
            got = _chunked_logits(model_lib, params, cfg, ids, head)
            logit_err[name] = (got - want).abs().max().item()
            if not logit_err[name] <= logit_tol:
                raise AssertionError(f"{name} logits vs forward_train: "
                                     f"{logit_err[name]} > {logit_tol}")

        def ttft(results):
            v = sorted(r.queue_wait_ms + r.prefill_ms for r in results)
            return {"p50": v[len(v) // 2], "max": v[-1], "n": len(v)}

        completion = (sum(len(r.token_ids) for w in waves for r in w)
                      + meta_g["completion_tokens"])
        stats = eng.stats()
        out = {
            "phase": phase, "model": cfg.name,
            "weights": (f"random (seed {SEED})" if checkpoint is None else
                        os.path.relpath(checkpoint, ROOT)),
            "chunked_prefill": True,
            "prefill_chunk_size": 256, "mem_before_boot_gb": mem_before / 1e9,
            "boot_s": t_boot, "warmup_s": t_warm,
            "requests": len(outputs) + 1, "json_parsed": len(outputs) + 1,
            "prompt_tokens": [[len(x) for x in s] for s in sessions],
            "prefix_cache": prefix, "launches": launches,
            "ttft_ms_turn1": ttft(waves[0]),
            "ttft_ms_turns2_3": ttft(waves[1] + waves[2]),
            "prefill_ms_turn1": [r.prefill_ms for r in waves[0]],
            "prefill_ms_turns2_3": [r.prefill_ms for r in waves[1] + waves[2]],
            "completion_tokens": completion, "serve_s": serve_s,
            "tokens_per_s": completion / serve_s,
            "decode_time_s": stats["decode_time_s"],
            "decode_steps": stats["decode_steps"],
            "warm_equals_cold": diverge is None,
            "warm_cold_first_divergence": diverge,
            "logit_err": logit_err, "logit_tol": logit_tol,
            "resume_head_tokens": head_n,
        }
        if readings is not None:
            out["readings"] = readings(eng, sessions, warm, cold.token_ids,
                                       logit_err)
    finally:
        eng.shutdown()
    out["seconds"] = time.monotonic() - t0
    emit(out)
    return out


# Bound A (ROADMAP §3 A): two bf16 roundings of one fp32 value may land one
# bf16 step apart, 2^-7 of the output's largest magnitude (or of 1).
BOUND_A_REL = 2.0 ** -7
TRAINED_BASE = os.path.join(ROOT, "resources", "checkpoints", "dv-base.npz")


def _bound_a(got, want) -> dict:
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = BOUND_A_REL * max(scale, 1.0)
    return {"max_abs_diff": err, "max_abs_out": scale, "bound_a": tol,
            "within": err <= tol}


def _prefix_layer_readings(params, cfg, ids, head_n, dev="cuda") -> list:
    """Each layer's attention output at positions ``head_n..n-1`` of
    ``ids`` on the two paths of a prefix resume, built from the model's own
    functions.  Cold: ``forward_prefill``'s flash attention (#2) over the
    whole prompt.  Warm: the head's K/V written by ``forward_prefill`` over
    the head, the rest as ``forward_prefill_chunk`` runs it, the paged
    chunk attention (#3) over the pages in chunks of 256.  ``stream``: each
    path on its own residual stream, as the engine runs them;
    ``same_input``: #3 given the cold path's q/k/v of that layer, so that
    only the two kernels differ; ``cold_vs_f32`` and ``warm_vs_f32``: each
    path's distance from the same layer of a float32 forward (the same
    weights, float32 activations, the plain attention), the size of the
    bf16 paths' own rounding."""
    from deepvision_tpu_torch.engine import model as m
    from deepvision_tpu_torch.engine.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )
    from deepvision_tpu_torch.engine.kernels.paged_chunk import (
        paged_chunk_attention,
    )
    from deepvision_tpu_torch.engine.kv_cache import (
        CacheConfig,
        init_cache,
        write_chunk_tokens,
        write_prefill_pages,
    )

    P, C, HD, L = 64, 256, cfg.head_dim, cfg.n_layers
    n = len(ids)
    S = -(-n // P) * P
    MP = S // P

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    toks = torch.zeros(1, S, dtype=torch.int32, device=dev)
    toks[0, :n] = i32(ids)
    lens = i32([n])
    bt = torch.arange(1, MP + 1, dtype=torch.int32, device=dev)[None]
    cache_cfg = CacheConfig(num_pages=MP + 1, page_size=P,
                            max_pages_per_seq=MP)

    def qkv(x, blk, rope, T):
        q, k, v = m._qkv_proj(m.rms_norm(x, blk["ln1"], cfg.rms_eps), blk,
                              cfg, x.dtype)
        return (m.apply_rope(q.reshape(1, T, -1, HD), rope),
                m.apply_rope(k.reshape(1, T, -1, HD), rope),
                v.reshape(1, T, -1, HD))

    def residual(x, attn, blk, T):
        x = x + m.qdot(attn.reshape(1, T, -1), blk["wo"],
                       torch.float32).to(x.dtype)
        return x + m._mlp(m.rms_norm(x, blk["ln2"], cfg.rms_eps), blk,
                          x.dtype)

    def chunks():
        for start in range(head_n, n, C):
            yield start, min(start + C, n) - start

    with torch.no_grad():
        rope = m.rope_tables(torch.arange(S, device=dev), HD, cfg.rope_theta)
        ref = []
        x = m._scaled_embed(params, toks, cfg, torch.float32)
        for i in range(L):
            blk = m._layer(params, i)
            q, k, v = qkv(x, blk, rope, S)
            attn = flash_attention_reference(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                lens).transpose(1, 2)
            ref.append(attn[0, head_n:n])
            x = residual(x, attn, blk, S)

        cold, cold_qkv = [], []
        x = m._scaled_embed(params, toks, cfg)
        for i in range(L):
            blk = m._layer(params, i)
            q, k, v = qkv(x, blk, rope, S)
            attn = flash_attention(
                q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), lens).transpose(1, 2)
            cold.append(attn[0, head_n:n])
            cold_qkv.append((q, k, v))
            x = residual(x, attn, blk, S)

        cache = init_cache(cfg, cache_cfg, device=dev)
        if head_n:
            m.forward_prefill(params, cache, toks[:, :head_n], i32([head_n]),
                              bt[:, : head_n // P], cfg=cfg)
        warm = [[] for _ in range(L)]
        for start, rows in chunks():
            chunk = torch.zeros(1, C, dtype=torch.int32, device=dev)
            chunk[:, :rows] = toks[:, start:start + rows]
            positions = start + torch.arange(C, device=dev)[None]
            rope = m.rope_tables(positions, HD, cfg.rope_theta)
            x = m._scaled_embed(params, chunk, cfg)
            for i in range(L):
                blk = m._layer(params, i)
                q, k, v = qkv(x, blk, rope, C)
                write_chunk_tokens(cache["k"][i], cache["v"][i], k, v, bt,
                                   positions, lens)
                attn = paged_chunk_attention(
                    q.contiguous(), cache["k"][i], cache["v"][i], bt,
                    i32([start]), i32([start + rows]))
                warm[i].append(attn[0, :rows])
                x = residual(x, attn, blk, C)

        pools = init_cache(cfg, cache_cfg, device=dev)
        layers = []
        for i in range(L):
            q, k, v = cold_qkv[i]
            write_prefill_pages(pools["k"][i], pools["v"][i], k, v, bt)
            same = []
            for start, rows in chunks():
                qc = torch.zeros(1, C, *q.shape[2:], dtype=q.dtype, device=dev)
                qc[:, :rows] = q[:, start:start + rows]
                same.append(paged_chunk_attention(
                    qc, pools["k"][i], pools["v"][i], bt, i32([start]),
                    i32([start + rows]))[0, :rows])
            warm_i = torch.cat(warm[i])
            layers.append({
                "layer": i,
                "stream": _bound_a(warm_i, cold[i]),
                "same_input": _bound_a(torch.cat(same), cold[i]),
                "cold_vs_f32": (cold[i].float() - ref[i]).abs().max().item(),
                "warm_vs_f32": (warm_i.float() - ref[i]).abs().max().item()})
    return layers


def _top2_gap(eng, ids, tokens, d, max_tokens) -> dict:
    """The gap between the two largest logits of the grammar-allowed next
    tokens after ``ids + tokens[:d]`` (the plain float32-softmax forward,
    the grammar state of ``tokens[:d]``, ``max_tokens - d`` tokens left, as
    the constrained sampler masks them)."""
    from deepvision_tpu_torch.engine import model as model_lib

    with torch.no_grad():
        logits = model_lib.forward_train(
            eng.runner.params,
            torch.tensor([list(ids) + list(tokens[:d])], dtype=torch.int32,
                         device=eng.device), cfg=eng.model_cfg)[0, -1]
    row = eng.runner._dfa_packed[eng.json_dfa.walk(tokens[:d])]
    allowed = ((row & 0xFFFF) - 1) >= 0
    can_close = allowed & ((row >> 16) <= max_tokens - d - 1)
    if can_close.any():
        allowed = can_close
    top = torch.where(allowed, logits, torch.full_like(logits, -1e30)).topk(2)
    return {"gap": (top.values[0] - top.values[1]).item(),
            "top2_tokens": top.indices.tolist(),
            "top2_logits": top.values.tolist()}


def _fault1_readings(eng, sessions, warm, cold, logit_err) -> dict:
    """ROADMAP §3 fault 1 on the engine's weights: the first token where the
    warm (resumed) and the cold run of session 0's turn 3 differ, the cold
    context's top-2 logit gap there, each layer's attention output on the
    two paths (:func:`_prefix_layer_readings`), and the verdict.

    Summation order when, in every layer, #3 and #2 on the same q/k/v are
    within bound A, and the two paths' own streams are either within bound
    A or each as close to the float32 forward as the other (the warm
    path's distance at most twice the cold path's); and a divergent
    token's top-2 gap is below the logits' error.  A fault otherwise, at
    the first layer that fails."""
    ids = sessions[0][2]
    head_n = len(sessions[0][1]) // 64 * 64
    layers = _prefix_layer_readings(eng.runner.params, eng.model_cfg, ids,
                                    head_n, dev=eng.device)
    d = next((k for k, (a, b) in enumerate(zip(warm, cold)) if a != b), None)
    gap = None
    if d is not None:
        gap = _top2_gap(eng, ids, cold, d, 128)
        gap.update(warm_token=warm[d], cold_token=cold[d])
    err = max(logit_err.values())
    kernels_apart = [r["layer"] for r in layers
                     if not r["same_input"]["within"]]
    streams_apart = [r["layer"] for r in layers if not r["stream"]["within"]]
    paths_unlike = [r["layer"] for r in layers if not (
        r["stream"]["within"] or r["warm_vs_f32"] <= 2 * r["cold_vs_f32"])]
    if kernels_apart:
        verdict = (f"fault: #3 and #2 on the same inputs out of bound A from "
                   f"layer {kernels_apart[0]}")
    elif paths_unlike:
        verdict = (f"fault: the warm path drifts from the float32 forward "
                   f"from layer {paths_unlike[0]}")
    elif gap is not None and not gap["gap"] < err:
        verdict = "fault: the divergent token's top-2 gap >= logit_err"
    else:
        verdict = "summation order"
    return {"first_divergence": d, "top2_at_divergence": gap,
            "logit_err_max": err, "resume_head_tokens": head_n,
            "resumed_positions": len(ids) - head_n, "layers": layers,
            "same_input_out_of_bound_a": kernels_apart,
            "stream_out_of_bound_a": streams_apart,
            "warm_drifts_from_f32": paths_unlike, "verdict": verdict}


def phase_engine_prefix_trained() -> dict:
    """Phase ``engine_prefix`` on the trained dv-base checkpoint, with the
    readings that classify ROADMAP §3 fault 1 (:func:`_fault1_readings`).
    The verdict is reported, not asserted: a fault is repaired in the
    port, not here."""
    return phase_engine_prefix(checkpoint=TRAINED_BASE,
                               phase="engine_prefix_trained",
                               readings=_fault1_readings)


def phase_paged_api() -> dict:
    """Kernels #6 and #7 through their own entry point, the kernels
    package's public paged attention, driven as a caller would: 16 decode
    steps over dv-base's 12 layers at the report lane's shape (B=8, H=6,
    KV=2, HD=128, P=64, 32 pages per sequence, bf16 pools) from contexts of
    600-950 tokens.  Each layer writes its step's row through
    ``paged_attention_update(grid_mode="bkv")`` (#7) and reads the pools
    back through ``paged_attention`` (#6); the same step runs through grid
    "b" (#1) on a copy of the pools.  #6 must equal #7 bit for bit (one
    kernel template over the same pools), #7 must agree with #1 and leave
    the same pools outside trash page 0, and each entry point must have
    launched once per layer and step."""
    from deepvision_tpu_torch.engine.kernels import paged_attention

    pa = importlib.import_module(
        "deepvision_tpu_torch.engine.kernels.paged_attention")
    t0 = time.monotonic()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    B, H, KV, HD, P, MP, layers, steps = 8, 6, 2, 128, 64, 32, 12, 16
    N = B * MP + 1
    bf16 = torch.bfloat16
    pools = [tuple(torch.randn(KV, N, P, HD, generator=gen, device=dev)
                   .to(bf16) for _ in range(2)) for _ in range(layers)]
    copies = [(k.clone(), v.clone()) for k, v in pools]
    bt = (1 + torch.randperm(B * MP, generator=gen, device=dev)
          ).reshape(B, MP).to(torch.int32)
    seq = torch.tensor([600 + 50 * i for i in range(B)], dtype=torch.int32,
                       device=dev)
    paged_attention.launches = 0
    pa.paged_attention_update.bkv_launches = 0
    err_b, same_6_7 = 0.0, True
    for _ in range(steps):
        for (kp, vp), (kb, vb) in zip(pools, copies):
            q = torch.randn(B, H, HD, generator=gen, device=dev).to(bf16)
            nk = torch.randn(B, KV, HD, generator=gen, device=dev).to(bf16)
            nv = torch.randn(B, KV, HD, generator=gen, device=dev).to(bf16)
            out7, _, _ = pa.paged_attention_update(q, nk, nv, kp, vp, bt, seq,
                                                   grid_mode="bkv")
            out6 = paged_attention(q, kp, vp, bt, seq)
            out1, _, _ = pa.paged_attention_update(q, nk, nv, kb, vb, bt, seq)
            same_6_7 = same_6_7 and torch.equal(out6, out7)
            err_b = max(err_b, (out7.float() - out1.float()).abs().max().item())
        seq += 1
    torch.cuda.synchronize()
    launches = {"paged_attention": paged_attention.launches,
                "paged_update_bkv": pa.paged_attention_update.bkv_launches}
    if set(launches.values()) != {layers * steps}:
        raise AssertionError(f"paged_api: launches {launches}, expected "
                             f"{layers * steps} each")
    if not same_6_7:
        raise AssertionError("paged_api: paged_attention differs from the "
                             "bkv update over the same pools")
    # bf16 outputs of two kernels summing in another order (2^-8 of O(1))
    if not err_b <= 2e-2:
        raise AssertionError(f"paged_api: bkv against grid b {err_b}")
    for (kp, vp), (kb, vb) in zip(pools, copies):
        if not (torch.equal(kp[:, 1:], kb[:, 1:])
                and torch.equal(vp[:, 1:], vb[:, 1:])):
            raise AssertionError("paged_api: pools differ outside page 0")
    out = {"phase": "paged_api", "shape": [B, H, KV, HD, P, MP],
           "layers": layers, "steps": steps,
           "start_lens": [600 + 50 * i for i in range(B)],
           "launches": launches, "paged_equals_bkv": True,
           "max_abs_err_bkv_vs_grid_b": err_b, "tol": 2e-2,
           "seconds": time.monotonic() - t0}
    emit(out)
    return out


# The app's lane models: dv-fast on the question lanes, dv-base on the
# report lanes (deepvision_tpu/web/server.py); named, since "auto" picks
# from the in-repo checkpoints, which a copy without ``*.npz`` lacks.
GATEWAY_MODELS = {
    "AI_MODE": "engine", "QUESTION_MODEL_NAME": "dv-fast",
    "REPORT_MODEL_NAME": "dv-base", "REPORT_DRAFT_MODEL_NAME": "dv-base",
    "REPORT_REVIEW_MODEL_NAME": "dv-base",
}


def _question_prompts():
    """An interview's next-question prompt (the topic, a scenario
    dimension, eight answered rounds) and its follow-up turn: the same
    text plus one more answer, so the follow-up shares its head."""
    files = sorted(glob.glob(os.path.join(ROOT, "resources", "scenarios",
                                          "builtin", "*.json")))
    with open(files[0], encoding="utf-8") as fh:
        sc = json.load(fh)
    dims = sc["dimensions"]
    head = (f"你是一名资深需求访谈顾问，正在进行结构化访谈。\n\n"
            f"访谈主题：{sc['name']}\n{sc['description']}\n\n【访谈记录】\n")
    rounds = "".join(
        f"问题{r + 1}（{dims[r % len(dims)]['name']}）：请具体说明"
        f"{dims[r % len(dims)]['description']}。\n回答：关于"
        f"{'、'.join(dims[r % len(dims)]['key_aspects'])}，现场确认了现状与期望。\n"
        for r in range(8))
    tail = (f"\n当前维度：{dims[0]['name']}（关注要点："
            f"{'、'.join(dims[0]['key_aspects'])}）\n\n"
            "请生成下一个访谈问题，输出 JSON：{\"question\": \"...\", "
            "\"options\": [...]}")
    follow = (f"问题9（{dims[1 % len(dims)]['name']}）：请补充说明。\n"
              f"回答：{dims[1 % len(dims)]['description']}，已有初步方案。\n")
    return head + rounds + tail, head + rounds + follow + tail


def _gateway_boot(extra=None):
    """``build_gateway`` with the app's defaults and the lane models; waits
    until the report-only engine's background warmup is done too."""
    from deepvision_tpu_torch.web.gateway import build_gateway

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    gw = build_gateway({**GATEWAY_MODELS, **(extra or {})})
    boot_fg = time.monotonic() - t0
    for eng in gw.engines.values():
        eng.start()
    boot = {"foreground_s": boot_fg, "all_s": time.monotonic() - t0}
    if set(gw.engines) != {"dv-fast", "dv-base"}:
        raise AssertionError(f"gateway engines {set(gw.engines)}")
    lanes = {k: v.engine for k, v in gw.lanes.items()}
    want = {"question": "dv-fast", "question_fast": "dv-fast",
            "question_deep": "dv-fast", "report": "dv-base",
            "report_draft": "dv-base", "report_review": "dv-base"}
    if any(lanes[k] != v for k, v in want.items()):
        raise AssertionError(f"lane models {lanes}")
    steps = {m: e.cfg.decode_steps_per_call for m, e in gw.engines.items()}
    if steps != {"dv-fast": 8, "dv-base": 16}:
        raise AssertionError(f"decode steps per call {steps}")
    return gw, boot, lanes, steps


def _document_chunks(n=20):
    """``n`` reference-material chunks (one per scenario dimension: its
    name, description and key aspects, under the scenario's topic) and a
    query, as the app's document retrieval embeds them."""
    files = sorted(glob.glob(os.path.join(ROOT, "resources", "scenarios",
                                          "builtin", "*.json")))
    chunks = []
    for path in files:
        with open(path, encoding="utf-8") as fh:
            sc = json.load(fh)
        for d in sc["dimensions"]:
            chunks.append(f"{sc['name']}：{sc['description']}\n{d['name']}——"
                          f"{d['description']}。关注要点："
                          f"{'、'.join(d['key_aspects'])}。")
    if len(chunks) < n:
        raise AssertionError(f"only {len(chunks)} scenario dimensions")
    return chunks[:n], "采购项目的预算区间和时间窗口怎么确认？"


def _call(gw, prompt, call_type, lane, model, **kw):
    text, meta = gw.call_model(prompt, call_type, return_meta=True, **kw)
    json.loads(text)  # raises on unparseable output
    if (meta["lane"], meta["model"]) != (lane, model):
        raise AssertionError(f"{call_type}: lane/model {meta}")
    if meta["completion_tokens"] <= 0:
        raise AssertionError(f"{call_type}: empty completion {meta}")
    return text, meta


def _shutdown(gw):
    for eng in gw.engines.values():
        eng.shutdown()


def phase_gateway() -> dict:
    """The app's main path through the port: ``build_gateway`` (dv-fast on
    the question lanes, dv-base on the report lanes, the app's other
    defaults: 32 slots, 1,024 pages of 64, chunked prefill, bf16 KV) ->
    ``call_model`` -> lanes -> ``LLMEngine.generate_text`` -> scheduler ->
    runner -> kernels.  One question (128 tokens, the lane's sampling), one
    report draft (256 tokens, greedy) and the session's follow-up question,
    which resumes through the prefix cache; every text must parse and the
    flash, decode and chunk kernels must have run."""
    from deepvision_tpu_torch.engine.kernels.flash_attention import (
        flash_attention,
    )
    from deepvision_tpu_torch.engine.kernels.paged_attention import (
        paged_attention_update,
    )
    from deepvision_tpu_torch.engine.kernels.paged_chunk import (
        paged_chunk_attention,
    )

    t0 = time.monotonic()
    gw, boot, lanes, steps = _gateway_boot()
    try:
        q_prompt, follow_prompt = _question_prompts()
        r_prompt = _report_prompts(gw.engines["dv-base"].tokenizer, [800])[0]
        ctx = {"session_id": "dv-smoke-session-1"}
        counters = (flash_attention, paged_attention_update,
                    paged_chunk_attention)
        for fn in counters:
            fn.launches = 0
        _, meta_q = _call(gw, q_prompt, "question", "question", "dv-fast",
                          max_tokens=128, context=ctx)
        text_r, meta_r = _call(gw, r_prompt, "report_draft", "report_draft",
                               "dv-base", max_tokens=256, temperature=0.0,
                               context=ctx)
        chunk_before = paged_chunk_attention.launches
        _, meta_f = _call(gw, follow_prompt, "question", "question",
                          "dv-fast", max_tokens=128, context=ctx)
        launches = {"flash_fwd": flash_attention.launches,
                    "paged_decode_update": paged_attention_update.launches,
                    "paged_chunk": paged_chunk_attention.launches}
        follow_chunk = paged_chunk_attention.launches - chunk_before
        prefix = gw.engines["dv-fast"].stats()["prefix_cache"]
        if min(launches["flash_fwd"], launches["paged_decode_update"]) <= 0:
            raise AssertionError(f"gateway: a kernel was not launched "
                                 f"{launches}")
        if follow_chunk <= 0 or prefix["hits"] < 1:
            raise AssertionError(f"gateway: the follow-up did not resume "
                                 f"through the prefix cache ({prefix}, "
                                 f"{follow_chunk} chunk launches)")
        report_ids = gw.engines["dv-base"].tokenizer.encode(text_r)
        # the app's document retrieval: reference chunks and a query
        # embedded through the gateway (the first engine's serving params,
        # the flash forward kernel)
        chunks, query = _document_chunks()
        flash_before = flash_attention.launches
        t_e = time.monotonic()
        embs = gw.embed_texts(chunks + [query])
        embed_s = time.monotonic() - t_e
        d_model = next(iter(gw.engines.values())).model_cfg.d_model
        if embs is None or embs.shape != (len(chunks) + 1, d_model):
            raise AssertionError(f"gateway.embed_texts: got "
                                 f"{None if embs is None else embs.shape}")
        norms = np.linalg.norm(embs, axis=-1)
        if not np.isfinite(embs).all() or np.abs(norms - 1).max() > 1e-3:
            raise AssertionError(f"gateway.embed_texts: norms {norms}")
        embed_flash = flash_attention.launches - flash_before
        if embed_flash <= 0:
            raise AssertionError("gateway.embed_texts did not launch the "
                                 "flash forward kernel")
        out = {
            "phase": "gateway", "boot": boot, "lanes": lanes,
            "decode_steps_per_call": steps,
            "max_slots": {m: e.cfg.max_slots for m, e in gw.engines.items()},
            "checkpoints": {m: e.cfg.checkpoint_dir
                            for m, e in gw.engines.items()},
            "meta": {"question": meta_q, "report_draft": meta_r,
                     "follow_up": meta_f},
            "launches": launches, "follow_up_chunk_launches": follow_chunk,
            "prefix_cache_dv_fast": prefix, "json_parsed": 3,
            "embed": {"texts": len(chunks) + 1, "d_model": d_model,
                      "seconds": embed_s, "flash_launches": embed_flash,
                      "max_norm_err": float(np.abs(norms - 1).max()),
                      "top3_chunks": [int(i) for i in np.argsort(
                          -(embs[:-1] @ embs[-1]))[:3]]},
        }
    finally:
        _shutdown(gw)
    out["seconds"] = time.monotonic() - t0
    emit(out)
    out["report_text"], out["report_ids"] = text_r, report_ids
    return out


def phase_gateway_int8(bf16) -> dict:
    """The report draft of phase ``gateway`` again, through a gateway with
    ``ENGINE_KV_QUANTIZE=int8`` (every engine calibrates its static scales
    at boot): the JSON must parse; the scales' range and the first token
    where the output leaves the bf16 run's are reported, not judged."""
    t0 = time.monotonic()
    gw, boot, _, _ = _gateway_boot({"ENGINE_KV_QUANTIZE": "int8"})
    try:
        eng = gw.engines["dv-base"]
        if not eng.cache_cfg.quantized or eng.runner.cache["k"][0].dtype \
                != torch.int8:
            raise AssertionError("gateway_int8: the pools are not int8")
        r_prompt = _report_prompts(eng.tokenizer, [800])[0]
        text, meta = _call(gw, r_prompt, "report_draft", "report_draft",
                           "dv-base", max_tokens=256, temperature=0.0,
                           context={"session_id": "dv-smoke-session-1"})
        ids = eng.tokenizer.encode(text)
        ref = bf16["report_ids"]
        first_diff = _first_diff(ids, ref)
        ks, vs = eng.kv_scales
        out = {
            "phase": "gateway_int8", "boot": boot, "meta": meta,
            "json_parsed": 1,
            "k_scale_range": [ks.min().item(), ks.max().item()],
            "v_scale_range": [vs.min().item(), vs.max().item()],
            "first_token_differing_from_bf16": first_diff,
            "tokens": len(ids), "bf16_tokens": len(ref),
        }
    finally:
        _shutdown(gw)
    out["seconds"] = time.monotonic() - t0
    emit(out)
    return out


W8_SETTINGS = (
    ("fused", {"fuse_projections": True}),
    ("int8_fused", {"quantize": "int8", "fuse_projections": True}),
    ("int8_fused_pipelined", {"quantize": "int8", "fuse_projections": True,
                              "pipeline_decode": True,
                              "max_chained_decodes": 4}),
)


def _q8_check() -> dict:
    """``qdot``'s int8 form on the card (one bf16 GEMM with a float32
    output, ``torch.mm(..., out_dtype=torch.float32)``) against the float32
    product of the same bf16 values, scaled, at the decode batch and
    dv-base's fused gate|up width."""
    from deepvision_tpu_torch.engine import model as model_lib
    from deepvision_tpu_torch.engine.quant import quantize_weight

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    x = torch.randn(8, 768, generator=g, device="cuda").bfloat16()
    qw = quantize_weight(torch.randn(768, 4096, generator=g, device="cuda")
                         / 768 ** 0.5)
    got = model_lib.qdot(x, qw, torch.float32)
    want = (x.float() @ qw["q8"].float()) * qw["scale"]
    err = (got - want).abs().max().item()
    # exact products on both sides; the float32 sums' order may differ
    tol = 1e-5 * want.abs().max().item()
    if got.dtype != torch.float32 or not err <= tol:
        raise AssertionError(f"int8 qdot on the card: {err} > {tol}")
    return {"max_abs_err": err, "tol": tol}


def phase_engine_w8(base) -> dict:
    """Phase ``engine``'s traffic (dv-base, random weights from the seed,
    8 json_mode report prompts of 300-900 tokens, 256 new, greedy, K=16)
    under three serving settings: fused projections; int8 weights, fused;
    the same, pipelined (4 chained calls).  Every output must parse, the
    int8 block weights must take at most 0.55x the bf16 bytes, and prompt
    0 replayed alone must give the same tokens int8 and int8 pipelined
    (the same batches).  Parameter bytes, the decode step, kernel launches
    a decode step (beside phase ``engine``'s unfused bf16 count), the
    pipelined readback wait and the first token that differs from phase
    ``engine``'s output are reported."""
    from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine
    from deepvision_tpu_torch.engine.fuse import is_fused
    from deepvision_tpu_torch.engine.kernels.flash_attention import (
        flash_attention,
    )
    from deepvision_tpu_torch.engine.kernels.paged_attention import (
        paged_attention_update,
    )
    from deepvision_tpu_torch.engine.quant import is_quantized
    from deepvision_tpu_torch.engine.weights import param_bytes

    t0 = time.monotonic()
    q8 = _q8_check()
    tok_path = os.path.join(ROOT, "resources", "tokenizer", "dv_bpe_16k.json")
    targets = [300, 380, 460, 540, 620, 700, 800, 900]
    settings = {}
    for name, setting in W8_SETTINGS:
        t_set = time.monotonic()
        eng = LLMEngine(EngineConfig(
            model="dv-base", tokenizer=tok_path, checkpoint_dir=None,
            device="cuda", max_slots=8, num_pages=1024, page_size=64,
            max_pages_per_seq=32, decode_steps_per_call=16,
            chunked_prefill=False, json_dfa=True, warmup=True, seed=SEED,
            **setting))
        try:
            boot_s = time.monotonic() - t_set
            eng.start()
            params = eng.runner.params
            if not is_fused(params) or is_quantized(params) != (
                    "quantize" in setting):
                raise AssertionError(f"{name}: params not transformed")
            prompts = _report_prompts(eng.tokenizer, targets)

            def run(p):
                return eng.generate_text(p, max_tokens=256, temperature=0.0,
                                         json_mode=True, timeout=600)

            flash_attention.launches = 0
            paged_attention_update.launches = 0
            t_serve = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
                results = list(ex.map(run, prompts))
            serve_s = time.monotonic() - t_serve
            launches = {"flash_fwd": flash_attention.launches,
                        "paged_decode_update": paged_attention_update.launches}
            if min(launches.values()) <= 0:
                raise AssertionError(f"{name}: a kernel was not launched: "
                                     f"{launches}")
            for text, meta in results:
                json.loads(text)  # raises on unparseable output
                if meta["completion_tokens"] <= 0:
                    raise AssertionError(f"{name}: empty completion {meta}")
            stats = eng.stats()
            sched = eng.scheduler
            replay = None
            if "quantize" in setting:
                res = eng.submit_tokens(eng.tokenizer.encode(prompts[0]),
                                        max_tokens=256, temperature=0.0,
                                        json_mode=True).wait(600)
                if res is None or not res.ok:
                    raise AssertionError(f"{name}: replay failed: {res}")
                replay = res.token_ids
            enc = eng.tokenizer.encode
            completion = sum(m["completion_tokens"] for _, m in results)
            settings[name] = {
                "setting": setting, "boot_s": boot_s,
                "param_bytes": param_bytes(params),
                "block_bytes": param_bytes(params["blocks"]),
                "json_parsed": len(results), "serve_s": serve_s,
                "completion_tokens": completion,
                "decode_tokens_per_s": completion / serve_s,
                "decode_ms_per_step": stats["decode_time_s"] * 1e3
                / max(1, stats["decode_steps"]),
                "decode_steps": stats["decode_steps"],
                "readback_wait_s": sched.readback_wait_s,
                "readback_wait_ms_per_step": sched.readback_wait_s * 1e3
                / max(1, stats["decode_steps"]),
                "ttft_ms_p50": sorted(m["queue_wait_ms"] + m["prefill_ms"]
                                      for _, m in results)[len(results) // 2],
                "launches": launches,
                "decode_profile": _decode_profile(eng),
                "first_token_differing_from_engine": [
                    _first_diff(enc(text), enc(ref)) for (text, _), ref
                    in zip(results, base["texts"])],
                "replay_first_diff_from_engine": (
                    None if replay is None
                    else _first_diff(replay, base["replay_ids"])),
                "texts": [text for text, _ in results], "replay": replay,
            }
        finally:
            eng.shutdown()
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
        settings[name]["seconds"] = time.monotonic() - t_set

    b, c = settings["int8_fused"], settings["int8_fused_pipelined"]
    if b["replay"] != c["replay"]:
        raise AssertionError(
            f"pipelined int8 replay differs from int8 at token "
            f"{_first_diff(b['replay'], c['replay'])}")
    ratio = b["block_bytes"] / settings["fused"]["block_bytes"]
    if not ratio <= 0.55:
        raise AssertionError(f"int8 block bytes are {ratio:.3f}x bf16")
    concurrent_same = b["texts"] == c["texts"]
    for v in settings.values():
        del v["texts"], v["replay"]
    out = {"phase": "engine_w8", "model": "dv-base",
           "weights": f"random (seed {SEED})", "q8_qdot_check": q8,
           "settings": settings, "int8_block_bytes_ratio": ratio,
           "unfused_bf16": {"param_bytes": base["param_bytes"],
                            "block_bytes": base["block_bytes"],
                            "decode_ms_per_step": base["decode_ms_per_step"],
                            "decode_profile": base["decode_profile"]},
           "pipelined_replay_equals_int8": True,
           "pipelined_concurrent_texts_equal_int8": concurrent_same,
           "seconds": time.monotonic() - t0}
    emit(out)
    return out


def phase_gateway_w8(bf16) -> dict:
    """The app's gateway with ``ENGINE_QUANTIZE=int8``,
    ``ENGINE_FUSE_PROJECTIONS=1`` and ``ENGINE_PIPELINE_DECODE=1`` over
    its defaults: every engine must serve int8, fused and pipelined; a
    question and the report draft must parse; ``embed_texts`` must give
    None on those params (as in the JAX app).  Boot time, each call's meta
    and the report's first token that differs from phase ``gateway``'s
    are reported."""
    from deepvision_tpu_torch.engine.fuse import is_fused
    from deepvision_tpu_torch.engine.quant import is_quantized
    from deepvision_tpu_torch.engine.weights import param_bytes

    t0 = time.monotonic()
    gw, boot, _, _ = _gateway_boot({"ENGINE_QUANTIZE": "int8",
                                    "ENGINE_FUSE_PROJECTIONS": "1",
                                    "ENGINE_PIPELINE_DECODE": "1"})
    try:
        for m, eng in gw.engines.items():
            p = eng.runner.params
            if not (is_quantized(p) and is_fused(p)
                    and eng.scheduler.pipeline_decode):
                raise AssertionError(f"gateway_w8: {m} is not int8, fused "
                                     f"and pipelined")
        ctx = {"session_id": "dv-smoke-session-w8"}
        q_prompt, _ = _question_prompts()
        base = gw.engines["dv-base"]
        r_prompt = _report_prompts(base.tokenizer, [800])[0]
        _, meta_q = _call(gw, q_prompt, "question", "question", "dv-fast",
                          max_tokens=128, context=ctx)
        text, meta_r = _call(gw, r_prompt, "report_draft", "report_draft",
                             "dv-base", max_tokens=256, temperature=0.0,
                             context=ctx)
        engine_embeds = {m: eng.embed_texts(["采购预算"])
                         for m, eng in gw.engines.items()}
        gateway_embed = gw.embed_texts(["采购预算"])
        if gateway_embed is not None or any(
                v is not None for v in engine_embeds.values()):
            raise AssertionError("gateway_w8: embed_texts gave vectors on "
                                 "int8/fused params")
        ids = base.tokenizer.encode(text)
        out = {
            "phase": "gateway_w8", "boot": boot,
            "meta": {"question": meta_q, "report_draft": meta_r},
            "json_parsed": 2,
            "param_bytes": {m: param_bytes(e.runner.params)
                            for m, e in gw.engines.items()},
            "readback_wait_s": {m: e.scheduler.readback_wait_s
                                for m, e in gw.engines.items()},
            "embed_texts": {"engines": {m: None for m in engine_embeds},
                            "gateway": None},
            "first_token_differing_from_bf16": _first_diff(
                ids, bf16["report_ids"]),
            "tokens": len(ids), "bf16_tokens": len(bf16["report_ids"]),
        }
    finally:
        _shutdown(gw)
    out["seconds"] = time.monotonic() - t0
    emit(out)
    return out


# The app's settings for phase ``app``: the lane models on random weights
# from the engines' seed, the mock SMS login, and one admin (for
# /api/metrics); every other setting is the app's default.  A checkout of
# the repo holds trained checkpoints of both models, which the app would
# load by default; os.devnull names no checkpoint, so ``load_or_init``
# gives random weights from ``EngineConfig.seed`` in every checkout.
APP_SETTINGS = {
    **GATEWAY_MODELS, "ENGINE_CHECKPOINT_DIR": os.devnull,
    "SMS_PROVIDER": "mock", "SMS_TEST_CODE": "666666",
    "ADMIN_PHONE_NUMBERS": "13800000001", "SMS_SEND_COOLDOWN_SECONDS": "0",
}
APP_USER_PHONE = "13900000001"
# Random weights never close their JSON, so each call runs to its token
# cap; the caps bound the phase's time (the app's lanes allow up to 8,000;
# 256 until phase engine_tp took its share of the run's time).
APP_MAX_TOKENS = 128
APP_SERVER_STEP_S = 90.0


def _reference_markdown():
    """A reference document of several KB, in the app's markdown, from the
    in-repo scenarios: one section a scenario, one paragraph a dimension."""
    parts = ["# 业务背景资料\n"]
    for path in sorted(glob.glob(os.path.join(ROOT, "resources", "scenarios",
                                              "builtin", "*.json"))):
        with open(path, encoding="utf-8") as fh:
            sc = json.load(fh)
        parts.append(f"\n## {sc['name']}\n\n{sc['description']}\n")
        for d in sc["dimensions"]:
            parts.append(f"\n### {d['name']}\n\n{d['description']}。现场访谈"
                         f"关注：{'、'.join(d['key_aspects'])}。各区域仓库"
                         "的出入库流程依赖纸质单据，月末盘点差异需要人工核对。\n")
    return "".join(parts)


def _settle_app_threads(timeout_s: float = 300.0) -> float:
    """Wait for the app's background question prefetches and session
    summaries; returns the seconds waited."""
    t0 = time.monotonic()
    for t in threading.enumerate():
        if t.name.startswith(("dv-prefetch-", "dv-summary-")):
            t.join(max(0.0, timeout_s - (time.monotonic() - t0)))
            if t.is_alive():
                raise AssertionError(f"app: {t.name} still running after "
                                     f"{timeout_s} s")
    return time.monotonic() - t0


def _app_server_step(port_tmp: str) -> dict:
    """``python -m deepvision_tpu_torch.web.server`` in a subprocess on a
    free port of 127.0.0.1 (engine mode on the card, the lane models and
    the mock SMS login in its environment): poll ``/api/status`` until the
    engines are up, log in and ask one question over real HTTP (it must
    get 200), then stop the server and check that it exits."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    env = dict(os.environ, **APP_SETTINGS,
               QUESTION_FAST_MAX_TOKENS=str(APP_MAX_TOKENS))
    env.pop("DEEPVISION_TPU_TESTING", None)  # warmup on, as served
    log_path = os.path.join(port_tmp, "server.log")
    cookies = {}

    def call(method, path, body=None, timeout=30.0):
        data = None if body is None else json.dumps(body).encode("utf-8")
        req = urllib.request.Request(base + path, data=data, method=method)
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if cookies:
            req.add_header("Cookie", "; ".join(f"{k}={v}"
                                               for k, v in cookies.items()))
        t = time.monotonic()
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                status, raw, headers = r.status, r.read(), r.headers
        except urllib.error.HTTPError as e:
            status, raw, headers = e.code, e.read(), e.headers
        for c in headers.get_all("Set-Cookie") or []:
            name, _, value = c.split(";", 1)[0].partition("=")
            cookies[name.strip()] = value.strip()
        return status, json.loads(raw or b"null"), (time.monotonic() - t) * 1e3

    t0 = time.monotonic()
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "deepvision_tpu_torch.web.server",
             "--host", "127.0.0.1", "--port", str(port),
             "--data-dir", os.path.join(port_tmp, "data")],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    out = {"port": port, "requests": {}}
    models = {APP_SETTINGS["QUESTION_MODEL_NAME"],
              APP_SETTINGS["REPORT_MODEL_NAME"]}
    try:
        up = None
        while up is None:
            if proc.poll() is not None:
                raise AssertionError(f"app server exited with "
                                     f"{proc.returncode} before serving")
            if time.monotonic() - t0 > APP_SERVER_STEP_S:
                raise AssertionError(f"app server not up after "
                                     f"{APP_SERVER_STEP_S} s")
            try:
                status, body, _ = call("GET", "/api/status", timeout=2.0)
            except (urllib.error.URLError, ConnectionError, OSError):
                time.sleep(0.5)
                continue
            if (status == 200 and body["ai_mode"] == "engine"
                    and set(body["engine"]) == models):
                up = body
        out["up_s"] = time.monotonic() - t0
        steps = [
            ("send_code", "POST", "/api/auth/sms/send-code",
             {"phone": APP_USER_PHONE}, 200),
            ("login", "POST", "/api/auth/login/code",
             {"phone": APP_USER_PHONE, "code": "666666"}, 200),
            ("create_session", "POST", "/api/sessions",
             {"topic": "仓储管理系统选型", "scenario_id": "product-requirement",
              "interview_mode": "quick"}, 201),
        ]
        sid = None
        for name, method, path, body, want in steps:
            status, got, ms = call(method, path, body)
            out["requests"][name] = {"status": status, "ms": ms}
            if status != want:
                raise AssertionError(f"app server {name}: {status} {got}")
            sid = got.get("session_id", sid) if isinstance(got, dict) else sid
        left = APP_SERVER_STEP_S - (time.monotonic() - t0)
        status, q, ms = call("POST", f"/api/sessions/{sid}/next-question", {},
                             timeout=max(left, 5.0))
        out["requests"]["next_question"] = {
            "status": status, "ms": ms,
            "ai_generated": (q or {}).get("ai_generated"),
            "tier": (q or {}).get("question_generation_tier")}
        if status != 200 or not q.get("question"):
            raise AssertionError(f"app server next-question: {status} {q}")
    finally:
        proc.terminate()
        try:
            out["exit_code"] = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
            raise AssertionError("app server did not exit on SIGTERM")
        out["seconds"] = time.monotonic() - t0
        with open(log_path, "rb") as fh:
            out["log_tail"] = fh.read().decode(
                "utf-8", "replace").splitlines()[-8:]
        if sys.exc_info()[0] is not None:      # failing: show the server
            print("\n".join(out["log_tail"]), file=sys.stderr, flush=True)
    return out


# The question lanes' calls whose prompt carries the session's document
# head (build_interview_prompt leaves it out of the fast tier's prompt).
FULL_TIER_CALLS = ("question", "question_deep")


def _second_question_path(q2, chunk_launches, cache_hits, earlier_calls,
                          calls) -> dict:
    """Hold the second question's model work to the app's path.

    Its calls resume a cached prompt head, through the paged chunk
    attention (#3), when the prompt shares a full page with a prompt that
    dv-fast already ran: the full tier's prompt shares the document head
    with any earlier full-tier prompt of the session.  The fast tier's
    prompt has no document, and the full tier runs only when the app
    refuses the fast tier's text.  That refusal depends on the weights
    and the draws: trained weights give questions the app takes, and even
    random text with a "?" in it passes ``parse_question_response``'s
    plain-text rule; then the question needs no resume.  So: every
    prefix-cache hit of dv-fast ran #3 and #3 ran for nothing else (no
    prompt here is long enough for the interleaved prefill), a full-tier
    call after an earlier one hit the cache, and without a full-tier call
    the fast tier gave the question."""
    tiers = [c["call_type"] for c in calls]
    full = any(t in FULL_TIER_CALLS for t in tiers)
    out = {"prefetched": bool(q2.get("prefetched")),
           "follow_up": bool(q2.get("is_follow_up")),
           "tier": q2.get("question_generation_tier"), "calls": tiers,
           "prefix_cache_hits": cache_hits, "chunk_launches": chunk_launches}
    if (cache_hits > 0) != (chunk_launches > 0):
        raise AssertionError(f"app: the second question's prefix-cache hits "
                             f"and paged chunk launches disagree ({out})")
    if full and any(c["call_type"] in FULL_TIER_CALLS
                    for c in earlier_calls) and cache_hits <= 0:
        raise AssertionError(f"app: the second question's full tier did not "
                             f"resume the session's document head ({out})")
    if not full and out["tier"] != "fast":
        raise AssertionError(f"app: the second question ran no full tier "
                             f"and the fast tier did not give it ({out})")
    return out


def phase_app() -> dict:
    """The interview app on the card, through the port's entry points.

    In process: ``create_app`` (engine mode on CUDA: dv-fast on the
    question lanes, dv-base on the report lanes, both on random weights
    from the seed (``APP_SETTINGS``), the app's defaults of 32
    slots, 1,024 pages of 64, chunked prefill, K = 8 / 16, warmup on) and
    its test client: login, a session, a reference document of several KB
    (chunked and summarised), the interview assistant (which embeds the
    chunks), next-question, submit-answer and a second next-question,
    generate-report polled to completion, the report, a docx export,
    ``/api/status`` and ``/api/metrics`` (admin).  Every response must have
    the status the JAX app's tests expect, the report job must complete,
    and the flash forward (#2), the decode step (#1) and the paged chunk
    attention (#3) must each have been launched by the HTTP traffic (#3
    at least by the report's second and third drafts, which resume the
    first one's prompt); the second question's model work (in its
    request, or in the background prefetch the app starts after
    submit-answer) must follow the app's path
    (:func:`_second_question_path`).
    Each request's latency and launches, the AI calls' lanes and models
    and each answer's ``ai_generated`` are reported.  Then the real entry
    point, ``python -m deepvision_tpu_torch.web.server``, answers a
    question over HTTP (:func:`_app_server_step`)."""
    from deepvision_tpu_torch.engine.client import (
        ModelGateway,
        configure_gateway,
    )
    from deepvision_tpu_torch.engine.kernels.flash_attention import (
        flash_attention,
    )
    from deepvision_tpu_torch.engine.kernels.paged_attention import (
        paged_attention_update,
    )
    from deepvision_tpu_torch.engine.kernels.paged_chunk import (
        paged_chunk_attention,
    )
    from deepvision_tpu_torch.web.server import create_app

    counters = {"flash_fwd": flash_attention,
                "paged_decode_update": paged_attention_update,
                "paged_chunk": paged_chunk_attention}

    def launches():
        return {k: fn.launches for k, fn in counters.items()}

    def delta(before):
        now = launches()
        return {k: now[k] - before[k] for k in now}

    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="dv-app-")
    try:
        app = create_app(data_dir=os.path.join(tmp, "data"), overrides={
            **APP_SETTINGS, "QUESTION_FAST_MAX_TOKENS": APP_MAX_TOKENS})
        state = app.state
        gw = state.gateway
        boot_fg = time.monotonic() - t0
        for eng in gw.engines.values():
            eng.start()              # the report-only engine's warmup too
        boot = {"foreground_s": boot_fg, "all_s": time.monotonic() - t0}
        try:
            lanes = {k: v.engine for k, v in gw.lanes.items()}
            want = {"question": "dv-fast", "question_fast": "dv-fast",
                    "report_draft": "dv-base", "report_review": "dv-base"}
            if any(lanes[k] != v for k, v in want.items()):
                raise AssertionError(f"app lane models {lanes}")
            steps = {m: e.cfg.decode_steps_per_call
                     for m, e in gw.engines.items()}
            cfgs = {m: (e.cfg.max_slots, e.cfg.num_pages, e.cfg.page_size,
                        e.cfg.chunked_prefill, e.cfg.warmup,
                        e.cfg.checkpoint_dir, e.cfg.seed)
                    for m, e in gw.engines.items()}
            want_cfg = (32, 1024, 64, True, True, os.devnull, SEED)
            if steps != {"dv-fast": 8, "dv-base": 16} or any(
                    c != want_cfg for c in cfgs.values()):
                raise AssertionError(f"app engine settings {steps} {cfgs}")
            gw.lanes = {k: v.replace(max_tokens=min(v.max_tokens,
                                                    APP_MAX_TOKENS))
                        for k, v in gw.lanes.items()}
            ai_calls = []
            inner = gw.call_model

            def recording(prompt, call_type="question", *,
                          return_meta=False, **kw):
                try:
                    text, meta = inner(prompt, call_type, return_meta=True,
                                       **kw)
                except Exception as e:
                    ai_calls.append({"call_type": call_type,
                                     "failure_reason": str(e)[:200]})
                    raise
                ai_calls.append({k: meta.get(k) for k in (
                    "call_type", "lane", "model", "prompt_tokens",
                    "completion_tokens", "total_ms", "finish_reason",
                    "prompt_shrunk", "failure_reason")})
                # the mark that lets the question parser's plain-text rule
                # take random text as a question
                ai_calls[-1]["question_mark"] = "?" in text or "？" in text
                return (text, meta) if return_meta else text

            gw.call_model = recording
            user, admin = app.test_client(), app.test_client()
            requests = []

            def req(client, name, method, path, want, **kw):
                before = launches()
                t = time.monotonic()
                r = client.open(path, method, **kw)
                ms = (time.monotonic() - t) * 1e3
                body = r.get_json()
                requests.append({"name": name, "status": r.status_code,
                                 "ms": ms, "launches": delta(before)})
                if r.status_code != want:
                    raise AssertionError(f"app {name}: {r.status_code} "
                                         f"{r.text[:300]}")
                return body

            def settle(name):
                before = launches()
                waited = _settle_app_threads()
                requests.append({"name": name, "status": None, "ms":
                                 waited * 1e3, "launches": delta(before)})

            for fn in counters.values():
                fn.launches = 0
            for client, phone in ((admin, "13800000001"),
                                  (user, APP_USER_PHONE)):
                req(client, "send_code", "POST", "/api/auth/sms/send-code",
                    200, json_body={"phone": phone})
                who = req(client, "login", "POST", "/api/auth/login/code",
                          200, json_body={"phone": phone, "code": "666666"})
            # the admin raises the user to standard (docx exports)
            req(admin, "set_level", "PUT",
                f"/api/admin/users/{who['user']['user_id']}/level", 200,
                json_body={"level": "standard"})
            sess = req(user, "create_session", "POST", "/api/sessions", 201,
                       json_body={"topic": "仓储管理系统选型",
                                  "scenario_id": "product-requirement",
                                  "interview_mode": "quick",
                                  "description": "覆盖三个区域仓与一个中心仓"})
            sid = sess["session_id"]
            doc = _reference_markdown().encode("utf-8")
            up = req(user, "upload_document", "POST",
                     f"/api/sessions/{sid}/documents", 200,
                     files={"file": ("背景资料.md", doc, "text/markdown")})
            n_chunks = len(state.sessions.load(sid)["reference_materials"][0]
                           .get("chunks") or [])
            if n_chunks < 2:
                raise AssertionError(f"app: the document gave {n_chunks} "
                                     f"chunks")
            req(user, "assistant_chat", "POST",
                f"/api/sessions/{sid}/interview-assistant-chat", 200,
                json_body={"message": "仓库盘点差异应该怎么描述？"})
            answers = {}
            q1 = req(user, "next_question_1", "POST",
                     f"/api/sessions/{sid}/next-question", 200, json_body={})
            answers["question_1"] = q1.get("ai_generated")
            settle("prefetch_after_question_1")
            # the second question's model work, from submit-answer (which
            # starts its prefetch) to the end of that prefetch
            cache = gw.engines["dv-fast"].scheduler.prefix_cache
            before_2, hits_0, calls_0 = launches(), cache.hits, len(ai_calls)
            req(user, "submit_answer", "POST",
                f"/api/sessions/{sid}/submit-answer", 200, json_body={
                    "question": q1["question"],
                    "answer": "我们有三套系统，因为数据分散，例如报表需要手工汇总",
                    "dimension": q1.get("dimension"),
                    "options": q1.get("options")})
            settle("prefetch_after_answer")
            q2 = req(user, "next_question_2", "POST",
                     f"/api/sessions/{sid}/next-question", 200, json_body={})
            answers["question_2"] = q2.get("ai_generated")
            settle("prefetch_after_question_2")
            second = _second_question_path(
                q2, delta(before_2)["paged_chunk"], cache.hits - hits_0,
                ai_calls[:calls_0], ai_calls[calls_0:])
            before_rep = launches()
            req(user, "generate_report", "POST",
                f"/api/sessions/{sid}/generate-report", 202,
                json_body={"force": True})
            t_rep = time.monotonic()
            polls = 0
            while True:
                polls += 1
                st = req(user, "report_status", "GET",
                         f"/api/status/report-generation/{sid}", 200)
                if st["state"] in ("completed", "failed"):
                    break
                if time.monotonic() - t_rep > 600:
                    raise AssertionError(f"app: report job at {st['state']} "
                                         f"after 600 s")
                requests.pop()        # keep the first and the last poll
                time.sleep(0.5)
            report_s, report_launches = time.monotonic() - t_rep, delta(
                before_rep)
            if st["state"] != "completed":
                raise AssertionError(f"app: report job {st}")
            answers["report"] = st.get("ai_generated")
            name = st["report_name"]
            r = user.get(f"/api/reports/{name}")
            requests.append({"name": "get_report", "status": r.status_code,
                             "ms": None, "launches": None})
            if r.status_code != 200 or not r.data:
                raise AssertionError(f"app get_report: {r.status_code}")
            req(user, "export_docx", "POST", f"/api/reports/{name}/exports",
                201, json_body={"format": "docx"})
            status = req(user, "status", "GET", "/api/status", 200)
            metrics = req(admin, "metrics", "GET", "/api/metrics", 200)
            total = launches()
            if min(total.values()) <= 0:
                raise AssertionError(f"app: a kernel was not launched by the "
                                     f"HTTP traffic {total}")
            if set(status["engine"]) != {"dv-fast", "dv-base"}:
                raise AssertionError(f"app /api/status engines "
                                     f"{set(status['engine'])}")
            out = {
                "phase": "app", "boot": boot, "lanes": lanes,
                "decode_steps_per_call": steps, "max_tokens": APP_MAX_TOKENS,
                "document": {"bytes": len(doc), "chunks": n_chunks,
                             "summarised": bool(up["document"].get(
                                 "summary"))},
                "requests": requests, "ai_calls": ai_calls,
                "ai_generated": answers, "second_question": second,
                "report": {"state": st["state"], "seconds": report_s,
                           "polls": polls, "bytes": len(r.data),
                           "launches": report_launches},
                "metrics_ai_calls": metrics.get("ai_calls"),
                "launches": total,
            }
        finally:
            _settle_app_threads()
            state.shutdown()
            # the app registers its gateway process-wide; drop it, or its
            # engines' weights and page pools stay on the card for the
            # phases after this one
            configure_gateway(ModelGateway(mode="template"))
        del app, state, gw
        gc.collect()
        torch.cuda.empty_cache()
        out["server"] = _app_server_step(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.monotonic() - t0
    emit(out)
    return out


def _ops_sessions(data_dir) -> list:
    """The ops CLIs' data dir of ``tests/test_ops_scripts.py`` with both
    sessions completed, written through the port's store (which stamps
    its own times); returns their ids."""
    from deepvision_tpu_torch.web.meta_index import MetaIndex
    from deepvision_tpu_torch.web.stores import SessionStore

    store = SessionStore(data_dir, MetaIndex(
        os.path.join(data_dir, "meta_index.sqlite3")))
    ids = []
    for i in range(2):
        ids.append(f"dv-2026010100000{i}-feed000{i}")
        store.save({
            "session_id": ids[-1], "topic": f"CLI测试主题{i}",
            "status": "completed", "instance_scope": "default",
            "owner_user_id": "u1", "interview_mode": "standard",
            "scenario_id": "product-requirement",
            "interview_log": [
                {"question": "现状如何？", "answer": "高峰期单据积压严重，"
                 "主要卡在审批环节", "dimension": "d1",
                 "quality_score": 0.8},
                {"question": "目标是什么？", "answer": "两小时内处理完",
                 "dimension": "d1", "quality_score": 0.5},
            ],
            "dimensions": {"d1": {"coverage": 1.0}},
            "reference_materials": [],
        })
    return ids


def _cli_main(main, argv):
    """A CLI's ``main(argv)`` in this process; returns its exit code and
    what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc or 0, buf.getvalue()


# reports/min line of report_generator's ``generate``
REPORTS_PER_MIN = re.compile(r"^(\d+) reports in ([0-9.]+)s \(([0-9.]+) "
                             r"reports/min, workers=(\d+), failed=(\d+)\)$")


def phase_ops() -> dict:
    """The port's engine-driven ops and eval CLIs on the card, through
    their own ``main``.

    1. ``python -m deepvision_tpu_torch.report_generator --ai-mode template
       readiness --all`` in a subprocess on a data dir of 2 completed
       sessions: both ready.
    2. ``report_generator`` ``--ai-mode engine generate --all --status
       completed --workers 2`` in process: its default engine (dv-1b at
       full width, random weights from the seed, the byte tokenizer) with
       every lane capped at ``APP_MAX_TOKENS`` new tokens (random weights
       never close their JSON; the caps are the CLI's gateway's alone).
       Exit code 0, both reports saved and bound to their sessions, and the
       reports/min line.
    3. ``eval_generation_quality`` on the trained checkpoints: dv-fast on
       the question lane, dv-base on the report lane, 8 generations each at
       220 / 512 new tokens: every lane scored, none with an error.
    4. ``eval_quant_quality`` on the trained dv-base: 2 report prompts,
       256 new tokens, bf16 against int8 weights; every output parses.

    #1, #2 and #3 must each have been launched in the phase; their
    launches, each CLI's seconds and results are reported."""
    from deepvision_tpu_torch import (
        eval_generation_quality,
        eval_quant_quality,
        report_generator,
    )
    from deepvision_tpu_torch.engine.kernels.flash_attention import (
        flash_attention,
    )
    from deepvision_tpu_torch.engine.kernels.paged_attention import (
        paged_attention_update,
    )
    from deepvision_tpu_torch.engine.kernels.paged_chunk import (
        paged_chunk_attention,
    )
    from deepvision_tpu_torch.web.meta_index import MetaIndex
    from deepvision_tpu_torch.web.stores import ReportStore, SessionStore

    counters = {"flash_fwd": flash_attention,
                "paged_decode_update": paged_attention_update,
                "paged_chunk": paged_chunk_attention}

    def launches():
        return {k: fn.launches for k, fn in counters.items()}

    for name in ("dv-fast", "dv-base"):
        path = os.path.join(ROOT, "resources", "checkpoints", f"{name}.npz")
        if not os.path.isfile(path):
            raise AssertionError(f"ops: no checkpoint at {path}")
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    steps = {}

    def step(name, fn):
        gc.collect()
        torch.cuda.empty_cache()
        before, t = launches(), time.monotonic()
        out = fn()
        now = launches()
        steps[name] = {"seconds": time.monotonic() - t,
                       "launches": {k: now[k] - before[k] for k in now},
                       **out}

    for fn in counters.values():
        fn.launches = 0
    tmp = tempfile.mkdtemp(prefix="dv-ops-")
    try:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        sids = _ops_sessions(data_dir)

        def readiness():
            proc = subprocess.run(
                [sys.executable, "-m", "deepvision_tpu_torch.report_generator",
                 "--data-dir", data_dir, "--ai-mode", "template", "readiness",
                 "--all"], cwd=ROOT, capture_output=True, text=True,
                timeout=120)
            lines = proc.stdout.splitlines()
            if proc.returncode != 0 or lines[-1:] != [f"{len(sids)}/"
                                                      f"{len(sids)} ready"]:
                raise AssertionError(f"ops readiness: {proc.returncode} "
                                     f"{lines} {proc.stderr[-2000:]}")
            return {"stdout": lines}

        def generate():
            engines = []
            real = report_generator._services

            def capped(args):
                meta, sessions, reports, gw = real(args)
                gw.lanes = {k: v.replace(max_tokens=min(v.max_tokens,
                                                        APP_MAX_TOKENS))
                            for k, v in gw.lanes.items()}
                engines.extend(gw.engines.values())
                return meta, sessions, reports, gw

            report_generator._services = capped
            try:
                rc, text = _cli_main(report_generator.main, [
                    "--data-dir", data_dir, "--ai-mode", "engine",
                    "generate", "--all", "--status", "completed",
                    "--workers", "2"])
            finally:
                report_generator._services = real
                for eng in engines:
                    eng.shutdown()
            lines = text.strip().splitlines()
            rate = REPORTS_PER_MIN.match(lines[-1]) if lines else None
            if rc != 0 or rate is None or rate.group(1) != str(len(sids)) \
                    or rate.group(5) != "0":
                raise AssertionError(f"ops generate: exit {rc}, {lines}")
            meta = MetaIndex(os.path.join(data_dir, "meta_index.sqlite3"))
            sessions, reports = (SessionStore(data_dir, meta),
                                 ReportStore(data_dir, meta))
            bound = {}
            for sid in sids:
                name = (sessions.load(sid) or {}).get("last_report_name")
                if not name or not reports.load(name):
                    raise AssertionError(f"ops generate: {sid} has no saved "
                                         f"report ({name!r})")
                bound[sid] = name
            (eng,) = engines
            c = eng.model_cfg
            if (c.name, c.d_model, c.n_layers, c.head_dim,
                    eng.cfg.checkpoint_dir) != ("dv-1b", 2048, 16, 128, None):
                raise AssertionError(f"ops generate: engine {c} "
                                     f"{eng.cfg.checkpoint_dir!r}")
            return {"model": c.name,
                    "weights": f"random (seed {eng.cfg.seed})",
                    "max_tokens": APP_MAX_TOKENS, "stdout": lines,
                    "reports": bound, "reports_per_min": float(rate.group(3))}

        def eval_quality():
            rc, text = _cli_main(eval_generation_quality.main, [
                "--models", "dv-fast:question,dv-base:report", "--n", "8",
                "--max-question-tokens", "220", "--max-report-tokens", "512"])
            results = json.loads(text[text.index("{\n"):])
            lanes = {m: results.get(m) for m in ("dv-fast", "dv-base")}
            if rc != 0 or any(not isinstance(v, dict) or "error" in v
                              or "schema_valid_pct" not in v
                              for v in lanes.values()):
                raise AssertionError(f"ops eval_generation_quality: exit "
                                     f"{rc}, {results}")
            return {"results": results}

        def eval_quant():
            rc, text = _cli_main(eval_quant_quality.main, [
                "--model", "dv-base", "--n", "2", "--max-tokens", "256"])
            line = json.loads(text.strip().splitlines()[-1])
            ok = (line["bf16_json_ok"], line["int8_json_ok"])
            if rc != 0 or ok != (2, 2):
                raise AssertionError(f"ops eval_quant_quality: exit {rc}, "
                                     f"{line}")
            return {"result": line}

        step("readiness", readiness)
        step("generate", generate)
        step("eval_generation_quality", eval_quality)
        step("eval_quant_quality", eval_quant)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = launches()
    if min(total.values()) <= 0:
        raise AssertionError(f"ops: a kernel was not launched by the CLIs "
                             f"{total}")
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "ops", "steps": steps, "launches": total,
           "seconds": time.monotonic() - t0}
    emit(out)
    return out


class LlamaConfig:
    """The attributes of a HuggingFace ``LlamaConfig`` that the importer
    reads, so that the phase runs without ``transformers`` installed."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _hf_state_dict(c, gen):
    """An HF-named Llama state dict (``[out, in]`` projections, full-scale
    RMSNorm weights, an untied ``lm_head``) of seeded random tensors."""
    D, F, V = c.hidden_size, c.intermediate_size, c.vocab_size
    HD = c.head_dim
    qd, kvd = c.num_attention_heads * HD, c.num_key_value_heads * HD

    def w(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.02).cpu()

    def norm():
        return (1.0 + 0.1 * torch.randn(D, generator=gen,
                                        device="cuda")).cpu()

    sd = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": norm(),
          "lm_head.weight": w(V, D)}
    for i in range(c.num_hidden_layers):
        p = f"model.layers.{i}"
        sd.update({
            f"{p}.input_layernorm.weight": norm(),
            f"{p}.post_attention_layernorm.weight": norm(),
            f"{p}.self_attn.q_proj.weight": w(qd, D),
            f"{p}.self_attn.k_proj.weight": w(kvd, D),
            f"{p}.self_attn.v_proj.weight": w(kvd, D),
            f"{p}.self_attn.o_proj.weight": w(D, qd),
            f"{p}.mlp.gate_proj.weight": w(F, D),
            f"{p}.mlp.up_proj.weight": w(F, D),
            f"{p}.mlp.down_proj.weight": w(D, F),
        })
    return sd


def phase_hf_import() -> dict:
    """An HF-named state dict of seeded random tensors for a 2-layer
    Llama-shaped config (d_model 1,024, 8 / 2 heads of 128, d_ff 2,816,
    vocab 32,000, untied ``lm_head``) through ``infer_config_from_hf`` ->
    ``convert_hf_state_dict`` -> ``from_numpy_params`` -> ``save_npz`` ->
    ``LLMEngine(quantize="int8")``: 16 greedy tokens, the int8 untied
    ``lm_head`` among the weights.  The kernel-path prefill logits of the
    prompt and its tokens must agree with the plain float32
    ``forward_train`` of the same (int8) params.  Then the converted params
    go through the importer CLI's ``write_checkpoint`` into an orbax
    directory (bf16), and an engine booted from it must give the 16 greedy
    tokens of one booted from a ``.npz`` of the same bf16 params."""
    import tempfile

    from deepvision_tpu_torch.engine import model as model_lib
    from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine
    from deepvision_tpu_torch.engine.hf_import import (
        convert_hf_state_dict,
        infer_config_from_hf,
    )
    from deepvision_tpu_torch.engine.kernels.flash_attention import (
        flash_attention,
    )
    from deepvision_tpu_torch.engine.kernels.paged_attention import (
        paged_attention_update,
    )
    from deepvision_tpu_torch.engine.kv_cache import CacheConfig, init_cache
    from deepvision_tpu_torch.engine.quant import is_quantized_weight
    from deepvision_tpu_torch.engine.weights import (
        from_numpy_params,
        param_bytes,
        round_to_bf16,
        save_npz,
    )
    from deepvision_tpu_torch.import_hf_checkpoint import write_checkpoint

    t0 = time.monotonic()
    hf_cfg = LlamaConfig(
        vocab_size=32000, hidden_size=1024, intermediate_size=2816,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2,
        head_dim=128, max_position_embeddings=4096, rms_norm_eps=1e-5,
        rope_theta=10000.0, tie_word_embeddings=False)
    cfg = infer_config_from_hf(hf_cfg, name="hf-llama-2l")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sd = _hf_state_dict(hf_cfg, gen)
    np_params = convert_hf_state_dict(sd, cfg)
    params = from_numpy_params(np_params, device="cuda")
    del sd

    def boot(path):
        return LLMEngine(EngineConfig(
            model=cfg.name, tokenizer="byte", checkpoint_dir=path,
            device="cuda", max_slots=2, num_pages=64, page_size=64,
            max_pages_per_seq=8, decode_steps_per_call=8, quantize="int8",
            json_dfa=False, seed=SEED), model_cfg=cfg)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hf-llama-2l.npz")
        save_npz(path, params)
        del params
        eng = boot(path)
    try:
        qp = eng.runner.params
        if not is_quantized_weight(qp["lm_head"]):
            raise AssertionError("hf_import: the untied lm_head is not int8")
        prompt = eng.tokenizer.encode(_question_prompts()[0])[:200]
        flash_attention.launches = 0
        paged_attention_update.launches = 0
        res = eng.submit_tokens(prompt, max_tokens=16, temperature=0.0,
                                stop_token_ids=[]).wait(300)
        if res is None or not res.ok or len(res.token_ids) != 16:
            raise AssertionError(f"hf_import: generation failed: {res}")
        launches = {"flash_fwd": flash_attention.launches,
                    "paged_decode_update": paged_attention_update.launches}
        if min(launches.values()) <= 0:
            raise AssertionError(f"hf_import: a kernel was not launched "
                                 f"{launches}")
        seq = prompt + res.token_ids[:-1]
        n = len(seq)
        bucket = 256
        cache = init_cache(cfg, CacheConfig(num_pages=bucket // 64 + 1,
                                            page_size=64,
                                            max_pages_per_seq=bucket // 64),
                           device="cuda")
        toks = torch.zeros(1, bucket, dtype=torch.int32, device="cuda")
        toks[0, :n] = torch.tensor(seq, dtype=torch.int32)
        pages = torch.arange(1, bucket // 64 + 1, dtype=torch.int32,
                             device="cuda")[None]
        got = model_lib.forward_prefill(
            qp, cache, toks, torch.tensor([n], dtype=torch.int32,
                                          device="cuda"), pages, cfg=cfg)[0]
        with torch.no_grad():
            plain = model_lib.forward_train(qp, toks[:, :n], cfg=cfg,
                                            act_dtype=torch.float32)[0]
        want = plain[-1]
        err = (got - want).abs().max().item()
        # bf16 activations through 2 layers against float32 ones, the same
        # int8 weights: 5 % of the logit range, as phase engine allows
        tol = 0.05 * want.abs().max().item() + 0.05
        if not err <= tol:
            raise AssertionError(f"hf_import: prefill logits vs float32 "
                                 f"forward_train: {err} > {tol}")
        plain_next = plain[len(prompt) - 1:].argmax(-1).tolist()
        agree = float(np.mean([a == b for a, b in
                               zip(plain_next, res.token_ids)]))
        out = {
            "phase": "hf_import", "config": cfg.__dict__,
            "param_bytes": param_bytes(qp), "tokens": res.token_ids,
            "launches": launches, "logit_err": err, "logit_tol": tol,
            "greedy_agreement_with_float32": agree,
        }
    finally:
        eng.shutdown()
    # the importer CLI's write function: its orbax directory (bf16, the
    # CLI's default) boots an engine with the greedy tokens of one booted
    # from a .npz of the same bf16 params
    with tempfile.TemporaryDirectory() as tmp:
        orbax_dir = os.path.join(tmp, "hf-llama-2l")
        t = time.monotonic()
        write_checkpoint(cfg, np_params, orbax_dir)
        out["orbax_write_s"] = time.monotonic() - t
        bf16_npz = os.path.join(tmp, "hf-llama-2l-bf16.npz")
        save_npz(bf16_npz, {
            k: ({n: round_to_bf16(v) for n, v in leaf.items()}
                if isinstance(leaf, dict) else round_to_bf16(leaf))
            for k, leaf in from_numpy_params(np_params,
                                             device="cpu").items()})
        runs = {}
        for name, ckpt in (("orbax", orbax_dir), ("npz_bf16", bf16_npz)):
            e = boot(ckpt)
            try:
                res = e.submit_tokens(prompt, max_tokens=16, temperature=0.0,
                                      stop_token_ids=[]).wait(300)
            finally:
                e.shutdown()
            if res is None or not res.ok or len(res.token_ids) != 16:
                raise AssertionError(f"hf_import: {name} boot failed: {res}")
            runs[name] = res.token_ids
    if runs["orbax"] != runs["npz_bf16"]:
        raise AssertionError(f"hf_import: the CLI's orbax directory gives "
                             f"other tokens than the .npz: {runs}")
    out["orbax_tokens"] = runs["orbax"]
    out["seconds"] = time.monotonic() - t0
    emit(out)
    return out


def _orbax_fixture_frames(path: str) -> list:
    """Every zstd frame of the committed JAX-written checkpoint: the OCDBT
    manifest and node bodies of the root store and of ``ocdbt.process_0``
    (recorded as the plain decoder is handed them) and each zarr chunk."""
    from deepvision_tpu_torch.engine import zstd as plain_zstd
    from deepvision_tpu_torch.engine.ocdbt import OcdbtStore

    bodies = []

    def record(data, size=None):
        bodies.append(bytes(data))
        return plain_zstd.decompress(data, size)

    chunks = []
    for root in (path, os.path.join(path, "ocdbt.process_0")):
        store = OcdbtStore(root, record)
        chunks += [store.read(k) for k in store.keys()
                   if not k.endswith(".zarray")]
    return bodies + chunks


def _decode_rate(decode, frames, sizes, repeats: int) -> float:
    """MB/s (decoded bytes) of ``decode(frame, size)`` over ``frames``,
    host clock, ``repeats`` passes."""
    t0 = time.monotonic()
    for _ in range(repeats):
        for f, n in zip(frames, sizes):
            decode(f, n)
    return repeats * sum(sizes) / (time.monotonic() - t0) / 1e6


def _greedy_report_tokens(checkpoint_dir, prompts, profile_it=False):
    """Boot ``LLMEngine`` on dv-base from ``checkpoint_dir`` and decode 64
    greedy json_mode tokens for each prompt, one at a time.  Returns the
    token ids, the boot seconds, the wrappers' launches of #1 and #2 and,
    with ``profile_it``, the profiler's count of their CUDA kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine
    from deepvision_tpu_torch.engine.kernels.flash_attention import (
        flash_attention,
    )
    from deepvision_tpu_torch.engine.kernels.paged_attention import (
        paged_attention_update,
    )

    tok_path = os.path.join(ROOT, "resources", "tokenizer", "dv_bpe_16k.json")
    t0 = time.monotonic()
    eng = LLMEngine(EngineConfig(
        model="dv-base", tokenizer=tok_path, checkpoint_dir=checkpoint_dir,
        device="cuda", max_slots=2, num_pages=64, page_size=64,
        max_pages_per_seq=16, decode_steps_per_call=16,
        chunked_prefill=False, json_dfa=True, warmup=False, seed=SEED))
    boot_s = time.monotonic() - t0
    try:
        flash_attention.launches = 0
        paged_attention_update.launches = 0
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if profile_it else contextlib.nullcontext())
        tokens = []
        with ctx as prof:
            for p in prompts:
                res = eng.submit_tokens(eng.tokenizer.encode(p),
                                        max_tokens=64, temperature=0.0,
                                        json_mode=True).wait(600)
                if res is None or not res.ok:
                    raise AssertionError(f"orbax: generation failed: {res}")
                tokens.append(res.token_ids)
            torch.cuda.synchronize()
        launches = {"flash_fwd": flash_attention.launches,
                    "paged_decode_update": paged_attention_update.launches}
        profiled = None
        if profile_it:
            profiled = {"flash_fwd": 0, "paged_decode_update": 0}
            for e in prof.key_averages():
                if e.device_type != DeviceType.CUDA:
                    continue
                if "flash_fwd_tc_kernel" in e.key:
                    profiled["flash_fwd"] += e.count
                elif "paged_decode_kernel" in e.key:
                    profiled["paged_decode_update"] += e.count
    finally:
        eng.shutdown()
    return tokens, boot_s, launches, profiled


def phase_orbax() -> dict:
    """Orbax checkpoints on the card: (a) the compiled zstd decoder
    (``csrc/zstd_decode.cu``, host code) byte-equal to the plain one on
    every frame of the committed JAX-written checkpoint and on the
    committed ``zstandard`` frames, with both decoders' MB/s; (b) that
    checkpoint read through the CUDA path, bit-equal to its ``.npz`` twin;
    (c) the trained dv-base written with the port's ``save_checkpoint``
    and read back onto the card, bit for bit, with seconds and MB/s of
    both; (d) ``LLMEngine`` booted from that directory gives the greedy
    tokens of the engine booted from the ``.npz`` (2 report prompts,
    json_mode, 64 tokens) and launches #1 and #2."""
    import hashlib
    import tempfile

    from deepvision_tpu_torch.engine import zstd as plain_zstd
    from deepvision_tpu_torch.engine.kernels import zstd as compiled_zstd
    from deepvision_tpu_torch.engine.tokenizer import get_tokenizer
    from deepvision_tpu_torch.engine.weights import (
        init_params,
        load_checkpoint,
        load_npz,
        param_bytes,
        save_checkpoint,
    )
    from deepvision_tpu_torch.engine.config import get_model_config

    t0 = time.monotonic()
    fixtures = os.path.join(ROOT, "tests", "fixtures", "torch_orbax")
    # (a) the decoders, frame by frame
    with open(os.path.join(fixtures, "frames.json")) as fh:
        index = json.load(fh)["frames"]
    with open(os.path.join(fixtures, "frames.zst"), "rb") as fh:
        blob = fh.read()
    committed = [blob[f["offset"]:f["offset"] + f["length"]] for f in index]
    sizes = [f["size"] for f in index]
    for f, frame in zip(index, committed):
        got = compiled_zstd.decompress(frame, f["size"])
        if hashlib.sha256(got).hexdigest() != f["sha256"]:
            raise AssertionError(f"orbax: compiled decoder on frame "
                                 f"{f['name']}: wrong bytes")
        if bytes(got) != bytes(plain_zstd.decompress(frame)):
            raise AssertionError(f"orbax: decoders differ on {f['name']}")
    ckpt = os.path.join(fixtures, "tiny_ckpt")
    fixture = _orbax_fixture_frames(ckpt)
    fixture_sizes = []
    for frame in fixture:
        want = plain_zstd.decompress(frame)
        if bytes(compiled_zstd.decompress(frame)) != bytes(want):
            raise AssertionError("orbax: decoders differ on a frame of the "
                                 "committed checkpoint")
        fixture_sizes.append(len(want))
    frames, all_sizes = committed + fixture, sizes + fixture_sizes
    # all 40 frames, and the checkpoint's alone (bf16 chunks and nodes)
    rates = {"compiled_mb_s": _decode_rate(compiled_zstd.decompress, frames,
                                           all_sizes, 20),
             "plain_mb_s": _decode_rate(plain_zstd.decompress, frames,
                                        all_sizes, 1),
             "checkpoint_compiled_mb_s": _decode_rate(
                 compiled_zstd.decompress, fixture, fixture_sizes, 20),
             "checkpoint_plain_mb_s": _decode_rate(
                 plain_zstd.decompress, fixture, fixture_sizes, 1)}
    # (b) the fixture through the CUDA path against its twin
    got = load_checkpoint(ckpt, device="cuda")
    with np.load(os.path.join(fixtures, "tiny_ckpt.npz")) as twin:
        for name in twin.files:
            keys = name[:-len("@bf16")].split("/")
            leaf = got
            for k in keys:
                leaf = leaf[k]
            if leaf.device.type != "cuda" or not np.array_equal(
                    leaf.view(torch.int16).cpu().numpy().view(np.uint16),
                    twin[name]):
                raise AssertionError(f"orbax: fixture leaf {name} differs "
                                     f"from its twin")
    # (c) dv-base through the port's writer and reader
    cfg = get_model_config("dv-base")
    npz = os.path.join(ROOT, "resources", "checkpoints", "dv-base.npz")
    params = load_npz(npz, device="cuda")
    nbytes = param_bytes(params)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dv-base")
        t = time.monotonic()
        save_checkpoint(path, params)
        write_s = time.monotonic() - t
        t = time.monotonic()
        back = load_checkpoint(path, init_params(cfg, device="meta"),
                               device="cuda")
        torch.cuda.synchronize()
        read_s = time.monotonic() - t
        want, have = dict(_flat(params)), dict(_flat(back))
        if set(want) != set(have) or any(
                have[k].device.type != "cuda" or have[k].dtype != v.dtype
                or not torch.equal(have[k].view(torch.int16),
                                   v.view(torch.int16))
                for k, v in want.items()):
            raise AssertionError("orbax: dv-base read back differs")
        del params, back, want, have
        torch.cuda.empty_cache()
        # (d) the engine from the directory against the .npz boot
        tokenizer = get_tokenizer(os.path.join(
            ROOT, "resources", "tokenizer", "dv_bpe_16k.json"))
        prompts = _report_prompts(tokenizer, [400, 700])
        ref, npz_boot_s, _, _ = _greedy_report_tokens(npz, prompts)
        tokens, orbax_boot_s, launches, profiled = _greedy_report_tokens(
            path, prompts, profile_it=True)
    if tokens != ref:
        first = [_first_diff(a, b) for a, b in zip(tokens, ref)]
        raise AssertionError(f"orbax: the orbax boot's greedy tokens "
                             f"differ from the .npz boot's at {first}")
    if min(launches.values()) <= 0 or min(profiled.values()) <= 0:
        raise AssertionError(f"orbax: a kernel was not launched: {launches} "
                             f"{profiled}")
    out = {
        "phase": "orbax",
        "committed_frames": len(committed),
        "fixture_frames": len(fixture),
        "decoded_bytes": sum(all_sizes), **rates,
        "fixture_leaves_bit_equal": True,
        "dv_base_bytes": nbytes, "write_s": write_s,
        "write_mb_s": nbytes / write_s / 1e6, "read_s": read_s,
        "read_mb_s": nbytes / read_s / 1e6,
        "npz_boot_s": npz_boot_s, "orbax_boot_s": orbax_boot_s,
        "tokens": [len(t) for t in tokens], "tokens_equal": True,
        "launches": launches, "profiler_launches": profiled,
    }
    out["seconds"] = time.monotonic() - t0
    emit(out)
    return out


# phase engine_tp: the report lane's serving settings (chunked prefill, so
# the prefix cache resumes through #3), at tp=1 and tp=2
TP_ENGINE = dict(device="cuda", max_slots=8, num_pages=1024, page_size=64,
                 max_pages_per_seq=32, decode_steps_per_call=16,
                 chunked_prefill=True, json_dfa=True, warmup=False, seed=SEED)
# dv-gemma-2b at full width, its depth cut from 18 to 2 layers: every rank
# draws the whole model's random weights on the host before cutting its
# shard, and the 256k x 2,048 embedding alone is 0.5 G draws
TP_GEMMA = dict(model="dv-gemma-2b", tokenizer="byte", checkpoint_dir=None,
                device="cuda", max_slots=4, num_pages=256, page_size=64,
                max_pages_per_seq=16, decode_steps_per_call=8,
                chunked_prefill=True, json_dfa=False, warmup=False, seed=SEED)
TP_GEMMA_LAYERS = 2
TP_BASE_TOKENS = 64
TP_NAMES = {"flash_fwd": "flash_attention",
            "paged_decode_update": "paged_attention_update",
            "paged_chunk": "paged_chunk_attention"}


def _serving_counters() -> dict:
    from deepvision_tpu_torch.engine.kernels.flash_attention import (
        flash_attention,
    )
    from deepvision_tpu_torch.engine.kernels.paged_attention import (
        paged_attention_update,
    )
    from deepvision_tpu_torch.engine.kernels.paged_chunk import (
        paged_chunk_attention,
    )

    return {"flash_fwd": flash_attention,
            "paged_decode_update": paged_attention_update,
            "paged_chunk": paged_chunk_attention}


def _tp_zero(engines) -> list:
    """Fold every TP engine's worker launches so far into this process's
    counters (``LLMEngine.stats``), then zero #1-#3's counters; returns
    each engine's worker counts at that point."""
    before = [e.stats()["tp"]["worker_launches"] for e in engines]
    for fn in _serving_counters().values():
        fn.launches = 0
    return before


def _tp_read(engines, before) -> dict:
    """#1-#3's launches since :func:`_tp_zero`: summed over every rank
    (this process's counters, the workers' folded in), and by rank."""
    after = [e.stats()["tp"]["worker_launches"] for e in engines]
    total = {k: fn.launches for k, fn in _serving_counters().items()}
    workers = [{k: a[n] - b[n] for k, n in TP_NAMES.items()}
               for a_e, b_e in zip(after, before)
               for a, b in zip(a_e, b_e)]
    rank0 = {k: total[k] - sum(w[k] for w in workers) for k in total}
    return {"all_ranks": total, "rank0": rank0, "workers": workers}


def _decode_step_reading(eng, n_steps: int = 16) -> dict:
    """One ``runner.decode`` call of ``n_steps`` steps with every slot at
    length 600 (writes into the trash page), after one unmeasured call:
    host ms a step, and the collectives and host ms in them a step on
    rank 0."""
    runner = eng.runner
    B, MP = eng.cfg.max_slots, eng.cache_cfg.max_pages_per_seq
    args = (np.ones(B, np.int32), np.full(B, 600, np.int32),
            np.zeros((B, MP), np.int32), np.zeros(B, np.float32),
            np.zeros(B, np.int32), np.ones(B, np.float32))
    runner.decode(*args, n_steps=n_steps)
    group = runner.group
    calls, wait = (group.calls, group.wait_s) if group else (0, 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.decode(*args, n_steps=n_steps)
    torch.cuda.synchronize()
    out = {"B": B, "n_steps": n_steps,
           "ms_per_step": (time.perf_counter() - t0) * 1e3 / n_steps,
           "collectives_per_step": 0, "gloo_ms_per_step": 0.0}
    if group:
        out["collectives_per_step"] = (group.calls - calls) / n_steps
        out["gloo_ms_per_step"] = (group.wait_s - wait) * 1e3 / n_steps
    return out


def _tp_ranks(eng) -> dict:
    st = eng.stats()["tp"]
    return {k: st[k] for k in ("ranks", "backend", "devices",
                               "vocab_sharded", "kv_sharded",
                               "worker_boot_s")}


def _tf_error(got, want) -> dict:
    """Teacher-forced logits of a TP engine against tp=1 on the same
    weights: two bf16 paths whose all_reduce sums the partial products in
    another order, through every layer; the tolerance is phase engine's,
    5 % of the logit range."""
    err = (got - want).abs().max().item()
    tol = 0.05 * want.abs().max().item() + 0.05
    return {"logit_err": err, "logit_tol": tol, "rows": got.shape[0],
            "vocab": got.shape[1]}


def _dv_base_tp_run(tp, prompts, session, tf_ids=None, keep=False):
    """Trained dv-base through ``LLMEngine`` at ``tp``: 4 concurrent
    json_mode report drafts (64 tokens, greedy), then a session's two
    turns with a prefix key (the second resumes through #3), a decode-step
    reading and teacher-forced logits over ``tf_ids`` (default: prompt 0
    and its tokens).  Returns ``(engine or None, readings)``: ``keep``
    leaves the engine running for the caller to shut down."""
    from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

    t0 = time.monotonic()
    eng = LLMEngine(EngineConfig(
        model="dv-base", tokenizer=os.path.join(
            ROOT, "resources", "tokenizer", "dv_bpe_16k.json"),
        checkpoint_dir=TRAINED_BASE, tp=tp,
        vocab_sharded=True if tp > 1 else None, **TP_ENGINE))
    try:
        eng.start()
        boot_s = time.monotonic() - t0
        before = _tp_zero([eng]) if tp > 1 else None
        for fn in _serving_counters().values():
            fn.launches = 0
        t_serve = time.monotonic()
        reqs = [eng.submit_tokens(ids, max_tokens=TP_BASE_TOKENS,
                                  temperature=0.0, json_mode=True)
                for ids in prompts]
        tokens = []
        for r in reqs:
            res = r.wait(600)
            if res is None or not res.ok:
                raise AssertionError(f"engine_tp tp={tp}: {res}")
            tokens.append(res.token_ids)
        turns = []
        for ids in session:
            res = eng.submit_tokens(ids, max_tokens=32, temperature=0.0,
                                    json_mode=True,
                                    prefix_key="tp-session-0").wait(600)
            if res is None or not res.ok:
                raise AssertionError(f"engine_tp tp={tp} session: {res}")
            turns.append(res.token_ids)
        serve_s = time.monotonic() - t_serve
        texts = [eng.tokenizer.decode(t) for t in tokens + turns]
        for text in texts:
            json.loads(text)  # raises on unparseable output
        if tp > 1:
            launches = _tp_read([eng], before)
        else:
            launches = {"all_ranks": {k: fn.launches for k, fn in
                                      _serving_counters().items()}}
        stats = eng.stats()
        out = {"tp": tp, "boot_s": boot_s, "serve_s": serve_s,
               "launches": launches, "json_parsed": len(texts),
               "prefix_cache": stats["prefix_cache"],
               "decode_ms_per_step_served": stats["decode_time_s"] * 1e3
               / max(1, stats["decode_steps"]),
               "decode_step": _decode_step_reading(eng),
               "tokens": tokens, "turns": turns}
        if tp > 1:
            out["ranks"] = _tp_ranks(eng)
        out["tf_logits"] = eng.teacher_forced_logits(
            tf_ids or prompts[0] + tokens[0], len(prompts[0]))
    except BaseException:
        eng.shutdown()
        raise
    if keep:
        return eng, out
    eng.shutdown()
    return None, out


def _gemma_tp_run(tp, ids, follow, tf_ids=None):
    """dv-gemma-2b at full width, 2 layers, on random weights from the seed:
    a greedy run of 32 tokens, a follow-up turn through the prefix cache
    (#3 at the shard shape), a decode-step reading and teacher-forced
    logits over ``tf_ids``."""
    from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

    from deepvision_tpu_torch.engine.config import get_model_config

    t0 = time.monotonic()
    eng = LLMEngine(EngineConfig(**TP_GEMMA, tp=tp),
                    model_cfg=dataclasses.replace(
                        get_model_config("dv-gemma-2b"),
                        n_layers=TP_GEMMA_LAYERS))
    try:
        eng.start()
        boot_s = time.monotonic() - t0
        before = _tp_zero([eng]) if tp > 1 else None
        res = eng.submit_tokens(ids, max_tokens=32, temperature=0.0,
                                prefix_key="tp-gemma").wait(600)
        if res is None or not res.ok:
            raise AssertionError(f"engine_tp gemma tp={tp}: {res}")
        tokens = res.token_ids
        res = eng.submit_tokens(ids + tokens + follow, max_tokens=8,
                                temperature=0.0,
                                prefix_key="tp-gemma").wait(600)
        if res is None or not res.ok:
            raise AssertionError(f"engine_tp gemma tp={tp} follow-up: {res}")
        out = {"tp": tp, "boot_s": boot_s, "tokens": tokens,
               "prefix_cache": eng.stats()["prefix_cache"],
               "decode_step": _decode_step_reading(eng)}
        if tp > 1:
            out["launches"] = _tp_read([eng], before)
            out["ranks"] = _tp_ranks(eng)
            out["plan"] = {"vocab_sharded": eng.plan.vocab_sharded,
                           "kv_sharded": eng.plan.kv_sharded}
        out["tf_logits"] = eng.teacher_forced_logits(tf_ids or ids + tokens,
                                                     len(ids))
    finally:
        eng.shutdown()
    return out


def _divergence(tp_tokens, ref_tokens, gap_fn) -> dict:
    """The first token where a TP run and the tp=1 run differ, with the
    tp=1 context's top-2 logit gap there (ROADMAP §3 D: summation order
    flips near-tied logits)."""
    d = _first_diff(tp_tokens, ref_tokens)
    return {"first_diff": d, "top2_gap": None if d is None else gap_fn(d)}


def phase_engine_tp() -> dict:
    """Tensor-parallel serving on the card (two ranks on ``cuda:0`` over
    gloo): trained dv-base at tp=2 with vocab sharding through
    ``LLMEngine``, against tp=1 on the same weights; then ``build_gateway``
    with ``ENGINE_TP=2`` (the app's way: a JSON-mode question and a report
    draft); then dv-gemma-2b (full width, 2 layers) at tp=2 on random
    weights (auto vocab sharding, its one kv head replicated, head dim 256)
    against tp=1.  #1,
    #2 and #3 must launch on every rank, every JSON output must parse, the
    teacher-forced logits must agree with tp=1 within 5 % of their range,
    and no worker may outlive its engine."""
    import multiprocessing

    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    from deepvision_tpu_torch.engine.tokenizer import get_tokenizer

    tok = get_tokenizer(os.path.join(ROOT, "resources", "tokenizer",
                                     "dv_bpe_16k.json"))
    prompts = [tok.encode(p) for p in
               _report_prompts(tok, [300, 500, 700, 900])]
    session = _interview_sessions(tok, n_turns=2)[0]
    _, tp2 = _dv_base_tp_run(2, prompts, session)
    eng1, tp1 = _dv_base_tp_run(1, prompts, session,
                                tf_ids=prompts[0] + tp2["tokens"][0],
                                keep=True)
    try:
        divergence = [
            _divergence(a, b, lambda d, i=i, b=b: _top2_gap(
                eng1, prompts[i], b, d, TP_BASE_TOKENS))
            for i, (a, b) in enumerate(zip(tp2["tokens"], tp1["tokens"]))]
    finally:
        eng1.shutdown()
    base_tf = _tf_error(tp2["tf_logits"], tp1["tf_logits"])
    for name, n in tp2["launches"]["all_ranks"].items():
        if n <= 0 or any(r[name] <= 0 for r in
                         [tp2["launches"]["rank0"]]
                         + tp2["launches"]["workers"]):
            raise AssertionError(f"engine_tp dv-base: {name} not launched "
                                 f"on every rank {tp2['launches']}")
    if not (tp2["ranks"]["vocab_sharded"] and tp2["ranks"]["kv_sharded"]):
        raise AssertionError(f"engine_tp dv-base plan {tp2['ranks']}")
    if not base_tf["logit_err"] <= base_tf["logit_tol"]:
        raise AssertionError(f"engine_tp dv-base teacher-forced logits "
                             f"{base_tf}")
    base = {"phase": "engine_tp", "part": "dv-base", "weights": TRAINED_BASE,
            "ranks": tp2["ranks"], "launches": tp2["launches"],
            "json_parsed": tp2["json_parsed"] + tp1["json_parsed"],
            "json_total": tp2["json_parsed"] + tp1["json_parsed"],
            "teacher_forced": base_tf, "divergence_from_tp1": divergence,
            "session_turns_equal": tp2["turns"] == tp1["turns"],
            "prefix_cache_tp2": tp2["prefix_cache"],
            "decode_step_tp2": tp2["decode_step"],
            "decode_step_tp1": tp1["decode_step"],
            "decode_ms_per_step_served": {
                "tp2": tp2["decode_ms_per_step_served"],
                "tp1": tp1["decode_ms_per_step_served"]},
            "serve_s": {"tp2": tp2["serve_s"], "tp1": tp1["serve_s"]},
            "boot_s": {"tp2": tp2["boot_s"], "tp1": tp1["boot_s"]},
            "seconds": time.monotonic() - t0}
    emit(base)
    if multiprocessing.active_children():
        raise AssertionError(f"engine_tp: workers outlived their engine "
                             f"{multiprocessing.active_children()}")

    # the app's way: build_gateway with ENGINE_TP=2
    t_gw = time.monotonic()
    gw, boot, lanes, steps = _gateway_boot({"ENGINE_TP": "2"})
    try:
        engines = list(gw.engines.values())
        if any(e.plan is None or e.plan.n_model != 2 for e in engines):
            raise AssertionError("gateway: an engine is not tp=2")
        before = _tp_zero(engines)
        q_prompt, _ = _question_prompts()
        r_prompt = _report_prompts(gw.engines["dv-base"].tokenizer, [800])[0]
        ctx = {"session_id": "dv-smoke-tp-session"}
        _, meta_q = _call(gw, q_prompt, "question", "question", "dv-fast",
                          max_tokens=TP_BASE_TOKENS, context=ctx)
        _, meta_r = _call(gw, r_prompt, "report_draft", "report_draft",
                          "dv-base", max_tokens=TP_BASE_TOKENS,
                          temperature=0.0, context=ctx)
        gw_launches = _tp_read(engines, before)
        gw_ranks = {m: _tp_ranks(e) for m, e in gw.engines.items()}
    finally:
        _shutdown(gw)
    for name in ("flash_fwd", "paged_decode_update"):
        if gw_launches["all_ranks"][name] <= 0 or any(
                w[name] <= 0 for w in gw_launches["workers"]):
            raise AssertionError(f"gateway tp=2: {name} not launched on "
                                 f"every rank {gw_launches}")
    emit({"phase": "engine_tp", "part": "gateway", "boot": boot,
          "lanes": lanes, "decode_steps_per_call": steps, "ranks": gw_ranks,
          "launches": gw_launches, "json_parsed": 2, "json_total": 2,
          "meta": {"question": meta_q, "report_draft": meta_r},
          "seconds": time.monotonic() - t_gw})
    if multiprocessing.active_children():
        raise AssertionError("engine_tp gateway: workers outlived their "
                             "engines")

    # dv-gemma-2b: MQA (K/V replicated), head dim 256, 256k vocab sharded
    t_g = time.monotonic()
    btok = get_tokenizer("byte")
    q_prompt, follow_prompt = _question_prompts()
    ids = btok.encode(q_prompt)[:300]
    follow = btok.encode(follow_prompt)[-80:]
    g2 = _gemma_tp_run(2, ids, follow)
    g1 = _gemma_tp_run(1, ids, follow, tf_ids=ids + g2["tokens"])
    g_tf = _tf_error(g2["tf_logits"], g1["tf_logits"])
    d = _first_diff(g2["tokens"], g1["tokens"])
    gap = None
    if d is not None:
        top = g1["tf_logits"][d].topk(2)
        gap = {"gap": (top.values[0] - top.values[1]).item(),
               "top2_tokens": top.indices.tolist()}
    for name, n in g2["launches"]["all_ranks"].items():
        if n <= 0 or any(w[name] <= 0 for w in g2["launches"]["workers"]):
            raise AssertionError(f"engine_tp gemma: {name} not launched on "
                                 f"every rank {g2['launches']}")
    if g2["plan"] != {"vocab_sharded": True, "kv_sharded": False}:
        raise AssertionError(f"engine_tp gemma plan {g2['plan']}")
    if not g_tf["logit_err"] <= g_tf["logit_tol"]:
        raise AssertionError(f"engine_tp gemma teacher-forced logits {g_tf}")
    if multiprocessing.active_children():
        raise AssertionError("engine_tp gemma: workers outlived their "
                             "engine")
    gemma = {"phase": "engine_tp", "part": "dv-gemma-2b",
             "weights": f"random (seed {SEED})", "ranks": g2["ranks"],
             "plan": g2["plan"], "launches": g2["launches"],
             "teacher_forced": g_tf,
             "divergence_from_tp1": {"first_diff": d, "top2_gap": gap},
             "tokens_tp2": g2["tokens"][:8],
             "prefix_cache_tp2": g2["prefix_cache"],
             "decode_step_tp2": g2["decode_step"],
             "decode_step_tp1": g1["decode_step"],
             "boot_s": {"tp2": g2["boot_s"], "tp1": g1["boot_s"]},
             "seconds": time.monotonic() - t_g}
    emit(gemma)
    launches = {k: base["launches"]["all_ranks"][k]
                + gw_launches["all_ranks"][k]
                + g2["launches"]["all_ranks"][k] for k in TP_NAMES}
    out = {"phase": "engine_tp", "part": "summary",
           "launches_all_ranks": launches,
           "json_parse_rate": 1.0, "json_outputs": base["json_total"] + 2,
           "logit_err": {"dv-base": base_tf, "dv-gemma-2b": g_tf},
           "seconds": time.monotonic() - t0}
    emit(out)
    return out


def _train_batch(tokenizer, rows: int, row_len: int, seed: int):
    """``[rows, row_len]`` token ids of seeded interview transcripts built
    from the in-repo scenarios (question and answer per dimension),
    tokenized with the BPE and joined by the end-of-turn id, as
    ``train_model.py``'s ``load_tokens`` joins corpus documents."""
    import random

    rng = random.Random(seed)
    files = sorted(glob.glob(os.path.join(ROOT, "resources", "scenarios",
                                          "builtin", "*.json")))
    if not files:
        raise FileNotFoundError("resources/scenarios/builtin/*.json")
    scenarios = []
    for path in files:
        with open(path, encoding="utf-8") as fh:
            scenarios.append(json.load(fh))
    ids = []
    while len(ids) < rows * row_len:
        sc = rng.choice(scenarios)
        parts = [f"访谈主题：{sc['name']}\n{sc['description']}\n\n"]
        for turn in range(rng.randint(4, 10)):
            d = rng.choice(sc["dimensions"])
            aspects = rng.sample(d["key_aspects"],
                                 rng.randint(1, len(d["key_aspects"])))
            parts.append(
                f"问题{turn + 1}（{d['name']}）：请具体说明{d['description']}。"
                f"\n回答：关于{'、'.join(aspects)}，目前第{rng.randint(1, 30)}"
                f"轮访谈确认了现状与期望。\n")
        ids.extend(tokenizer.encode("".join(parts)))
        ids.append(tokenizer.eos_id)
    return torch.tensor(ids[: rows * row_len],
                        dtype=torch.int32).reshape(rows, row_len)


def _flat(tree, prefix=""):
    for name in sorted(tree):
        leaf = tree[name]
        if isinstance(leaf, dict):
            yield from _flat(leaf, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", leaf


@contextlib.contextmanager
def _plain_float32_products():
    """``model.py``'s float32 products as cuBLAS float32 matmuls of float
    copies, the way they ran before the tensor-core split: a check's plain
    side then shares no code with ``f32_matmul``'s split route."""
    from deepvision_tpu_torch.engine import model as model_lib

    def one(x, w, out_dtype=torch.float32):
        return torch.matmul(x.float(), w.float()).to(out_dtype)

    def many(x, ws, out_dtype=torch.float32):
        return tuple(one(x, w, out_dtype) for w in ws)

    saved = model_lib.f32_matmul, model_lib.f32_matmuls
    model_lib.f32_matmul, model_lib.f32_matmuls = one, many
    try:
        yield
    finally:
        model_lib.f32_matmul, model_lib.f32_matmuls = saved


def _profile_step(fn, wall_ms: float) -> dict:
    """Device time by kernel of one call of ``fn`` (torch.profiler), grouped
    by what the kernels do, and the device's busy share of ``wall_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        # the port's spans (engine/spans.py) appear on the device's
        # timeline as ranges over their kernels
        if (e.device_type != DeviceType.CUDA
                or e.key.startswith(("train.", "sched."))):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    groups = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
              "matmul": 0.0, "bf16_split": 0.0, "optimizer": 0.0,
              "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        if "bf16_split" in low:
            groups["bf16_split"] += ms
        elif "flash_fwd" in low:
            groups["flash_fwd"] += ms
        elif "flash_bwd_dq" in low:
            groups["flash_bwd_dq"] += ms
        elif "flash_bwd_dkv" in low:
            groups["flash_bwd_dkv"] += ms
        elif any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet")):
            groups["matmul"] += ms
        elif "multi_tensor" in low or "adam" in low:
            groups["optimizer"] += ms
        else:
            groups["other"] += ms
    total = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"device_ms": total, "wall_ms": wall_ms,
            "busy_share": total / wall_ms if wall_ms else None,
            "groups_ms": groups,
            "top_kernels_ms": [[name[:90], ms] for name, ms in top],
            # float32 GEMMs on the CUDA cores (cuBLAS sgemm, xmma f32f32)
            "f32_gemm_kernels": sorted(n[:90] for n in kernels
                                       if re.search(r"sgemm|f32f32", n))}


def phase_train() -> dict:
    """dv-base fine-tuning steps through the port's Trainer (float32
    params, bf16 activations, flash forward and backward kernels,
    train_model.py's optimizer chain), random init from the seed."""
    import tempfile

    from deepvision_tpu_torch.engine import model as model_lib
    from deepvision_tpu_torch.engine.config import get_model_config
    from deepvision_tpu_torch.engine.f32_matmul import f32_matmul
    from deepvision_tpu_torch.engine.kernels import flash_attention as fa
    from deepvision_tpu_torch.engine.kernels.bf16_split import split_bf16
    from deepvision_tpu_torch.engine.tokenizer import get_tokenizer
    from deepvision_tpu_torch.engine.training import (
        Trainer,
        as_trainable,
        cross_entropy_loss,
        train_model_chain,
    )
    from deepvision_tpu_torch.engine.weights import (
        astype,
        count_params,
        init_params,
        load_or_init,
        save_npz,
    )

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    cfg = get_model_config("dv-base")
    tok = get_tokenizer(os.path.join(ROOT, "resources", "tokenizer",
                                     "dv_bpe_16k.json"))
    B, S, steps, lr = 8, 2048, 8, 3e-4
    batch = _train_batch(tok, B, S + 1, SEED).to("cuda")
    t_data = time.monotonic() - t0
    # train_model.py's chain as `--steps 8 --lr 3e-4` sets it up
    warmup = min(200, max(1, steps // 10))
    trainer = Trainer(cfg, tx=train_model_chain(lr, warmup,
                                                max(steps, warmup + 1)),
                      seed=SEED, param_dtype=torch.float32, use_kernel=True,
                      device="cuda")
    n_params = count_params(trainer.params)
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for fn in counters + (split_bf16,):
        fn.launches = 0
    f32_matmul.routes.update(split=0, plain=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(steps):
        t = time.monotonic()
        losses.append(trainer.train_step_async(batch))
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"flash_fwd": fa.flash_attention.launches,
                "flash_bwd_dq": fa.flash_bwd_dq.launches,
                "flash_bwd_dkv": fa.flash_bwd_dkv.launches}
    # every float32 product of a step on the tensor cores: a layer's q, k,
    # v, wo, gate, up and w_down and the tied head; the split kernel once
    # for each weight (q/k/v and gate/up side by side: 4 a layer, the head
    # 1) and once for the head's float32 logit gradient
    routes = dict(f32_matmul.routes)
    split_launches = split_bf16.launches
    want_routes = {"split": (7 * cfg.n_layers + 1) * steps, "plain": 0}
    if routes != want_routes:
        raise AssertionError(f"f32_matmul routes over {steps} steps: "
                             f"{routes}, expected {want_routes}")
    if split_launches != (4 * cfg.n_layers + 2) * steps:
        raise AssertionError(f"bf16_split: {split_launches} launches in "
                             f"{steps} steps, expected "
                             f"{4 * cfg.n_layers + 2} per step")
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over {steps} steps on one "
                             f"batch: {losses}")
    for name, n in launches.items():
        if n != cfg.n_layers * steps:
            raise AssertionError(f"{name}: {n} launches in {steps} steps, "
                                 f"expected {cfg.n_layers} per step")
    steady_ms = sum(step_ms[1:]) / (steps - 1)
    profile = _profile_step(lambda: trainer.train_step_async(batch),
                            steady_ms)
    if profile["f32_gemm_kernels"]:
        raise AssertionError(f"float32 GEMMs on the CUDA cores in a step: "
                             f"{profile['f32_gemm_kernels']}")

    # one step's loss and gradients at B=2: the kernels and the split
    # route against the plain attention and cuBLAS float32 products
    # through autograd, from the same float32 params.  Both run
    # bf16 activations and differ at their bf16 rounding points (the
    # attention output summed in another order; dQ/dK/dV from lse and
    # D = rowsum(dO * O_bf16) against autograd's softmax backward), each up
    # to 2^-8 relative, compounded over 12 layers: the loss within 1e-3
    # relative, each gradient leaf within 5e-2 relative L2 error.
    tree = as_trainable(init_params(cfg, device="cuda", seed=SEED,
                                    dtype=torch.float32), "cuda")
    names, leaves = zip(*_flat(tree))
    res = {}
    for use_kernel in (True, False):
        with (contextlib.nullcontext() if use_kernel
              else _plain_float32_products()):
            logits = model_lib.forward_train(tree, batch[:2, :-1], cfg=cfg,
                                             use_kernel=use_kernel)
            loss = cross_entropy_loss(logits, batch[:2, 1:])
            del logits
            res[use_kernel] = (loss.item(),
                               torch.autograd.grad(loss, leaves))
            del loss
    loss_rel = abs(res[True][0] - res[False][0]) / abs(res[False][0])
    grad_rel = {}
    for name, a, b_ in zip(names, res[True][1], res[False][1]):
        denom = b_.float().norm().item()
        grad_rel[name] = ((a.float() - b_.float()).norm().item() / denom
                          if denom else 0.0)
    if not loss_rel <= 1e-3 or not max(grad_rel.values()) <= 5e-2:
        raise AssertionError(f"kernel vs plain step at B=2: loss rel "
                             f"{loss_rel}, grad rel {grad_rel}")
    del res, tree, leaves

    # save_npz -> load_or_init, as trained (float32) and as train_model.py
    # saves it (bf16), into a temporary directory
    ckpt = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tree = astype(trainer.params, dtype)
            path = os.path.join(tmp, f"dv-base-{tag}.npz")
            save_npz(path, tree)
            back = dict(_flat(load_or_init(cfg, path, SEED, device="cuda")))
            want = dict(_flat(tree))
            ibits = torch.int32 if dtype == torch.float32 else torch.int16
            if set(back) != set(want) or not all(
                    back[n].dtype == dtype
                    and torch.equal(back[n].view(ibits), want[n].view(ibits))
                    for n in want):
                raise AssertionError(f"checkpoint {tag}: load_or_init did "
                                     f"not give back the saved bits")
            ckpt[tag] = os.path.getsize(path) / 1e6
    out = {
        "phase": "train", "model": cfg.name, "params": n_params,
        "weights": f"random (seed {SEED})", "batch": [B, S + 1],
        "param_dtype": "float32", "act_dtype": "bfloat16",
        "optimizer": f"train_model.py chain, lr {lr}, warmup {warmup}, "
                     f"{steps} steps",
        "losses": losses, "step_ms": step_ms, "ms_per_step": steady_ms,
        "tokens_per_s": B * S / (steady_ms / 1e3),
        "peak_mem_gb": peak_gb, "launches": launches,
        "f32_matmul_routes": routes, "bf16_split_launches": split_launches,
        "parity_b2": {"loss_rel": loss_rel, "loss_tol": 1e-3,
                      "grad_rel_max": max(grad_rel.values()),
                      "grad_tol": 5e-2, "grad_rel": grad_rel},
        "checkpoint_mb": ckpt, "checkpoint_bit_equal": True,
        "profile_one_step": profile, "data_s": t_data,
    }
    del trainer
    out["seconds"] = time.monotonic() - t0
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase train_parallel: DP x TP, ring attention (SP), GPipe (PP)
# ---------------------------------------------------------------------------

# DP2 x TP2 on dv-base: 4 ranks on one card, phase train's batch and chain
TP_TRAIN = dict(n_data=2, n_model=2, batch=8, seq=2048, steps=3, lr=3e-4)
# the first step against one rank, bf16 activations on both sides: phase
# train's kernel-vs-plain bounds (each bf16 rounding up to 2^-8 relative,
# compounded over 12 layers and the backward; here the partial products
# are summed over the ranks in another order)
TP_LOSS_REL, TP_GRAD_REL = 1e-3, 5e-2
# SP: dv-base's attention width at a sequence two ranks cut in half
SP_SHAPE = dict(B=1, H=6, KV=2, S=8192, HD=128, length=7000)
SP_TOL = 2e-5
# the ring's backward against autograd of plain float32 attention, each of
# dq, dk, dv: |g - g_plain| <= SP_GRAD_TOL * max(max|g_plain|, 1) (on the
# CPU the JAX ring's gradients were within 2.1e-6 of dense at S 4,096)
SP_GRAD_TOL = 2e-5
# PP: train_model.py --pp on dv-base
PP_ARGS = ["--model", "dv-base", "--pp", "2", "--pp-micro", "4",
           "--batch", "8", "--seq", "2048", "--steps", "2"]
PP_LOSS_REL = 1e-5
RANKS_TIMEOUT_S = 600.0
# the phase's model and device (a rehearsal on the CPU sets them smaller)
TRAIN_PARALLEL_MODEL, TRAIN_PARALLEL_DEVICE = "dv-base", "cuda"


def _cuda_rank_setup(device) -> None:
    """A spawned rank's card: its device current, TF32 off (as in
    :func:`main`), the kernel library that phase ``build`` built loaded."""
    from deepvision_tpu_torch.engine.kernels import _build

    if device.type != "cuda":
        return
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()


def _np_tree_of(tree) -> dict:
    """Copies of the tree's leaves as float32 numpy arrays, by flat name."""
    return {name: np.array(leaf.detach().float().cpu().numpy())
            for name, leaf in _flat(tree)}


def _dp_tp_rank(rank: int, store_path: str, spec: dict) -> dict:
    """One rank of the DP2 x TP2 run (a spawned process): ``Trainer(mesh,
    plan)`` on dv-base, 3 steps on the global batch.  Returns its losses,
    step times, launches, collectives and peak memory; rank 0 also the
    first step's gradients and the params after step 1 and after the last
    step, gathered over its model group (numpy)."""
    from deepvision_tpu_torch.engine.config import get_model_config
    from deepvision_tpu_torch.engine.kernels import flash_attention as fa
    from deepvision_tpu_torch.engine.parallel import (
        ShardPlan,
        gather_params,
        make_mesh,
    )
    from deepvision_tpu_torch.engine.training import (
        Trainer,
        train_model_chain,
    )

    t_spawned = time.time()
    mesh = make_mesh(spec["n_model"], spec["n_data"], rank=rank,
                     store_path=store_path, device=spec["device"])
    _cuda_rank_setup(mesh.device)
    cfg = get_model_config(spec["model"])
    plan = ShardPlan.for_model(cfg, spec["n_model"])
    trainer = Trainer(cfg, mesh=mesh, plan=plan,
                      tx=train_model_chain(*spec["chain"]), seed=SEED,
                      param_dtype=torch.float32, use_kernel=True)
    batch = spec["tokens"]
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for fn in counters:
        fn.launches = 0
    groups = (mesh.model, mesh.data)
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else lambda: None)
    sync()
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ready = time.time()
    losses, step_ms, wait_ms, calls = [], [], [], []
    grads = params1 = None
    for step in range(spec["steps"]):
        w0 = sum(g.wait_s for g in groups)
        c0 = sum(g.calls for g in groups)
        t = time.monotonic()
        losses.append(trainer.train_step_async(batch))
        sync()
        step_ms.append((time.monotonic() - t) * 1e3)
        wait_ms.append((sum(g.wait_s for g in groups) - w0) * 1e3)
        calls.append(sum(g.calls for g in groups) - c0)
        if step == 0:
            first_done = time.time()
            grads = gather_params(
                {n: p.grad for n, p in _flat(trainer.params)},
                {n: d for n, d in _flat(plan.param_dims(cfg))}, mesh.model)
            params1 = trainer.full_params()
            if rank == 0:
                grads, params1 = _np_tree_of(grads), _np_tree_of(params1)
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if mesh.device.type == "cuda" else None)
    launches = {"flash_fwd": fa.flash_attention.launches,
                "flash_bwd_dq": fa.flash_bwd_dq.launches,
                "flash_bwd_dkv": fa.flash_bwd_dkv.launches}
    params = trainer.full_params()
    out = {"rank": rank, "data_index": mesh.data_index,
           "model_index": mesh.model_index, "device": str(mesh.device),
           "losses": [float(x) for x in losses], "step_ms": step_ms,
           "collective_ms": wait_ms, "collectives": calls,
           "launches": launches, "peak_mem_gb": peak_gb,
           "spawned_at": t_spawned, "ready_at": ready,
           "first_step_done_at": first_done}
    if rank == 0:
        out.update(grads=grads, params1=params1,
                   params_last=_np_tree_of(params))
    return out


def _one_rank_reference(cfg, chain, tokens, steps: int) -> dict:
    """The one-rank ``Trainer`` on the same seed, chain and batch: the
    first step's loss, gradients and params, and the params after
    ``steps`` steps (numpy)."""
    from deepvision_tpu_torch.engine.training import (
        Trainer,
        train_model_chain,
    )

    trainer = Trainer(cfg, tx=train_model_chain(*chain), seed=SEED,
                      param_dtype=torch.float32, use_kernel=True,
                      device=TRAIN_PARALLEL_DEVICE)
    batch = torch.from_numpy(tokens)
    loss = trainer.train_step(batch)
    out = {"loss": loss,
           "grads": _np_tree_of({n: p.grad for n, p in
                                 _flat(trainer.params)}),
           "params1": _np_tree_of(trainer.params)}
    for _ in range(steps - 1):
        trainer.train_step(batch)
    out["params_last"] = _np_tree_of(trainer.params)
    del trainer
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def _rel_l2(a, b) -> float:
    denom = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / denom if denom else 0.0


def _train_parallel_dp_tp(tok) -> dict:
    """DP2 x TP2 through ``Trainer(mesh, plan)``: 4 spawned ranks on
    ``cuda:0``, then the one-rank reference in this process."""
    from deepvision_tpu_torch.engine.config import get_model_config
    from deepvision_tpu_torch.engine.parallel import launch

    cfg = get_model_config(TRAIN_PARALLEL_MODEL)
    c = TP_TRAIN
    warmup = min(200, max(1, c["steps"] // 10))
    chain = (c["lr"], warmup, max(c["steps"], warmup + 1))
    tokens = _train_batch(tok, c["batch"], c["seq"] + 1, SEED).numpy()
    spec = {"n_data": c["n_data"], "n_model": c["n_model"],
            "steps": c["steps"], "chain": chain, "tokens": tokens,
            "model": TRAIN_PARALLEL_MODEL, "device": TRAIN_PARALLEL_DEVICE}
    t0 = time.monotonic()
    ranks = launch(_dp_tp_rank, c["n_data"] * c["n_model"], (spec,),
                   timeout_s=RANKS_TIMEOUT_S,
                   build_kernels=TRAIN_PARALLEL_DEVICE == "cuda")
    ranks_s = time.monotonic() - t0
    lead = ranks[0]
    for r in ranks:
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"train_parallel: rank {r['rank']} "
                                 f"non-finite losses {r['losses']}")
        if r["losses"] != lead["losses"]:
            raise AssertionError(f"train_parallel: losses differ between "
                                 f"ranks {[x['losses'] for x in ranks]}")
        for name, n in r["launches"].items():
            if n != cfg.n_layers * c["steps"]:
                raise AssertionError(
                    f"train_parallel: rank {r['rank']} launched {name} {n} "
                    f"times in {c['steps']} steps, expected {cfg.n_layers} "
                    "a step")
    t_ref = time.monotonic()
    ref = _one_rank_reference(cfg, chain, tokens, c["steps"])
    ref_s = time.monotonic() - t_ref
    loss_rel = abs(lead["losses"][0] - ref["loss"]) / abs(ref["loss"])
    grad_rel = {n: _rel_l2(lead["grads"][n], g)
                for n, g in ref["grads"].items()}
    # train_model.py's warmup gives the first update a rate of 0: both
    # sides' params after it are the seed's, and the gathered ones must be
    # them bit for bit
    params1_diff = {n: float(np.abs(lead["params1"][n] - p).max())
                    for n, p in ref["params1"].items()}
    params1_equal = (set(lead["params1"]) == set(ref["params1"])
                     and not any(params1_diff.values()))
    if not (loss_rel <= TP_LOSS_REL and max(grad_rel.values()) <= TP_GRAD_REL
            and params1_equal):
        raise AssertionError(
            f"train_parallel: DP2 x TP2 against one rank: loss rel "
            f"{loss_rel} (tol {TP_LOSS_REL}), grad rel {grad_rel} (tol "
            f"{TP_GRAD_REL}), params after step 1 apart by {params1_diff}")
    start = ref["params1"]
    update_rel = {n: _rel_l2(lead["params_last"][n] - start[n],
                             p - start[n])
                  for n, p in ref["params_last"].items()}
    ready = [r["ready_at"] for r in ranks]
    first = [r["first_step_done_at"] for r in ranks]
    return {
        "model": cfg.name, "mesh": {"data": c["n_data"],
                                    "model": c["n_model"]},
        "weights": f"random (seed {SEED})", "batch": [c["batch"],
                                                     c["seq"] + 1],
        "rows_per_data_rank": c["batch"] // c["n_data"],
        "param_dtype": "float32", "act_dtype": "bfloat16",
        "optimizer": f"train_model.py chain, lr {c['lr']}, warmup {warmup}, "
                     f"{c['steps']} steps",
        "losses": lead["losses"],
        "ranks": [{k: r[k] for k in (
            "rank", "data_index", "model_index", "device", "step_ms",
            "collective_ms", "collectives", "launches", "peak_mem_gb")}
            for r in ranks],
        "ms_per_step_steady": float(np.mean(
            [np.mean(r["step_ms"][1:]) for r in ranks])),
        "collective_ms_per_step_steady": float(np.mean(
            [np.mean(r["collective_ms"][1:]) for r in ranks])),
        "skew_s": {"ready": max(ready) - min(ready),
                   "first_step_done": max(first) - min(first),
                   "spawn_to_ready": [r["ready_at"] - r["spawned_at"]
                                      for r in ranks]},
        "vs_one_rank": {"loss": ref["loss"], "loss_rel": loss_rel,
                        "loss_tol": TP_LOSS_REL,
                        "grad_rel_max": max(grad_rel.values()),
                        "grad_tol": TP_GRAD_REL, "grad_rel": grad_rel,
                        "params_after_step1_bit_equal": params1_equal,
                        "update_rel_after_last_step": update_rel},
        "ranks_s": ranks_s, "reference_s": ref_s}


def _ring_inputs(c: dict, device):
    """Seeded q, k, v, the lengths and the backward's cotangent."""
    gen = torch.Generator().manual_seed(SEED)
    q = torch.randn(c["B"], c["H"], c["S"], c["HD"], generator=gen)
    k = torch.randn(c["B"], c["KV"], c["S"], c["HD"], generator=gen)
    v = torch.randn(c["B"], c["KV"], c["S"], c["HD"], generator=gen)
    lens = torch.tensor([c["length"]] * c["B"], dtype=torch.int32)
    d_out = torch.randn(c["B"], c["H"], c["S"], c["HD"], generator=gen)
    return [x.to(device) for x in (q, k, v, lens, d_out)]


def _ring_rank(rank: int, store_path: str, spec: dict) -> dict:
    """One rank of the SP check (a spawned process): its chunk of the
    seeded float32 inputs through ``ring_attention``, then the same call
    timed; then the backward from its chunk of the cotangent, and the
    backward timed.  Returns its output and gradients (numpy) and the
    times."""
    from deepvision_tpu_torch.engine.ring_attention import (
        make_seq_mesh,
        ring_attention,
    )

    n = spec["n"]
    group = make_seq_mesh(n, rank=rank, store_path=store_path,
                          device=spec["device"])
    _cuda_rank_setup(group.device)
    sync = (torch.cuda.synchronize if group.device.type == "cuda"
            else lambda: None)
    q, k, v, lens, d_out = _ring_inputs(spec["shape"], group.device)
    c = q.shape[2] // n
    part = [x[:, :, rank * c:(rank + 1) * c].contiguous()
            for x in (q, k, v, d_out)]
    d_out = part.pop()
    out = ring_attention(*part, lens, group)
    sync()
    times = []
    for _ in range(3):
        w0 = group.wait_s
        t = time.monotonic()
        ring_attention(*part, lens, group)
        sync()
        times.append(((time.monotonic() - t) * 1e3,
                      (group.wait_s - w0) * 1e3))
    leaves = [x.requires_grad_() for x in part]
    ring_attention(*leaves, lens, group).backward(d_out)
    grads = [np.array(x.grad.cpu().numpy()) for x in leaves]
    bwd_times = []
    for _ in range(3):
        res = ring_attention(*leaves, lens, group)
        sync()
        w0 = group.wait_s
        t = time.monotonic()
        res.backward(d_out)
        sync()
        bwd_times.append(((time.monotonic() - t) * 1e3,
                          (group.wait_s - w0) * 1e3))
    return {"out": out.cpu().numpy(), "grads": grads,
            "ms": [t for t, _ in times],
            "sendrecv_ms": [w for _, w in times],
            "backward_ms": [t for t, _ in bwd_times],
            "backward_sendrecv_ms": [w for _, w in bwd_times]}


def _train_parallel_sp() -> dict:
    from deepvision_tpu_torch.engine.kernels.flash_attention import (
        flash_attention_reference,
    )
    from deepvision_tpu_torch.engine.parallel import launch

    n = 2
    t0 = time.monotonic()
    ranks = launch(_ring_rank, n, ({"n": n, "shape": SP_SHAPE,
                                    "device": TRAIN_PARALLEL_DEVICE},),
                   timeout_s=RANKS_TIMEOUT_S)
    q, k, v, lens, d_out = _ring_inputs(SP_SHAPE, TRAIN_PARALLEL_DEVICE)
    want = flash_attention_reference(q, k, v, lens).cpu().numpy()
    got = np.concatenate([r["out"] for r in ranks], axis=2)
    L = SP_SHAPE["length"]
    err = float(np.abs(got[:, :, :L] - want[:, :, :L]).max())
    if not (err <= SP_TOL and np.isfinite(got[:, :, :L]).all()):
        raise AssertionError(f"train_parallel: ring attention max_abs_err "
                             f"{err} > {SP_TOL}")
    plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, lens), 3)
    # the backward, every row: the length is over 0, so the dense function
    # equals the ring's everywhere
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    res = flash_attention_reference(*leaves, lens)
    res.backward(d_out, retain_graph=True)
    grad_err = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        g = np.concatenate([r["grads"][i] for r in ranks], axis=2)
        g_plain = leaves[i].grad.cpu().numpy()
        bound = SP_GRAD_TOL * max(float(np.abs(g_plain).max()), 1.0)
        e = float(np.abs(g - g_plain).max())
        grad_err[name] = {"max_abs_err": e, "bound": bound}
        if not (e <= bound and np.isfinite(g).all()):
            raise AssertionError(f"train_parallel: ring attention {name} "
                                 f"max_abs_err {e} > {bound}")
    plain_bwd_ms = cuda_ms(lambda: res.backward(d_out, retain_graph=True),
                           3)
    del q, k, v, d_out, leaves, res
    return {"shape": SP_SHAPE, "ranks": n, "dtype": "float32",
            "max_abs_err": err, "tol": SP_TOL,
            "ms": [r["ms"] for r in ranks],
            "sendrecv_ms": [r["sendrecv_ms"] for r in ranks],
            "plain_ms_one_device": plain_ms,
            "backward": {"grad_err": grad_err, "tol": SP_GRAD_TOL,
                         "ms": [r["backward_ms"] for r in ranks],
                         "sendrecv_ms": [r["backward_sendrecv_ms"]
                                         for r in ranks],
                         "plain_ms_one_device": plain_bwd_ms},
            "seconds": time.monotonic() - t0}


def _write_corpus(path: str, n_docs: int, seed: int) -> None:
    """Seeded interview transcripts from the in-repo scenarios, joined by
    ``<|eot|>`` as ``scripts/build_corpus.py`` writes a corpus."""
    import random

    rng = random.Random(seed)
    scenarios = []
    for name in sorted(glob.glob(os.path.join(
            ROOT, "resources", "scenarios", "builtin", "*.json"))):
        with open(name, encoding="utf-8") as fh:
            scenarios.append(json.load(fh))
    docs = []
    for _ in range(n_docs):
        sc = rng.choice(scenarios)
        parts = [f"访谈主题：{sc['name']}\n{sc['description']}\n\n"]
        for turn in range(rng.randint(4, 10)):
            d = rng.choice(sc["dimensions"])
            aspects = rng.sample(d["key_aspects"],
                                 rng.randint(1, len(d["key_aspects"])))
            parts.append(
                f"问题{turn + 1}（{d['name']}）：请具体说明{d['description']}。"
                f"\n回答：关于{'、'.join(aspects)}，目前第{rng.randint(1, 30)}"
                f"轮访谈确认了现状与期望。\n")
        docs.append("".join(parts))
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("<|eot|>".join(docs))


def _pp_loss_rank(rank: int, store_path: str, spec: dict) -> float:
    """One stage of the PP loss check (a spawned process): the pipeline's
    float32 loss on the seed's weights and the fixed batch."""
    from deepvision_tpu_torch.engine.config import get_model_config
    from deepvision_tpu_torch.engine.pipeline_parallel import (
        make_pp_loss_fn,
        make_pp_mesh,
        place_pp_params,
    )
    from deepvision_tpu_torch.engine.weights import init_params

    group = make_pp_mesh(spec["n_stages"], rank=rank, store_path=store_path,
                         device=spec["device"])
    _cuda_rank_setup(group.device)
    cfg = get_model_config(spec["model"])
    full = init_params(cfg, device="cpu", seed=SEED, dtype=torch.float32)
    params = {k: (v.to(group.device) if not isinstance(v, dict) else
                  {n: t.to(group.device) for n, t in v.items()})
              for k, v in place_pp_params(full, group, cfg).items()}
    del full
    loss_fn = make_pp_loss_fn(cfg, group, spec["n_micro"])
    with torch.no_grad():
        return loss_fn(params, torch.from_numpy(spec["tokens"]).to(
            group.device)).item()


def _train_parallel_pp(tok) -> dict:
    """``python -m deepvision_tpu_torch.train_model --pp 2`` on a seeded
    corpus, then the pipeline's loss against one device's."""
    from deepvision_tpu_torch.engine import model as model_lib
    from deepvision_tpu_torch.engine.config import get_model_config
    from deepvision_tpu_torch.engine.parallel import launch
    from deepvision_tpu_torch.engine.training import cross_entropy_loss
    from deepvision_tpu_torch.engine.weights import init_params, load_npz

    cfg = get_model_config(TRAIN_PARALLEL_MODEL)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        _write_corpus(corpus, 120, SEED)
        out = os.path.join(tmp, "ckpt", "dv-base-pp.npz")
        cmd = [sys.executable, "-m", "deepvision_tpu_torch.train_model",
               *PP_ARGS, "--corpus", corpus, "--tokenizer",
               os.path.join(ROOT, "resources", "tokenizer",
                            "dv_bpe_16k.json"),
               "--out", out, "--log-every", "1", "--save-every", "0",
               # a tail long enough for the validation batches, which run
               # through the pipeline too
               "--val-frac", "0.4"]
        # its own session, so that a timeout ends its stage process too
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=RANKS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.communicate()
            raise
        cli_s = time.monotonic() - t0
        log = stdout.splitlines()
        stages_line = (f"pipeline parallel: 2 stages x "
                       f"{cfg.n_layers // 2} layers, 4 microbatches")
        final = next((line for line in log if line.startswith("saved ")),
                     "")
        val = re.search(r"final val_loss=([0-9.]+);", final)
        if (proc.returncode != 0 or stages_line not in log or val is None
                or not math.isfinite(float(val.group(1)))):
            raise AssertionError(
                f"train_parallel: train_model --pp exited "
                f"{proc.returncode}:\n{stdout[-3000:]}\n{stderr[-3000:]}")
        ckpt = load_npz(out, device="cpu")
        stacks = {n: tuple(t.shape) for n, t in ckpt["blocks"].items()}
        if any(shape[0] != cfg.n_layers for shape in stacks.values()):
            raise AssertionError(f"train_parallel: --pp checkpoint stacks "
                                 f"{stacks}")
        ckpt_mb = os.path.getsize(out) / 1e6
    steps = [line for line in log if line.startswith("step ")]
    # the pipeline's loss on fixed weights and batch against one device's
    t_loss = time.monotonic()
    tokens = _train_batch(tok, 8, TP_TRAIN["seq"] + 1, SEED + 1).numpy()
    pp = launch(_pp_loss_rank, 2, ({"n_stages": 2, "n_micro": 4,
                                    "tokens": tokens,
                                    "model": TRAIN_PARALLEL_MODEL,
                                    "device": TRAIN_PARALLEL_DEVICE},),
                timeout_s=RANKS_TIMEOUT_S)
    params = init_params(cfg, device=TRAIN_PARALLEL_DEVICE, seed=SEED,
                         dtype=torch.float32)
    batch = torch.from_numpy(tokens).to(TRAIN_PARALLEL_DEVICE)
    with torch.no_grad():
        want = cross_entropy_loss(model_lib.forward_train(
            params, batch[:, :-1], cfg=cfg, act_dtype=torch.float32),
            batch[:, 1:]).item()
    del params
    rel = abs(pp[0] - want) / abs(want)
    if pp[0] != pp[1] or not rel <= PP_LOSS_REL:
        raise AssertionError(f"train_parallel: PP loss {pp} against one "
                             f"device's {want} (rel {rel} > {PP_LOSS_REL})")
    return {"cli": {"argv": PP_ARGS, "exit": proc.returncode,
                    "stages_line": stages_line, "step_lines": steps,
                    "final_line": final,
                    "corpus_line": next((line for line in log
                                         if line.startswith("corpus: ")),
                                        None),
                    "checkpoint_mb": ckpt_mb, "stacks": stacks,
                    "seconds": cli_s},
            "loss_check": {"pp_loss": pp[0], "one_device_loss": want,
                           "rel": rel, "tol": PP_LOSS_REL,
                           "act_dtype": "float32",
                           "seconds": time.monotonic() - t_loss}}


def phase_train_parallel() -> dict:
    """Multi-device training on one card, every rank a spawned process on
    ``cuda:0`` over gloo: DP2 x TP2 ``Trainer(mesh, plan)`` on dv-base
    against one rank; ring attention and its backward over 2 ranks
    against plain float32 attention and its autograd; ``train_model --pp
    2`` and the pipeline's loss against one device's."""
    import multiprocessing

    from deepvision_tpu_torch.engine.tokenizer import get_tokenizer

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    tok = get_tokenizer(os.path.join(ROOT, "resources", "tokenizer",
                                     "dv_bpe_16k.json"))
    out = {"phase": "train_parallel"}
    out["dp_tp"] = _train_parallel_dp_tp(tok)
    emit({"phase": "train_parallel", "part": "dp_tp", **out["dp_tp"]})
    out["sp"] = _train_parallel_sp()
    emit({"phase": "train_parallel", "part": "sp", **out["sp"]})
    out["pp"] = _train_parallel_pp(tok)
    emit({"phase": "train_parallel", "part": "pp", **out["pp"]})
    if multiprocessing.active_children():
        raise AssertionError(f"train_parallel: ranks outlived the phase "
                             f"{multiprocessing.active_children()}")
    # #2, #4 and #5 launches summed over the DP x TP ranks
    out["launches"] = {
        name: sum(r["launches"][name] for r in out["dp_tp"]["ranks"])
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    out["seconds"] = time.monotonic() - t0
    emit({"phase": "train_parallel", "part": "summary",
          "launches_all_ranks": out["launches"], "seconds": out["seconds"]})
    return out


KERNELS = {
    "flash_fwd": {
        "source": "deepvision_tpu_torch/engine/kernels/csrc/flash_fwd.cu",
        "replaces": "deepvision_tpu/engine/kernels/flash_attention.py:33",
        "compute_route": "tensor_core",
    },
    "paged_decode_update": {
        "source": "deepvision_tpu_torch/engine/kernels/csrc/paged_decode.cu",
        "replaces": "deepvision_tpu/engine/kernels/paged_attention.py:223",
        "compute_route": "f32_cuda_core",
    },
    "paged_chunk": {
        "source": "deepvision_tpu_torch/engine/kernels/csrc/paged_chunk.cu",
        "replaces": "deepvision_tpu/engine/kernels/paged_chunk.py:31",
        "compute_route": "tensor_core",
    },
    "flash_bwd_dq": {
        "source": "deepvision_tpu_torch/engine/kernels/csrc/flash_bwd.cu",
        "replaces": "deepvision_tpu/engine/kernels/flash_attention.py:223",
        "compute_route": "tensor_core",
    },
    "flash_bwd_dkv": {
        "source": "deepvision_tpu_torch/engine/kernels/csrc/flash_bwd.cu",
        "replaces": "deepvision_tpu/engine/kernels/flash_attention.py:272",
        "compute_route": "tensor_core",
    },
    "paged_attention": {
        "source": "deepvision_tpu_torch/engine/kernels/csrc/paged_attention.cu",
        "replaces": "deepvision_tpu/engine/kernels/paged_attention.py:37",
        "compute_route": "f32_cuda_core",
    },
    "paged_update_bkv": {
        "source": "deepvision_tpu_torch/engine/kernels/csrc/paged_attention.cu",
        "replaces": "deepvision_tpu/engine/kernels/paged_attention.py:413",
        "compute_route": "f32_cuda_core",
    },
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # fail before printing anything when the package is not beside us
    import deepvision_tpu_torch.engine.engine  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    dev = phase_device()
    phase_build()
    main_cases = phase_kernels()
    eng = phase_engine()
    eng_prefix = phase_engine_prefix()
    phase_engine_prefix_trained()
    api = phase_paged_api()
    gateway = phase_gateway()
    phase_gateway_int8(gateway)
    phase_engine_w8(eng)
    phase_gateway_w8(gateway)
    app = phase_app()
    ops = phase_ops()
    phase_hf_import()
    phase_orbax()
    engine_tp = phase_engine_tp()
    train = phase_train()
    train_parallel = phase_train_parallel()
    emit({"phase": "all", "seconds": time.monotonic() - t0})
    # each kernel's launches come from the phase whose path it is
    launches = {**eng["launches"],
                "paged_chunk": eng_prefix["launches"]["paged_chunk"],
                "flash_bwd_dq": train["launches"]["flash_bwd_dq"],
                "flash_bwd_dkv": train["launches"]["flash_bwd_dkv"],
                **api["launches"]}
    # the card's name and power limit again: the output has outgrown what
    # a tail-limited log keeps, and its first lines fall out of it
    print(dev["nvidia_smi"][0] if dev["nvidia_smi"] else
          "nvidia-smi: no output", flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "launches": launches[name],
         "max_abs_err": main_cases[name]["max_abs_err"],
         "ms": main_cases[name]["ms"],
         "plain_ms": main_cases[name]["plain_ms"],
         "bound_ms": main_cases[name]["bound_ms"],
         "bound_by": main_cases[name]["bound_by"],
         "library_ms": main_cases[name]["library_ms"],
         "tflops": main_cases[name]["gflop"] / main_cases[name]["ms"],
         # the same from the host, and the profiler's kernel time, where
         # the case has them; the column split and the kernel unsplit
         "events_ms": main_cases[name].get("events_ms"),
         "device_ms": main_cases[name].get("device_ms"),
         "splits": main_cases[name].get("splits"),
         "ms_one_split": main_cases[name].get("ms_one_split"),
         "device_ms_one_split": main_cases[name].get("device_ms_one_split"),
         # the launches of phase app's HTTP traffic and of phase ops'
         # CLIs, for the kernels of their paths
         "app_launches": app["launches"].get(name),
         "ops_launches": ops["launches"].get(name),
         # tensor-parallel serving (phase engine_tp): launches summed over
         # the ranks, and the kernel at each model's shard shape
         "tp_launches": engine_tp["launches_all_ranks"].get(name),
         "tp_shard_cases": {
             model: {k: case[k] for k in (
                 "case", "shape", "max_abs_err", "ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms", "device_ms")}
             for model, case in main_cases["tp_shard"].get(name, {}).items()},
         # DP2 x TP2 training (phase train_parallel): launches summed over
         # the 4 ranks, and the kernel at the ranks' shard shape
         "train_parallel_launches": train_parallel["launches"].get(name),
         "train_shard_case": {
             k: main_cases["train_shard"][name][k] for k in (
                 "case", "shape", "max_abs_err", "ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms")}
         if name in main_cases["train_shard"] else None}
        for name in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
