"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its own seconds:

1. device  — the card's name and power limit;
2. build   — the CUDA kernels compiled from ``csrc/`` (nvcc + ctypes);
3. kernels — every kernel of the serving and training paths against its
   plain PyTorch version on the card, at the main paths' shapes (bf16 and
   int8 pools; the backward kernels at the training shape, ragged, f32 and
   head dims 32/64/256),
   with times for the kernel, the plain version and, where one exists, the
   PyTorch library call that computes the same function;
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
6. train   — dv-base fine-tuning through the port's ``Trainer`` at its
   full width and depth: float32 params (random, seed 0), bf16
   activations, batch 8 x 2,049 tokens of seeded interview text through
   the dv_bpe_16k tokenizer, ``train_model.py``'s optimizer chain, the
   flash forward and both backward kernels.  The loss must be finite and
   fall over 8 steps on the batch, each backward kernel must run 12 times
   a step, one step at B=2 must agree with the plain attention through
   autograd (loss and every gradient leaf), and ``save_npz`` ->
   ``load_or_init`` must give back the same bits; one step is profiled;
7. the card's name and power limit again, then the ``kernels`` line the
   benchmark contract reads;
8. shutdown, then the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line.  Without CUDA it exits 2 before any phase.
"""

from __future__ import annotations

import concurrent.futures
import gc
import glob
import json
import math
import os
import subprocess
import sys
import time

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


def phase_build() -> None:
    from deepvision_tpu_torch.engine.kernels import _build

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
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "sources": [os.path.relpath(p, ROOT) for p in _build.sources()],
          "ptxas": regs[:48]})


def _flash_case(name, B, H, KV, S, HD, lens, dtype, gen, iters=20):
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
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, seq), iters)
    ms_lse = cuda_ms(lambda: fa.flash_forward(q, k, v, seq, with_lse=True),
                     iters)
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, seq),
                       max(2, iters // 5))
    idx = torch.arange(S, device=dev)
    mask = ((idx[None, :] <= idx[:, None])[None]
            & (idx[None, None, :] < seq.long()[:, None, None]))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(
        lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True), iters)
    itemsize = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * itemsize + 4 * B
    pairs = sum(sum(min(r + 1, n) for r in range(S)) for n in lens)
    flops = 4.0 * H * HD * pairs
    rate = H100_BF16_FLOP_S if dtype == torch.bfloat16 else H100_F32_FLOP_S
    bound_ms, bound_by = bound(nbytes, flops, rate)
    out = {"case": name, "shape": [B, H, KV, S, HD], "seq_lens": lens,
           "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
           "tol": tol, "ms": ms, "ms_with_lse": ms_lse, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "gflop": flops / 1e9}
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
            "bound_by": bound_by, "gflop": flops / 1e9}
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
    return main


def _decode_case(name, B, H, KV, HD, P, MP, lens, pool_dtype, gen,
                 iters=50):
    from deepvision_tpu_torch.engine.kernels import paged_attention as pa
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
    # each sequence owns MP distinct pages; a len-1 slot is an inactive
    # scheduler slot: block table all zeros (trash page)
    bt = (1 + torch.randperm(B * MP, generator=gen, device=dev)
          ).reshape(B, MP).to(torch.int32)
    for i, n in enumerate(lens):
        if n == 1:
            bt[i] = 0
    seq = torch.tensor(lens, dtype=torch.int32, device=dev)
    kp1, vp1 = kp.clone(), vp.clone()
    kp2, vp2 = kp.clone(), vp.clone()
    got, _, _ = pa.paged_attention_update(q, nk, nv, kp1, vp1, bt, seq,
                                          k_scale=ks, v_scale=vs)
    want, _, _ = pa.paged_attention_update_reference(
        q, nk, nv, kp2, vp2, bt, seq, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    active = [i for i, n in enumerate(lens) if n > 1]
    if active:
        err_active = (got[active].float() - want[active].float()).abs().max().item()
    else:
        err_active = 0.0
    tol = 2e-2
    if not err_active <= tol or not torch.isfinite(got).all():
        raise AssertionError(f"decode {name}: max_abs_err {err_active} > {tol}")
    for a, b_ in ((kp1, kp2), (vp1, vp2)):
        if not torch.equal(a[:, 1:], b_[:, 1:]):
            raise AssertionError(f"decode {name}: pools differ outside page 0")
    ms = cuda_ms(lambda: pa.paged_attention_update(
        q, nk, nv, kp1, vp1, bt, seq, k_scale=ks, v_scale=vs), iters)
    plain_ms = cuda_ms(lambda: pa.paged_attention_update_reference(
        q, nk, nv, kp2, vp2, bt, seq, k_scale=ks, v_scale=vs),
        max(2, iters // 10))
    itemsize = kp.element_size()
    live = sum(lens)
    nbytes = (2 * q.numel() * 2 + 2 * nk.numel() * itemsize
              + 2 * live * KV * HD * itemsize + bt.numel() * 4 + 4 * B)
    flops = 4.0 * H * HD * live
    bound_ms, bound_by = bound(nbytes, flops, H100_BF16_FLOP_S)
    out = {"case": name, "shape": [B, H, KV, HD, P, MP], "seq_lens": lens,
           "pool_dtype": str(pool_dtype).split(".")[-1],
           "max_abs_err": err_active, "tol": tol, "ms": ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "bound_by": bound_by, "mbytes": nbytes / 1e6}
    emit({"phase": "kernels", "kernel": "paged_decode_update", **out})
    return out


def _chunk_case(name, B, C, H, KV, HD, P, MP, starts, ends, pool_dtype, gen,
                iters=20):
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
    got = pc.paged_chunk_attention(q, kp, vp, bt, st, en, k_scale=ks,
                                   v_scale=vs)
    want = pc.paged_chunk_attention_reference(q, kp, vp, bt, st, en,
                                              k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    # bf16 outputs: both sides round one fp32 value (1 bf16 ulp of an O(1)
    # output is 2^-8) after summing in another order
    tol = 2e-2
    if not err <= tol or not torch.isfinite(got).all():
        raise AssertionError(f"chunk {name}: max_abs_err {err} > {tol}")
    ms = cuda_ms(lambda: pc.paged_chunk_attention(
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
    library_ms = cuda_ms(
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
           "tol": tol, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
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
                              64, 32, [start], [n], pool, gen)
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
    return main


def phase_kernels() -> dict:
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    bf16 = torch.bfloat16
    flash = [
        _flash_case("main_b4_s1024", 4, 6, 2, 1024, 128,
                    [1024, 901, 640, 300], bf16, gen),
        _flash_case("b4_s2048", 4, 6, 2, 2048, 128,
                    [2048, 1500, 977, 300], bf16, gen, iters=10),
        _flash_case("train_b8_s2048", 8, 6, 2, 2048, 128, [2048] * 8, bf16,
                    gen, iters=10),
        _flash_case("b4_s256", 4, 6, 2, 256, 128, [256, 200, 77, 1], bf16,
                    gen),
        _flash_case("hd32", 2, 4, 2, 256, 32, [256, 131], bf16, gen),
        _flash_case("hd256", 1, 8, 1, 512, 256, [390], bf16, gen),
        _flash_case("hd64_f32", 2, 4, 2, 256, 64, [256, 99], torch.float32,
                    gen),
    ]
    ragged = [2048, 1, 64, 65, 700, 1024, 1500, 33]
    decode = [
        _decode_case("main_b8_len1024", 8, 6, 2, 128, 64, 32, [1024] * 8,
                     bf16, gen),
        _decode_case("b8_ragged", 8, 6, 2, 128, 64, 32, ragged, bf16, gen),
        _decode_case("b8_ragged_int8", 8, 6, 2, 128, 64, 32, ragged,
                     torch.int8, gen),
        _decode_case("hd32", 4, 4, 2, 32, 16, 8, [128, 1, 17, 100], bf16,
                     gen),
        _decode_case("hd256", 2, 8, 1, 256, 64, 4, [256, 130], bf16, gen),
    ]
    chunk = chunk_cases(gen)
    bwd = bwd_cases(gen)
    emit({"phase": "kernels_done", "seconds": time.monotonic() - t0})
    return {"flash_fwd": flash[0], "paged_decode_update": decode[0],
            "paged_chunk": chunk, **bwd}


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
    from deepvision_tpu_torch.engine.weights import count_params

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
        }
    finally:
        eng.shutdown()
    out["seconds"] = time.monotonic() - t0
    emit(out)
    return out


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


def phase_engine_prefix() -> dict:
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
    t0 = time.monotonic()
    tok_path = os.path.join(ROOT, "resources", "tokenizer", "dv_bpe_16k.json")
    eng = LLMEngine(EngineConfig(
        model="dv-base", tokenizer=tok_path, checkpoint_dir=None,
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
            "phase": "engine_prefix", "model": cfg.name,
            "weights": f"random (seed {SEED})", "chunked_prefill": True,
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
    finally:
        eng.shutdown()
    out["seconds"] = time.monotonic() - t0
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
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    groups = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
              "matmul": 0.0, "optimizer": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        if "flash_fwd" in low:
            groups["flash_fwd"] += ms
        elif "flash_bwd_dq" in low:
            groups["flash_bwd_dq"] += ms
        elif "flash_bwd_dkv" in low:
            groups["flash_bwd_dkv"] += ms
        elif "gemm" in low or "cutlass" in low or "xmma" in low:
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
            "top_kernels_ms": [[name[:90], ms] for name, ms in top]}


def phase_train() -> dict:
    """dv-base fine-tuning steps through the port's Trainer (float32
    params, bf16 activations, flash forward and backward kernels,
    train_model.py's optimizer chain), random init from the seed."""
    import tempfile

    from deepvision_tpu_torch.engine import model as model_lib
    from deepvision_tpu_torch.engine.config import get_model_config
    from deepvision_tpu_torch.engine.kernels import flash_attention as fa
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
    for fn in counters:
        fn.launches = 0
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

    # one step's loss and gradients at B=2: the kernels against the plain
    # attention through autograd, from the same float32 params.  Both run
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
        logits = model_lib.forward_train(tree, batch[:2, :-1], cfg=cfg,
                                         use_kernel=use_kernel)
        loss = cross_entropy_loss(logits, batch[:2, 1:])
        del logits
        res[use_kernel] = (loss.item(), torch.autograd.grad(loss, leaves))
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


KERNELS = {
    "flash_fwd": {
        "source": "deepvision_tpu_torch/engine/kernels/csrc/flash_fwd.cu",
        "replaces": "deepvision_tpu/engine/kernels/flash_attention.py:33",
    },
    "paged_decode_update": {
        "source": "deepvision_tpu_torch/engine/kernels/csrc/paged_decode.cu",
        "replaces": "deepvision_tpu/engine/kernels/paged_attention.py:223",
    },
    "paged_chunk": {
        "source": "deepvision_tpu_torch/engine/kernels/csrc/paged_chunk.cu",
        "replaces": "deepvision_tpu/engine/kernels/paged_chunk.py:31",
    },
    "flash_bwd_dq": {
        "source": "deepvision_tpu_torch/engine/kernels/csrc/flash_bwd.cu",
        "replaces": "deepvision_tpu/engine/kernels/flash_attention.py:223",
    },
    "flash_bwd_dkv": {
        "source": "deepvision_tpu_torch/engine/kernels/csrc/flash_bwd.cu",
        "replaces": "deepvision_tpu/engine/kernels/flash_attention.py:272",
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
    dev = phase_device()
    phase_build()
    main_cases = phase_kernels()
    eng = phase_engine()
    eng_prefix = phase_engine_prefix()
    train = phase_train()
    # each kernel's launches come from the phase whose path it is
    launches = {**eng["launches"],
                "paged_chunk": eng_prefix["launches"]["paged_chunk"],
                "flash_bwd_dq": train["launches"]["flash_bwd_dq"],
                "flash_bwd_dkv": train["launches"]["flash_bwd_dkv"]}
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
         "library_ms": main_cases[name]["library_ms"]}
        for name in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
