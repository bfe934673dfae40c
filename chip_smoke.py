"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its own seconds:

1. device  — the card's name and power limit;
2. build   — the CUDA kernels compiled from ``csrc/`` (nvcc + ctypes);
3. kernels — every kernel of the serving path against its plain PyTorch
   version on the card, at the main path's shapes (bf16 and int8 pools),
   with times for the kernel, the plain version and, where one exists, the
   PyTorch library call that computes the same function;
4. engine  — ``LLMEngine.generate_text`` on dv-base at its full width and
   depth (12 layers) with random weights from a seed and the dv_bpe_16k
   tokenizer: 8 concurrent json_mode report prompts of 300-900 tokens,
   max_tokens=256, greedy.  Every output must parse, a greedy replay must
   repeat itself, the kernel-path prefill logits must agree with the plain
   ``forward_train``, and both kernels' launch counts over the served
   requests must be above 0;
5. the ``kernels`` line the benchmark contract reads;
6. shutdown, then the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line.  Without CUDA it exits 2 before any phase.
"""

from __future__ import annotations

import concurrent.futures
import glob
import json
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
           "tol": tol, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "gflop": flops / 1e9}
    emit({"phase": "kernels", "kernel": "flash_fwd", **out})
    return out


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
    emit({"phase": "kernels_done", "seconds": time.monotonic() - t0})
    return {"flash_fwd": flash[0], "paged_decode_update": decode[0]}


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
        want = model_lib.forward_train(params, toks[:, :n], cfg=cfg)[0, -1]
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


KERNELS = {
    "flash_fwd": {
        "source": "deepvision_tpu_torch/engine/kernels/csrc/flash_fwd.cu",
        "replaces": "deepvision_tpu/engine/kernels/flash_attention.py:33",
    },
    "paged_decode_update": {
        "source": "deepvision_tpu_torch/engine/kernels/csrc/paged_decode.cu",
        "replaces": "deepvision_tpu/engine/kernels/paged_attention.py:223",
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
    emit({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "launches": eng["launches"][name],
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
