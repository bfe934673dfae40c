"""Parent against change on one card: the attention kernels at their main
shapes and the dv-base train step of the PyTorch/CUDA port.

    python3 scripts/torch_kernel_ab.py PARENT_ROOT CHANGE_ROOT [--out DIR]
        [--parts flash,chunk,bwd,decode,engine,train]

Each root is a checkout of the repo (for the parent, unpack ``git archive
<commit>`` into a directory that ``.gitignore`` lists).  The script runs
four turns on the one card, in the order parent, change, change, parent,
each a fresh process in that root that imports the root's own
``chip_smoke.py`` and runs its phases ``device`` and ``build``, then the
parts asked for (all by default):

- ``flash``: the flash forward at ``main_b4_s1024`` and ``train_b8_s2048``
  and its device time alone (``torch.profiler``) at both shapes, SDPA
  beside it;
- ``chunk``: the paged chunk attention at ``main_s640_n896`` (bf16 pools)
  and its device time;
- ``bwd``: the backward kernels at the training shape;
- ``decode``: the paged decode step #1 (``paged_attention_update``), the
  read-only #6 (``paged_attention``) and the (B, KV)-grid #7
  (``grid_mode="bkv"``) at the report lane's shape (B=8, H=6, KV=2,
  HD=128, P=64, MP=32, every len 1,024), bf16 and int8 pools: device time
  from the profiler and time from a CUDA graph, with each side's default
  column split;
- ``engine``: phase ``engine`` (dv-base serving 8 report prompts): the
  decode step's wall time (``decode_time_s`` over ``decode_steps``), time
  to first token and the decode kernel's launches;
- ``train``: phase ``train``.

Inputs are made alike on both sides from a seeded generator.  Every
turn's output goes to ``DIR/ab_<side><turn>.log`` (default
``artifacts/ab/``, which ``.gitignore`` lists); one JSON line per turn,
prefixed ``AB``, sums it up.  Needs CUDA; exits 2 without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_TURN = r"""
import importlib, json, sys, torch
import chip_smoke as c
parts = set(sys.argv[1].split(","))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = c.phase_device()
build = c.phase_build()
g = torch.Generator(device="cuda")
g.manual_seed(c.SEED)
bf16 = torch.bfloat16
keep = ("ms", "events_ms", "library_ms", "library_events_ms",
        "sdpa_causal_ms", "plain_ms", "max_abs_err")
summary = {"device": dev["nvidia_smi"]}
dev_ms, graph = {}, {}
sdpa = torch.nn.functional.scaled_dot_product_attention

# device time alone (the profiler's kernel sums) of the same calls on both
# sides, from inputs made here: each root's case functions may time in
# their own way
if "flash" in parts:
    from deepvision_tpu_torch.engine.kernels import flash_attention as fa
    fwd = c._flash_case("main_b4_s1024", 4, 6, 2, 1024, 128,
                        [1024, 901, 640, 300], bf16, g)
    fwd_train = c._flash_case("train_b8_s2048", 8, 6, 2, 2048, 128,
                              [2048] * 8, bf16, g, iters=10)
    summary["flash_fwd_main"] = {k: fwd.get(k) for k in keep}
    summary["flash_fwd_train"] = {k: fwd_train.get(k) for k in keep}
    for tag, B, S, lens in (("main", 4, 1024, [1024, 901, 640, 300]),
                            ("train", 8, 2048, [2048] * 8)):
        q = torch.randn(B, 6, S, 128, generator=g, device="cuda").to(bf16)
        k, v = (torch.randn(B, 2, S, 128, generator=g,
                            device="cuda").to(bf16) for _ in range(2))
        seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
        idx = torch.arange(S, device="cuda")
        mask = ((idx[None, :] <= idx[:, None])[None]
                & (idx[None, None, :] < seq.long()[:, None, None]))[:, None]
        dev_ms[f"flash_fwd_{tag}"] = c.device_ms(
            lambda: fa.flash_attention(q, k, v, seq), 10)
        dev_ms[f"flash_fwd_{tag}_sdpa"] = c.device_ms(
            lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True), 10)
if "chunk" in parts:
    from deepvision_tpu_torch.engine.kernels import paged_chunk as pc
    chunk = c._chunk_case("main_s640_n896", 1, 256, 6, 2, 128, 64, 32, [640],
                          [896], bf16, g)
    summary["paged_chunk_main"] = {k: chunk.get(k) for k in keep}
    C, MP, P = 256, 32, 64
    qc = torch.randn(1, C, 6, 128, generator=g, device="cuda").to(bf16)
    kp, vp = (torch.randn(2, MP + 1, P, 128, generator=g,
                          device="cuda").to(bf16) for _ in range(2))
    bt = (1 + torch.randperm(MP, generator=g, device="cuda")).reshape(
        1, MP).to(torch.int32)
    bt[0, -(-896 // P):] = 0
    st = torch.tensor([640], dtype=torch.int32, device="cuda")
    en = torch.tensor([896], dtype=torch.int32, device="cuda")
    dev_ms["paged_chunk_main"] = c.device_ms(
        lambda: pc.paged_chunk_attention(qc, kp, vp, bt, st, en), 20)
if "decode" in parts:
    pa = importlib.import_module(
        "deepvision_tpu_torch.engine.kernels.paged_attention")
    from deepvision_tpu_torch.engine.kv_cache import quantize_rows
    B, H, KV, HD, P, MP = 8, 6, 2, 128, 64, 32
    for pool in (bf16, torch.int8):
        tag = "bf16" if pool == bf16 else "int8"
        q = torch.randn(B, H, HD, generator=g, device="cuda").to(bf16)
        nk, nv = (torch.randn(B, KV, HD, generator=g, device="cuda").to(bf16)
                  for _ in range(2))
        kf, vf = (torch.randn(KV, B * MP + 1, P, HD, generator=g,
                              device="cuda") for _ in range(2))
        ks = vs = None
        if pool == torch.int8:
            ks = vs = torch.full((KV,), 3.0 / 127, device="cuda")
            kp, vp = quantize_rows(kf, ks, 0), quantize_rows(vf, vs, 0)
        else:
            kp, vp = kf.to(pool), vf.to(pool)
        bt = (1 + torch.randperm(B * MP, generator=g, device="cuda")
              ).reshape(B, MP).to(torch.int32)
        bt[:, 1024 // P:] = 0
        seq = torch.full((B,), 1024, dtype=torch.int32, device="cuda")
        calls = {
            "decode": lambda: pa.paged_attention_update(
                q, nk, nv, kp, vp, bt, seq, k_scale=ks, v_scale=vs),
            "paged": lambda: pa.paged_attention(
                q, kp, vp, bt, seq, k_scale=ks, v_scale=vs),
            "bkv": lambda: pa.paged_attention_update(
                q, nk, nv, kp, vp, bt, seq, k_scale=ks, v_scale=vs,
                grid_mode="bkv"),
        }
        for name, fn in calls.items():
            dev_ms[f"{name}_{tag}"] = c.device_ms(fn, 50)
            graph[f"{name}_{tag}"] = c.graph_ms(fn, 50)
if "bwd" in parts:
    bwd = c._bwd_case("train_b8_s2048", 8, 6, 2, 2048, 128, [2048] * 8,
                      bf16, g, iters=5)
    summary["flash_bwd_dq"] = {k: bwd["flash_bwd_dq"].get(k) for k in keep}
    summary["flash_bwd_dkv"] = {k: bwd["flash_bwd_dkv"].get(k) for k in keep}
    sass = build.get("attention_sass_mma", build.get("flash_bwd_sass_mma"))
    summary["flash_bwd_hmma"] = ({n: v for n, v in (sass or {}).items()
                                  if n.startswith("flash_bwd")}
                                 if isinstance(sass, dict) else sass)
summary["device_ms"] = dev_ms
summary["graph_ms"] = graph
if "engine" in parts:
    eng = c.phase_engine()
    summary["engine"] = {
        "decode_step_ms": 1e3 * eng["decode_time_s"] / eng["decode_steps"],
        **{k: eng[k] for k in ("decode_time_s", "decode_steps",
                               "ttft_ms_p50", "decode_tokens_per_s",
                               "launches")}}
if "train" in parts:
    train = c.phase_train()
    summary["train"] = {k: train[k] for k in ("ms_per_step", "tokens_per_s",
                                              "peak_mem_gb", "losses")}
    summary["train_parity_b2"] = {k: train["parity_b2"][k]
                                  for k in ("loss_rel", "grad_rel_max")}
    summary["train_device_ms"] = train["profile_one_step"]["device_ms"]
    summary["train_groups_ms"] = train["profile_one_step"]["groups_ms"]
print("AB " + json.dumps(summary), flush=True)
"""

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--out", default=os.path.join("artifacts", "ab"))
    ap.add_argument("--parts", default="flash,chunk,bwd,decode,engine,train",
                    help="comma-separated: flash, chunk, bwd, decode, "
                         "engine, train")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    turns = [("parent", args.parent, 1), ("change", args.change, 1),
             ("change", args.change, 2), ("parent", args.parent, 2)]
    rc = 0
    for side, root, n in turns:
        root = os.path.abspath(root)
        log = os.path.join(args.out, f"ab_{side}{n}.log")
        env = dict(os.environ, PYTHONPATH=root)
        with open(log, "w") as fh:
            proc = subprocess.run([sys.executable, "-c", _TURN, args.parts],
                                  cwd=root,
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            fh.write(proc.stdout)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        summary = json.loads(lines[-1][3:]) if lines else None
        print(json.dumps({"side": side, "turn": n, "rc": proc.returncode,
                          "log": log, "summary": summary}), flush=True)
        if proc.returncode:
            print(proc.stdout[-3000:], file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
