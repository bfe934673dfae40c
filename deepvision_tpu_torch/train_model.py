"""Train a dv model preset with the PyTorch port.

Counterpart of the JAX package's ``scripts/train_model.py``, with the same
flags and defaults: corpus (``scripts/build_corpus.py``) -> tokens (the
port's plain-Python BPE) -> ``Trainer`` steps (the flash forward and
backward kernels unless ``--dense-attn``) -> an ``.npz`` checkpoint that
the port's engine and the JAX package both load.  Periodic saves
(``--save-every``), a held-out validation loss (``--val-frac``),
``--resume`` from a saved ``.npz`` and ``--early-stop`` behave as there.
It runs on a CUDA device unless ``--device cpu`` is passed; pipeline
parallelism (``--pp > 1``) comes with the multi-device slice.

Usage:
  python -m deepvision_tpu_torch.train_model --model dv-base \
      --corpus data/corpus/dv_corpus.txt \
      --tokenizer resources/tokenizer/dv_bpe_16k.json \
      --steps 20000 --batch 8 --seq 2048 \
      --out resources/checkpoints/dv-base.npz
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np
import torch

SAMPLE_PROMPT = (
    "你是一名资深需求访谈顾问，正在进行结构化访谈。\n\n"
    "访谈主题：电商平台会员体系升级\n\n"
    "当前维度：目标价值（关注要点：核心目标、期望价值）\n\n"
    "请生成下一个访谈问题，输出 JSON："
)


def load_tokens(corpus_path: str, tokenizer_path: str):
    """The corpus as one id stream: documents split on ``<|eot|>``, each
    encoded and followed by the tokenizer's end-of-turn id."""
    from deepvision_tpu_torch.engine.tokenizer import get_tokenizer

    tok = get_tokenizer(tokenizer_path)
    with open(corpus_path, encoding="utf-8") as fh:
        text = fh.read()
    ids = []
    for doc in text.split("<|eot|>"):
        if doc.strip():
            ids.extend(tok.encode(doc))
            ids.append(tok.eos_id)
    return np.asarray(ids, dtype=np.int32), tok


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="dv-base")
    ap.add_argument("--corpus", default="data/corpus/dv_corpus.txt")
    ap.add_argument("--tokenizer",
                    default="resources/tokenizer/dv_bpe_16k.json")
    ap.add_argument("--out", default="resources/checkpoints/dv-base.npz")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--save-every", type=int, default=2000,
                    help="write the checkpoint every N steps (0 = only at end)")
    ap.add_argument("--val-frac", type=float, default=0.005,
                    help="tail fraction of the corpus held out for val loss")
    ap.add_argument("--resume", default="",
                    help="npz checkpoint to initialize from")
    ap.add_argument("--early-stop", type=int, default=0,
                    help="stop after N consecutive val evals without "
                         "improvement (0 = run all steps)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel stages (not ported: > 1 raises)")
    ap.add_argument("--pp-micro", type=int, default=4,
                    help="microbatches per PP step (with --pp)")
    ap.add_argument("--dense-attn", action="store_true",
                    help="plain attention through autograd instead of the "
                         "flash kernels")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.pp > 1:
        raise NotImplementedError(
            "--pp > 1: pipeline-parallel training comes with the "
            "multi-device slice")

    from deepvision_tpu_torch.engine import model as model_lib
    from deepvision_tpu_torch.engine.config import get_model_config
    from deepvision_tpu_torch.engine.training import (
        Trainer,
        cross_entropy_loss,
        train_model_chain,
    )
    from deepvision_tpu_torch.engine.weights import (
        astype,
        count_params,
        load_npz,
        save_npz,
    )

    t0 = time.time()
    tokens, tok = load_tokens(args.corpus, args.tokenizer)
    print(f"corpus: {len(tokens)/1e6:.1f}M tokens "
          f"(tokenized in {time.time()-t0:.1f}s)", flush=True)

    cfg = get_model_config(args.model)
    if tok.vocab_size > cfg.vocab_size:
        raise ValueError(f"tokenizer vocab {tok.vocab_size} exceeds "
                         f"{args.model}'s {cfg.vocab_size}")
    if args.seq > cfg.max_seq_len:
        raise ValueError(f"--seq {args.seq} exceeds {args.model}'s window "
                         f"{cfg.max_seq_len}")

    n_val = max(args.seq + 2, int(len(tokens) * args.val_frac))
    train_tokens, val_tokens = tokens[:-n_val], tokens[-n_val:]

    warmup = min(args.warmup, max(1, args.steps // 10))
    tx = train_model_chain(args.lr, warmup, max(args.steps, warmup + 1))
    use_kernel = not args.dense_attn
    init = None
    if args.resume:
        init = load_npz(args.resume, device="cpu")
        print(f"resumed params from {args.resume}", flush=True)
    trainer = Trainer(cfg, tx=tx, seed=args.seed,
                      param_dtype=torch.float32, use_kernel=use_kernel,
                      init=init, device=args.device)
    print(f"{args.model}: {count_params(trainer.params)/1e6:.1f}M params, "
          f"device={trainer.device}, "
          f"attn={'flash' if use_kernel else 'dense'}", flush=True)

    @torch.no_grad()
    def eval_step(batch):
        batch = trainer.place_batch(batch)
        logits = model_lib.forward_train(trainer.params, batch[:, :-1],
                                         cfg=cfg, use_kernel=use_kernel)
        return cross_entropy_loss(logits, batch[:, 1:])

    def val_loss(n_batches=8):
        rng_v = np.random.RandomState(1234)
        row = args.seq + 1
        hi = len(val_tokens) - row - 1
        if hi <= 0:
            return float("nan")
        losses = []
        for _ in range(n_batches):
            starts = rng_v.randint(0, hi, size=args.batch)
            batch = np.stack([val_tokens[s:s + row] for s in starts])
            losses.append(float(eval_step(batch)))
        return float(np.mean(losses))

    def save(path):
        tmp = path + ".tmp"
        save_npz(tmp, astype(trainer.params, torch.bfloat16))
        os.replace(tmp, path)

    # fixed-shape batches; contiguous chunks sampled at random offsets
    rng = np.random.RandomState(args.seed)
    row = args.seq + 1
    max_start = len(train_tokens) - row - 1
    best_val, stale = float("inf"), 0
    best_path = args.out + ".best"
    losses = []
    t_start = time.time()
    for step in range(1, args.steps + 1):
        starts = rng.randint(0, max_start, size=args.batch)
        batch = np.stack([train_tokens[s:s + row] for s in starts])
        losses.append(trainer.train_step_async(batch))
        if step % args.log_every == 0 or step == args.steps:
            dt = time.time() - t_start
            recent = [float(x) for x in losses[-args.log_every:]]
            print(f"step {step}/{args.steps} "
                  f"loss={np.mean(recent):.4f} "
                  f"({dt/step*1e3:.0f} ms/step, "
                  f"{args.batch*args.seq*step/dt/1e3:.0f} ktok/s)",
                  flush=True)
        if args.save_every and step % args.save_every == 0:
            save(args.out)
            vl = val_loss()
            if vl < best_val:
                best_val, stale = vl, 0
                shutil.copyfile(args.out, best_path)
                tag = " [best]"
            else:
                stale += 1
                tag = f" (best {best_val:.4f}, stale {stale})"
            print(f"step {step}: val_loss={vl:.4f}{tag} "
                  f"(checkpoint -> {args.out})", flush=True)
            if args.early_stop and stale >= args.early_stop:
                print(f"early stop at step {step}: no val improvement in "
                      f"{stale} evals", flush=True)
                break

    save(args.out)
    size = os.path.getsize(args.out) / 1e6
    print(f"saved {args.out} ({size:.1f} MB), "
          f"final val_loss={val_loss():.4f}; "
          f"best val_loss={best_val:.4f} -> {best_path}", flush=True)

    # quick greedy sample through the port's engine as a sanity check —
    # never let it tank a finished training run (the checkpoint is already
    # on disk at this point)
    try:
        from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

        eng = LLMEngine(EngineConfig(
            model=args.model, tokenizer=args.tokenizer,
            checkpoint_dir=args.out, device=args.device,
            max_slots=2, num_pages=256, page_size=64, max_pages_per_seq=32,
        ))
        text, _ = eng.generate_text(SAMPLE_PROMPT, max_tokens=120,
                                    temperature=0.0, timeout=600)
        print("--- sample ---")
        print(text[:500])
        eng.shutdown()
    except Exception as e:  # noqa: BLE001
        print(f"[sample skipped: {type(e).__name__}: {e}]")


if __name__ == "__main__":
    main()
