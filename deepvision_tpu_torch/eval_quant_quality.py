"""A/B quality eval: dv-base int8 weight-only quantization vs bf16.

Counterpart of the JAX package's ``scripts/eval_quant_quality.py`` on the
PyTorch port, with the same flags and output line.  The engines run on a
CUDA device unless ``--device cpu`` is passed; without CUDA they raise.

Decides whether ``ENGINE_QUANTIZE=int8`` is safe for the TRAINED serving
lanes: for them int8 must merely not hurt.  Greedy decoding on prompts
rendered through the app's own builders (bench.py round-3 lesson:
handwritten prompt variants are out-of-distribution for the from-scratch
checkpoints), one engine at a time.

Usage:
  python -m deepvision_tpu_torch.eval_quant_quality [--model dv-base] \
      [--n 4]
Prints one JSON line: token agreement, draft-length and JSON-validity
deltas.  Meant for the card: on the CPU, full-length drafts of a trained
model take a long time.
"""

from __future__ import annotations

import argparse
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def report_prompt(i: int, n_facts: int = 8) -> str:
    """The report-draft prompt of ``bench.py``'s report lane, rendered by
    the port's ``prompt_formats``."""
    from deepvision_tpu_torch.web.runtime import prompt_formats

    facts = [
        (f"Q{k}", f"关于维度{k}的现状与期望？",
         "存在流程断点，期望自动化，预算与时间窗口受限。")
        for k in range(1, 1 + n_facts)
    ]
    return prompt_formats.report_draft_prompt(
        f"企业客户关系管理系统（事业部{i}）", facts)


def build_prompts(n: int):
    return [report_prompt(i) for i in range(n)]


def run_lane(model: str, quantize: str, prompts, max_tokens: int,
             device: str = "cuda"):
    from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

    ckpt = os.path.join(ROOT, "resources", "checkpoints", f"{model}.npz")
    tok = os.path.join(ROOT, "resources", "tokenizer",
                       "dv_bpe_16k.json" if model != "dv-mini"
                       else "dv_bpe_8k.json")
    eng = LLMEngine(EngineConfig(
        model=model, tokenizer=tok, checkpoint_dir=ckpt,
        max_slots=4, num_pages=1024, page_size=64, max_pages_per_seq=32,
        decode_steps_per_call=16, chunked_prefill=True,
        quantize=quantize, warmup=False, device=device,
    ))
    eng.start()
    outs = []
    for p in prompts:
        text, meta = eng.generate_text(
            p, max_tokens=max_tokens, temperature=0.0, json_mode=True,
            timeout=900)
        outs.append({"text": text, "tokens": meta["completion_tokens"]})
    eng.shutdown()
    return outs


def json_ok(s: str) -> bool:
    try:
        json.loads(s)
        return True
    except Exception:  # noqa: BLE001
        return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="dv-base")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=1200)
    ap.add_argument("--device", default="cuda",
                    help="device of the engines (cuda or cpu)")
    args = ap.parse_args(argv)

    prompts = build_prompts(args.n)
    base = run_lane(args.model, "", prompts, args.max_tokens, args.device)
    q8 = run_lane(args.model, "int8", prompts, args.max_tokens, args.device)

    # char-level prefix agreement of the greedy streams: weight rounding
    # shifts logits, so streams may diverge at some position — what
    # matters is that int8 output stays long, valid JSON of similar shape
    agrees = []
    for a, b in zip(base, q8):
        n = min(len(a["text"]), len(b["text"]))
        same = next(
            (i for i in range(n) if a["text"][i] != b["text"][i]), n)
        agrees.append(same / max(n, 1))
    print(json.dumps({
        "model": args.model,
        "n_prompts": args.n,
        "bf16_tokens": [o["tokens"] for o in base],
        "int8_tokens": [o["tokens"] for o in q8],
        "bf16_json_ok": sum(json_ok(o["text"]) for o in base),
        "int8_json_ok": sum(json_ok(o["text"]) for o in q8),
        "greedy_prefix_agreement": [round(a, 3) for a in agrees],
    }, ensure_ascii=False))


if __name__ == "__main__":
    main()
