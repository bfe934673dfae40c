"""Generation-quality scorer: content metrics over N sampled generations
per checkpoint.

Counterpart of the JAX package's ``scripts/eval_generation_quality.py``
on the PyTorch port, with the same flags, scores, output lines and exit
codes.  The engines run on a CUDA device unless ``--device cpu`` is
passed; without CUDA they raise.

Round-3 pinned draft LENGTH and grammar-parse; this scores CONTENT
(VERDICT r3 weak #9): schema-validity %, section completeness, needs
count distribution, refs-resolve rate, mermaid validity for the report
lane; A.2 contract validity, option arity, dedup rate for the question
lanes.  Prompts render through the app's own builders with varied TOPIC
fields (never suffixes — out-of-distribution shapes collapse from-scratch
checkpoints; round-3 lesson), sampled at the serving defaults (T=0.7,
top_k=40).

Reference quality gate: web/server.py:25086-25312 (profile thresholds
over measured draft metrics) — here applied to the MODEL, not one draft.

Usage:
  python -m deepvision_tpu_torch.eval_generation_quality --n 50 \
      --models dv-fast:question,dv-base:report --out eval.json
  python -m deepvision_tpu_torch.eval_generation_quality --gate eval.json \
      --min-schema-valid 90                      # CI gate over artifact
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOPICS = [
    "连锁药店会员运营平台", "跨境物流关务协同系统", "高校实验室设备共享平台",
    "餐饮中央厨房排产系统", "保险代理人展业工具", "城市燃气巡检数字化",
    "汽车4S店售后工单系统", "母婴电商私域增长工具", "律所知识管理平台",
    "光伏电站运维监控中心", "连锁健身房约课系统", "外贸企业询盘管理",
    "医院后勤报修平台", "景区票务与分时预约", "制造业供应商协同门户",
    "银行对公开户流程优化", "物业缴费与服务小程序", "生鲜前置仓补货系统",
    "教培机构续费预警平台", "港口集装箱调度系统", "美业连锁门店收银系统",
    "农机作业调度平台", "二手房带看管理工具", "会展主办方招商系统",
    "宠物殡葬服务预约平台",
]

DIMS = [
    {"name": "客户需求", "key_aspects": ["核心痛点", "期望价值", "使用场景"]},
    {"name": "业务流程", "key_aspects": ["关键环节", "断点", "协同方式"]},
    {"name": "技术约束", "key_aspects": ["现有系统", "集成要求", "安全合规"]},
    {"name": "项目约束", "key_aspects": ["预算", "时间窗口", "干系人"]},
]

A2_REQUIRED = ("question", "options", "multi_select", "answer_mode",
               "requires_rationale", "evidence_intent")
DRAFT_KEYS = ("overview", "needs", "analysis", "visualizations",
              "solutions", "risks", "actions", "open_questions",
              "evidence_index")


def question_prompts(n):
    from deepvision_tpu_torch.web.runtime.interview import build_interview_prompt

    out = []
    for i in range(n):
        topic = TOPICS[i % len(TOPICS)]
        dim = DIMS[i % len(DIMS)]
        session = {
            "topic": topic, "description": "", "summary": "",
            "interview_log": [
                {"question": "当前流程的主要痛点是什么？",
                 "answer": "跨部门协作效率低，数据分散，报表手工汇总耗时。"}
            ] * (i % 4),
            "reference_materials": [],
        }
        out.append(build_interview_prompt(session, dim))
    return out


def report_prompts(n):
    from deepvision_tpu_torch.web.runtime import prompt_formats

    out = []
    for i in range(n):
        topic = TOPICS[i % len(TOPICS)]
        n_q = 5 + (i % 4)
        facts = [
            (f"Q{k}", f"{DIMS[k % 4]['name']}的现状与期望是什么？",
             "存在流程断点与数据口径不一致，期望自动化并统一底座，"
             "预算与时间窗口受限。")
            for k in range(1, n_q + 1)
        ]
        out.append((prompt_formats.report_draft_prompt(topic, facts),
                    [f"Q{k}" for k in range(1, n_q + 1)]))
    return out


def generate_all(engine, prompts, max_tokens, threads=8):
    outs = [None] * len(prompts)
    lock = threading.Lock()
    idx = {"i": 0}

    def worker():
        while True:
            with lock:
                i = idx["i"]
                if i >= len(prompts):
                    return
                idx["i"] += 1
            text, meta = engine.generate_text(
                prompts[i], max_tokens=max_tokens, temperature=0.7,
                top_k=40, json_mode=True, timeout=900)
            outs[i] = {"text": text, "tokens": meta["completion_tokens"]}

    ts = [threading.Thread(target=worker) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return outs


def pct(k, n):
    return round(100.0 * k / n, 1) if n else 0.0


def _question_text(o):
    try:
        return str(json.loads(o["text"]).get("question", "")).strip()
    except (json.JSONDecodeError, AttributeError, TypeError):
        return ""


def score_questions(outs):
    n = len(outs)
    parsed = valid = arity = dedup_pool = 0
    seen = set()
    for o in outs:
        try:
            d = json.loads(o["text"])
        except json.JSONDecodeError:
            continue
        parsed += 1
        if all(k in d for k in A2_REQUIRED) and \
                d.get("answer_mode") in ("pick_only", "pick_with_reason") \
                and d.get("evidence_intent") in ("low", "medium", "high") \
                and isinstance(d.get("question"), str) \
                and len(d["question"]) <= 240:
            valid += 1
        opts = d.get("options") or []
        if 2 <= len(opts) <= 6:
            arity += 1
        q = str(d.get("question", "")).strip()
        if q:
            dedup_pool += 1
            seen.add(q)
    return {
        "n": n,
        "json_parse_pct": pct(parsed, n),
        "schema_valid_pct": pct(valid, n),
        "option_arity_pct": pct(arity, n),
        "distinct_question_pct": pct(len(seen), dedup_pool),
        "tokens_p50": sorted(o["tokens"] for o in outs)[n // 2],
    }


def score_reports(outs, q_ids_list):
    from deepvision_tpu_torch.web.runtime.report_v3 import _mermaid_ok

    n = len(outs)
    parsed = valid = complete = refs_total = refs_ok = 0
    mermaid_total = mermaid_ok_n = 0
    needs_counts = []
    for o, q_ids in zip(outs, q_ids_list):
        try:
            d = json.loads(o["text"])
        except json.JSONDecodeError:
            continue
        parsed += 1
        if all(k in d for k in DRAFT_KEYS):
            valid += 1
        nonempty = sum(1 for k in DRAFT_KEYS if d.get(k))
        if nonempty == len(DRAFT_KEYS):
            complete += 1
        needs = d.get("needs") or []
        needs_counts.append(len(needs))
        qset = set(q_ids)
        for sec in ("needs", "solutions", "risks", "actions"):
            for item in d.get(sec) or []:
                for ref in (item.get("refs") or []
                            if isinstance(item, dict) else []):
                    refs_total += 1
                    refs_ok += ref in qset
        vis = d.get("visualizations") or {}
        for key, block in vis.items():
            if isinstance(block, str) and block:
                mermaid_total += 1
                mermaid_ok_n += bool(_mermaid_ok(block))
    needs_counts.sort()
    return {
        "n": n,
        "json_parse_pct": pct(parsed, n),
        "schema_valid_pct": pct(valid, n),
        "section_complete_pct": pct(complete, n),
        "refs_resolve_pct": pct(refs_ok, refs_total),
        "refs_checked": refs_total,
        "mermaid_valid_pct": pct(mermaid_ok_n, mermaid_total),
        "needs_count_p50": needs_counts[len(needs_counts) // 2]
        if needs_counts else 0,
        "needs_count_min": needs_counts[0] if needs_counts else 0,
        "needs_count_max": needs_counts[-1] if needs_counts else 0,
        "tokens_p50": sorted(o["tokens"] for o in outs)[n // 2],
    }


def run_model(model, lane, n, max_tokens, kv_quantize="",
              device="cuda"):
    from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

    ckpt = os.path.join(ROOT, "resources", "checkpoints", f"{model}.npz")
    tok = os.path.join(ROOT, "resources", "tokenizer",
                       "dv_bpe_8k.json" if model == "dv-mini"
                       else "dv_bpe_16k.json")
    eng = LLMEngine(EngineConfig(
        model=model, tokenizer=tok, checkpoint_dir=ckpt,
        max_slots=8, num_pages=2048, page_size=64, max_pages_per_seq=32,
        decode_steps_per_call=16, chunked_prefill=True, warmup=True,
        kv_quantize=kv_quantize, device=device,
    ))
    eng.start()
    try:
        if lane == "question":
            prompts = question_prompts(n)
            outs = generate_all(eng, prompts, max_tokens)
            scores = score_questions(outs)
            # dedupe-aware pass: serving resamples a draw that collides
            # with an already-asked question (interview.py dedupe gate,
            # reference web/server.py:20059) — replay that policy over
            # the pool (one bounded resample per colliding draw) and
            # report what the PRODUCT would actually serve
            seen, dup_idx = set(), []
            for i, o in enumerate(outs):
                q = _question_text(o)
                if q and q in seen:
                    dup_idx.append(i)
                seen.add(q)
            if dup_idx:
                redraws = generate_all(
                    eng, [prompts[i] for i in dup_idx], max_tokens)
                for i, o in zip(dup_idx, redraws):
                    if _question_text(o) not in seen:
                        outs[i] = o
                        seen.add(_question_text(o))
            served = score_questions(outs)
            scores["distinct_question_pct_served"] = served[
                "distinct_question_pct"]
            scores["dedupe_resamples"] = len(dup_idx)
            return {"lane": lane, **scores}
        prompts = report_prompts(n)
        outs = generate_all(eng, [p for p, _ in prompts], max_tokens)
        return {"lane": lane,
                **score_reports(outs, [q for _, q in prompts])}
    finally:
        eng.shutdown()


def gate(path, min_schema_valid):
    if not os.path.isfile(path):
        print(f"GATE SKIP: no artifact at {path} (generate with --out)")
        return 0
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    bad = []
    for model, m in data.items():
        if not isinstance(m, dict) or "schema_valid_pct" not in m:
            continue
        if m["schema_valid_pct"] < min_schema_valid:
            bad.append((model, m["schema_valid_pct"]))
    for model, v in bad:
        print(f"GATE FAIL {model}: schema_valid {v}% < {min_schema_valid}%")
    if not bad:
        print(f"GATE OK: all lanes >= {min_schema_valid}% schema-valid")
    return 1 if bad else 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--out", default="")
    ap.add_argument("--models", default="dv-fast:question,dv-base:report,"
                                        "dv-mini:question")
    ap.add_argument("--max-question-tokens", type=int, default=220)
    ap.add_argument("--max-report-tokens", type=int, default=1500)
    ap.add_argument("--kv-quantize", default="",
                    help="run the engines with int8 KV pages (quality A/B)")
    ap.add_argument("--gate", default="",
                    help="score an existing artifact instead of generating")
    ap.add_argument("--min-schema-valid", type=float, default=90.0)
    ap.add_argument("--device", default="cuda",
                    help="device of the engines (cuda or cpu)")
    args = ap.parse_args(argv)

    if args.gate:
        return gate(args.gate, args.min_schema_valid)

    results = {"n_per_model": args.n, "sampling": "T=0.7 top_k=40"}
    for spec in args.models.split(","):
        model, lane = spec.split(":")
        ckpt = os.path.join(ROOT, "resources", "checkpoints", f"{model}.npz")
        if not os.path.isfile(ckpt):
            results[model] = {"error": "no checkpoint"}
            continue
        max_tokens = (args.max_report_tokens if lane == "report"
                      else args.max_question_tokens)
        print(f"[eval] {model} ({lane}) x {args.n} ...", flush=True)
        results[model] = run_model(model, lane, args.n, max_tokens,
                                   kv_quantize=args.kv_quantize,
                                   device=args.device)
        print(json.dumps({model: results[model]}, ensure_ascii=False),
              flush=True)
    out = json.dumps(results, ensure_ascii=False, indent=1)
    print(out)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(out + "\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
