"""The frozen copies of the traffic's builders equal the program's as they
stand: the app's two prompt builders and ``chip_smoke.py``'s training
batch, over the frozen scenarios.  A later change to the app's prompts
fails this test and leaves the yardstick where it is."""

import json
import os
import random

import pytest

from port_bench import harness
from port_bench.traffic_gen import prompts

REPO = os.path.dirname(harness.BENCH_DIR)
TOKENIZER = os.path.join(REPO, "resources", "tokenizer", "dv_bpe_16k.json")


def _session(seed):
    rng = random.Random(seed)
    sc = rng.choice(prompts.scenarios())
    dim = rng.choice(sc["dimensions"])
    log = [{"question": f"问题{i}？{dim['description']}",
            "answer": "、".join(rng.sample(dim["key_aspects"], 1)) * (i + 1)}
           for i in range(rng.randint(0, 8))]
    docs = [{"name": f"文档{i}", "content": sc["description"] * rng.randint(
        1, 200)} for i in range(rng.randint(0, 3))]
    return ({"topic": sc["name"], "description": sc["description"],
             "summary": rng.choice(["", "已确认核心痛点"]),
             "interview_log": log, "reference_materials": docs}, dim,
            dict(is_follow_up=rng.random() < 0.5,
                 follow_up_context=rng.choice(["", "补充细节"]),
                 focus_aspect=rng.choice(["", dim["key_aspects"][0]]),
                 capture_contract=rng.choice([None, {
                     "answer_mode": "pick_only", "evidence_intent": "low"}]),
                 fast_tier=rng.random() < 0.3,
                 prompt_budget=rng.choice([0, 300])))


def test_scenarios_are_the_apps():
    app = os.path.join(REPO, "resources", "scenarios", "builtin")
    assert sorted(os.listdir(app)) == sorted(os.listdir(
        prompts.SCENARIO_DIR))
    for name in os.listdir(app):
        assert json.load(open(os.path.join(app, name))) == json.load(
            open(os.path.join(prompts.SCENARIO_DIR, name)))


@pytest.mark.parametrize("seed", range(6))
def test_interview_prompt(seed):
    from deepvision_tpu_torch.web.runtime import interview

    session, dim, kw = _session(seed)
    assert prompts.build_interview_prompt(session, dim, **kw) == \
        interview.build_interview_prompt(session, dim, **kw)


@pytest.mark.parametrize("seed", range(4))
def test_report_prompt(seed):
    from deepvision_tpu_torch.web.runtime import prompt_formats

    rng = random.Random(seed)
    facts = [(f"Q{i}", f"问{i}", "答" * rng.randint(1, 30))
             for i in range(rng.randint(1, 32))]
    docs = rng.choice([None, [("需求说明", "摘要" * 5)]])
    desc = rng.choice(["", "主题说明文字"])
    assert prompts.report_draft_prompt("主题", facts, description=desc,
                                       documents=docs) == \
        prompt_formats.report_draft_prompt("主题", facts, description=desc,
                                           documents=docs)


@pytest.mark.parametrize("seed", [0, 7, 3000000019])
def test_train_batch(seed):
    import chip_smoke
    from deepvision_tpu_torch.engine.tokenizer import get_tokenizer

    tok = get_tokenizer(TOKENIZER)
    ours = prompts.train_batch(tok, 3, 257, seed)
    theirs = chip_smoke._train_batch(tok, 3, 257, seed)
    assert ours == theirs.tolist()
