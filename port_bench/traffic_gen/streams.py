"""Seeded request streams of the serving mixes and the batch pool of the
training mix, from a traffic file's parameters.

Every client of a serving mix draws from a stream of its own, seeded from
``(seed, client)``.  The sizes (output lengths, facts, reference text,
turns) cycle through a fixed grid whose order the seed shuffles, so every
seed asks for the same set of sizes in another order; the seed changes the
text.  Prompts are rendered through the frozen builders in ``prompts.py``.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Iterator, List, Optional

from port_bench.traffic_gen import prompts

GRID = 16


@dataclasses.dataclass
class Request:
    client: int
    index: int
    prompt: List[int]
    max_tokens: int
    json_mode: bool
    prefix_key: Optional[str]


def _grid(lo: float, hi: float, dist: str = "uniform") -> list:
    """GRID values from ``lo`` to ``hi`` (integers), evenly or evenly in
    log."""
    out = []
    for i in range(GRID):
        f = i / (GRID - 1)
        v = (math.exp(math.log(lo) + f * (math.log(hi) - math.log(lo)))
             if dist == "log" else lo + f * (hi - lo))
        out.append(int(round(v)))
    return out


class _Cycle:
    """A grid in a seeded order, cycled."""

    def __init__(self, values, rng: random.Random):
        self.values = list(values)
        rng.shuffle(self.values)
        self.i = 0

    def next(self):
        v = self.values[self.i % len(self.values)]
        self.i += 1
        return v


def _client_rng(seed: int, client: int, salt: str) -> random.Random:
    return random.Random(f"{seed}:{client}:{salt}")


def _qa(rng: random.Random, dim: dict) -> dict:
    aspects = rng.sample(dim["key_aspects"],
                         rng.randint(1, len(dim["key_aspects"])))
    q = f"关于{aspects[0]}，请具体说明{dim['description']}的现状？"
    a = (f"关于{'、'.join(aspects)}，目前第{rng.randint(1, 30)}轮访谈确认："
         + "，".join(f"{x}方面存在{rng.choice(['流程', '数据', '协作', '成本'])}"
                     f"问题" for x in aspects) + "，期望统一改进。")
    return {"question": q, "answer": a}


def _reference_text(rng: random.Random, sc: dict, chars: int) -> str:
    pieces = []
    while sum(len(p) for p in pieces) < chars:
        d = rng.choice(sc["dimensions"])
        pieces.append(f"{d['name']}：{d['description']}；"
                      f"{'、'.join(d['key_aspects'])}。")
    return "".join(pieces)[:chars]


def interview_stream(mix: dict, seed: int, client: int,
                     tokenizer) -> Iterator[Request]:
    """Interview sessions: each takes ``turns`` turns under one
    ``prefix_key`` (the dimension fixed, the log growing by one Q/A a
    turn), then a new topic begins."""
    rng = _client_rng(seed, client, "interview")
    scs = prompts.scenarios()
    turns = _Cycle(range(mix["turns"][0], mix["turns"][1] + 1), rng)
    history = _Cycle(range(mix["history_turns"][0],
                           mix["history_turns"][1] + 1), rng)
    ref = _Cycle(_grid(*mix["reference_chars"]), rng)
    out_len = _Cycle(_grid(*mix["max_tokens"], mix["max_tokens_dist"]), rng)
    json_flags = _Cycle([i < round(mix["json_share"] * GRID)
                         for i in range(GRID)], rng)
    index, session = 0, 0
    while True:
        sc = rng.choice(scs)
        dim = rng.choice(sc["dimensions"])
        key = f"s{client}-{session}"
        chars = ref.next()
        state = {
            "topic": f"{sc['name']}（客户{rng.randint(1, 999)}）",
            "description": sc["description"],
            "summary": "",
            "interview_log": [_qa(rng, dim) for _ in range(history.next())],
            "reference_materials": ([{"name": "需求说明",
                                      "content": _reference_text(rng, sc,
                                                                 chars)}]
                                    if chars else []),
        }
        for _ in range(turns.next()):
            text = prompts.build_interview_prompt(state, dim)
            yield Request(client, index, tokenizer.encode(text),
                          out_len.next(), json_flags.next(), key)
            index += 1
            state["interview_log"].append(_qa(rng, dim))
        session += 1


def report_stream(mix: dict, seed: int, client: int,
                  tokenizer) -> Iterator[Request]:
    """Report drafts with no prefix key: ``facts`` Q/A facts of one
    scenario; the output length is cut so that the prompt, the output and
    one decode call fit the context."""
    rng = _client_rng(seed, client, "report")
    scs = prompts.scenarios()
    facts = _Cycle(_grid(*mix["facts"]), rng)
    out_len = _Cycle(_grid(*mix["max_tokens"], mix["max_tokens_dist"]), rng)
    json_flags = _Cycle([i < round(mix["json_share"] * GRID)
                         for i in range(GRID)], rng)
    room = mix["max_context"] - mix["engine"]["decode_steps_per_call"]
    index = 0
    while True:
        sc = rng.choice(scs)
        rows = []
        for k in range(facts.next()):
            qa = _qa(rng, rng.choice(sc["dimensions"]))
            rows.append((f"Q{k + 1}", qa["question"], qa["answer"]))
        text = prompts.report_draft_prompt(
            f"{sc['name']}（客户{rng.randint(1, 999)}）", rows,
            description=sc["description"])
        ids = tokenizer.encode(text)
        yield Request(client, index, ids, min(out_len.next(),
                                              room - len(ids)),
                      json_flags.next(), None)
        index += 1


STREAMS = {"interview": interview_stream, "report": report_stream}


def train_pool(mix: dict, seed: int, tokenizer) -> list:
    """``pool`` batches of ``batch`` rows of ``seq + 1`` tokens, all rows
    different (consecutive pieces of one seeded transcript stream)."""
    B, S, n = mix["batch"], mix["seq"], mix["pool"]
    rows = prompts.train_batch(tokenizer, B * n, S + 1, seed)
    return [rows[i * B:(i + 1) * B] for i in range(n)]
