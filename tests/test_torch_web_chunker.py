"""The port's document chunker against the JAX app's two.

The JAX app's ``chunk_markdown`` (``deepvision_tpu/web/runtime/
documents.py``) runs the C++ ``dv_chunk_markdown`` through
``deepvision_tpu.native`` and uses its Python paragraph chunker only when
that gives no chunk.  The port carries the C++ rules in plain Python
(``chunk_markdown_bytes``).  On a seeded set of texts (CJK, mixed, no
newlines, paragraph breaks at the byte budget's edges, whitespace only,
more than 256 chunks) the port's ``chunk_markdown_bytes`` equals
``chunk_markdown_native`` and the port's ``chunk_markdown`` equals the JAX
app's, chunk for chunk.
"""

import numpy as np
import pytest

from deepvision_tpu import native
from deepvision_tpu.web.runtime.documents import (
    chunk_markdown as jax_chunk_markdown,
)
from deepvision_tpu_torch.web.runtime.documents import (
    chunk_markdown,
    chunk_markdown_bytes,
)

CJK = "仓储管理系统选型门店补货决策依赖人工经验数据分散在三套系统中盘点差异大"
ASCII = "the quick brown fox jumps over the lazy dog 0123456789"
SEPS = ["\n\n", "\n", " ", "\r\n", "\t", "\n\n\n"]


def _text(rng, kind, n):
    if kind == "cjk":
        pool = list(CJK) + ["。", "，"]
    elif kind == "ascii":
        pool = list(ASCII)
    else:
        pool = list(CJK) + list(ASCII) + ["é", "ß", "😀", "—"]
    out = []
    while len(out) < n:
        out.extend(rng.choice(pool, size=int(rng.integers(5, 200))))
        if kind != "flat":
            out.append(SEPS[int(rng.integers(len(SEPS)))])
    return "".join(out[:n])


def _cases():
    rng = np.random.default_rng(0)
    cases = []
    for kind in ("cjk", "ascii", "mixed"):
        for n in (700, 900, 2500, 6000):
            cases.append((f"{kind}_{n}", _text(rng, kind, n), 800))
    cases.append(("flat_cjk", _text(rng, "flat", 5000).replace("\n", ""), 800))
    cases.append(("flat_ascii", "x" * 9000, 800))
    cases.append(("no_newlines_mixed",
                  _text(rng, "mixed", 7000).replace("\n", " "), 300))
    # "\n\n" at, just past and just before the budget's edge and its half
    for chunk_chars in (100, 101):
        budget = 3 * chunk_chars
        for at in (budget - 2, budget - 1, budget, budget + 1,
                   budget // 2, budget // 2 + 1, budget // 2 + 2):
            text = "a" * at + "\n\n" + "b" * (2 * budget)
            cases.append((f"edge_{chunk_chars}_{at}", text, chunk_chars))
            cases.append((f"edge_nl_{chunk_chars}_{at}",
                          "c" * at + "\n" + "d" * (2 * budget), chunk_chars))
    # a multi-byte character straddling the budget
    cases.append(("utf8_edge", "a" + "中" * 400, 100))
    cases.append(("whitespace_only", " \n\t\r" * 600, 800))
    cases.append(("leading_whitespace", "\n\n  " + CJK * 60, 200))
    cases.append(("over_256_chunks", _text(rng, "mixed", 40000), 40))
    cases.append(("over_256_flat", "y" * 100000, 100))
    return cases


CASES = _cases()


def test_the_jax_app_runs_the_native_chunker():
    assert native.native_available()


@pytest.mark.parametrize("name,text,chunk_chars", CASES,
                         ids=[c[0] for c in CASES])
def test_chunker_equals_the_jax_app(name, text, chunk_chars):
    want = native.chunk_markdown_native(text, chunk_chars)
    assert chunk_markdown_bytes(text, chunk_chars) == want
    assert (chunk_markdown(text, chunk_chars=chunk_chars)
            == jax_chunk_markdown(text, chunk_chars=chunk_chars))
    if name.startswith("over_256"):
        assert len(want) == 256
    if name == "whitespace_only":
        # no native chunk: both apps fall to the paragraph chunker
        assert want == [] and chunk_markdown(text) != []
