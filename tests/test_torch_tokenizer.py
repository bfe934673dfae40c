"""The port's pure-Python byte-level BPE and JSON DFA against the JAX
package's (which read the same ``tokenizer.json`` through HuggingFace
``tokenizers``)."""

import glob
import os
import random

import numpy as np
import pytest

from deepvision_tpu_torch.engine.tokenizer import (
    BPETokenizer,
    ByteTokenizer,
    get_tokenizer,
    pretokenize,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK_DIR = os.path.join(ROOT, "resources", "tokenizer")
TOKENIZERS = ["dv_bpe_8k.json", "dv_bpe_16k.json"]

_ALPHABET = (
    list("abcXYZ it's 'll we've I'M 0123456789 ,.!?;:\"()[]{}<>-_/\\@#$%^&*+=~`")
    + list("\t\n\r\x0b\x0c\x85\x1c　    ")
    + [chr(c) for c in range(0x4E00, 0x4E60)]
    + list("，。！？“”、：；（）《》【】…—")
    + ["<s>", "</s>", "<pad>", "<|eot|>", "́", "é", "ß", "Ⅳ", "½", "١٢", "😀"]
)


def _texts():
    rng = random.Random(0)
    texts = []
    for path in sorted(glob.glob(os.path.join(ROOT, "resources", "scenarios",
                                              "**", "*.json"),
                                 recursive=True)):
        with open(path, encoding="utf-8") as fh:
            texts.append(fh.read())
    texts += ["", " ", "  hello  world  ", "a\n\nb", "x \ny", "don't",
              "JSON：{\"question\": \"...\"}\n", "  \t\n"]
    for _ in range(300):
        texts.append("".join(rng.choice(_ALPHABET)
                             for _ in range(rng.randint(1, 40))))
    return texts


@pytest.mark.parametrize("name", TOKENIZERS)
def test_bpe_ids_match_hf_tokenizers(name):
    """Exactly the HuggingFace ids (and decoded text) on the scenario texts
    and a few hundred random CJK/ASCII/digit/punctuation/space strings."""
    tokenizers = pytest.importorskip("tokenizers")
    path = os.path.join(TOK_DIR, name)
    hf = tokenizers.Tokenizer.from_file(path)
    mine = BPETokenizer(path)
    assert mine.vocab_size == hf.get_vocab_size()
    assert mine.special_ids == frozenset(hf.get_added_tokens_decoder())
    for text in _texts():
        want = hf.encode(text).ids
        assert mine.encode(text) == want, text
        assert mine.decode(want) == hf.decode(want), text
    for tid in range(mine.vocab_size):
        assert mine.id_to_token(tid) == hf.id_to_token(tid)


def test_bpe_eos_and_specials():
    tok = get_tokenizer(os.path.join(TOK_DIR, "dv_bpe_16k.json"))
    assert tok.id_to_token(tok.eos_id) == "<|eot|>"
    ids = tok.encode("问题<|eot|>")
    assert ids[-1] == tok.eos_id
    assert tok.decode(ids) == "问题"         # specials are skipped


def test_pretokenize_follows_the_gpt2_pattern():
    assert pretokenize("it's  a test\n\nok") == [
        "it", "'s", " ", " a", " test", "\n", "\n", "ok"]
    assert pretokenize("价格123元!!") == ["价格", "123", "元", "!!"]


def test_byte_tokenizer_round_trip():
    tok = get_tokenizer("byte")
    assert isinstance(tok, ByteTokenizer)
    text = "访谈 JSON {\"a\": 1}"
    ids = tok.encode(text)
    assert ids[0] == tok.BOS and tok.decode(ids) == text


def test_json_dfa_table_equals_jax():
    """The port's JSON DFA (built from its own tokenizer) is the JAX
    package's, state for state, on dv_bpe_8k.  (The 16k build takes about
    18 s here and stays out of the tests.)"""
    pytest.importorskip("tokenizers")
    from deepvision_tpu.engine.constrained import JsonTokenDfa as JDfa
    from deepvision_tpu.engine.tokenizer import HFTokenizer
    from deepvision_tpu_torch.engine.constrained import JsonTokenDfa

    path = os.path.join(TOK_DIR, "dv_bpe_8k.json")
    want = JDfa.build(HFTokenizer(path), root="object")
    got = JsonTokenDfa.build(BPETokenizer(path), root="object")
    assert (got.start, got.accept) == (want.start, want.accept)
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.dist, want.dist)


def test_json_dfa_cache_round_trip(tmp_path):
    from deepvision_tpu_torch.engine.constrained import JsonTokenDfa

    a = JsonTokenDfa.build(ByteTokenizer(), cache_dir=str(tmp_path))
    files = set(os.listdir(tmp_path))
    assert files
    b = JsonTokenDfa.build(ByteTokenizer(), cache_dir=str(tmp_path))
    assert set(os.listdir(tmp_path)) == files
    np.testing.assert_array_equal(a.table, b.table)
