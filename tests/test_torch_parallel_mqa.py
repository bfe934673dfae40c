"""Tensor-parallel serving of an MQA geometry (one kv head, replicated on
every rank; H=8 cut to 4 query heads a rank at tp=2), whole engine, against
the JAX engine at the same tp: the golden window, a JSON-mode call and
teacher-forced logits (``test_torch_parallel_engine.check_against_jax``).
Its chunked prefill, prefix resume and pipelined decode under TP are in
``test_torch_parallel_gateway.py``."""

import dataclasses

import pytest
import torch

from test_torch_parallel_engine import (  # noqa: F401 — fixture
    TP_CFG,
    check_against_jax,
    save_weights,
    tp_steadiness,
)

torch.set_num_threads(2)

MQA_CFG = dataclasses.replace(TP_CFG, name="t-mqa", n_kv_heads=1)


@pytest.fixture(scope="module")
def mqa_ckpt(tmp_path_factory):
    return save_weights(tmp_path_factory, MQA_CFG, seed=1)


def test_mqa_tp2_engine_matches_jax(mqa_ckpt):
    check_against_jax(MQA_CFG, mqa_ckpt, 2, json_mode_tokens=32)
