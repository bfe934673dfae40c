"""Tensor-parallel serving with int8 KV pools and int8 weights.

Whole engine (tp=2, vocab sharded, ``kv_quantize="int8"`` and
``quantize="int8"``) against the JAX engine at the same tp and against the
JAX tp=1 serving forwards (``test_torch_parallel_engine
.check_against_jax``): the int8 weights and their scales are cut as the
JAX plan places them, the KV scales are calibrated on rank 0's raw params
and follow the kv-head shard.  The sharded forwards with int8 pools are
in ``test_torch_parallel_forwards_int8.py``."""

import pytest
import torch

from test_torch_parallel_engine import (  # noqa: F401 — fixture
    TP_CFG,
    check_against_jax,
    save_weights,
    tp_steadiness,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return save_weights(tmp_path_factory, TP_CFG, seed=2)


def test_int8_kv_and_weights_tp2_engine_matches_jax(ckpt):
    check_against_jax(TP_CFG, ckpt, 2, vocab_sharded=True,
                      kv_quantize="int8", quantize="int8")
