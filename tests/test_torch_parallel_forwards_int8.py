"""The sharded serving forwards with int8 pools (static per-kv-head scales
cut with the kv heads) at tp 2 and 4, H8/KV4 and MQA, against the JAX
unsharded forwards: ``test_torch_parallel_forwards.check_forwards``."""

import pytest
import torch

from test_torch_parallel_forwards import MQA_CFG, TP_CFG, check_forwards

torch.set_num_threads(1)


@pytest.mark.parametrize("cfg", [TP_CFG, MQA_CFG], ids=lambda c: c.name)
def test_sharded_forwards_int8_pools_match_jax(cfg, tmp_path):
    check_forwards(cfg, "int8", tmp_path)
