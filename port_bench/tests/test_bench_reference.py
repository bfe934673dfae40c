"""The reference agrees with itself across block sizes, follows the dv
architecture as the program's plain float32 path computes it, and its
optimizer chain follows torch's AdamW under the schedule."""

import math

import pytest
import torch

from port_bench import weights
from port_bench.reference import model as ref

CFG = {"name": "dv-tiny", "vocab_size": 96, "d_model": 32, "n_layers": 2,
       "n_heads": 4, "n_kv_heads": 2, "d_ff": 48, "head_dim": 8,
       "rope_theta": 10000.0, "rms_eps": 1e-5, "max_seq_len": 64,
       "tie_embeddings": True, "scale_embeddings": False,
       "logit_softcap": 0.0}


def _params(seed=5):
    p = weights.make_params(CFG, seed, "cpu", torch.float32)
    g = torch.Generator().manual_seed(seed)
    for _, leaf in weights.leaves(p):
        if leaf.dim() <= 2 and leaf.shape[-1] == CFG["d_model"]:
            leaf.add_(0.1 * torch.randn(leaf.shape, generator=g))
    return p


def test_blocks_of_queries_agree():
    p = _params()
    toks = torch.randint(0, 96, (37,), generator=torch.Generator()
                         .manual_seed(1))
    whole = ref.forward(p, toks, CFG, block=64)
    for block in (1, 7, 16):
        assert torch.allclose(ref.forward(p, toks, CFG, block=block), whole,
                              atol=1e-5, rtol=1e-5)


def test_blocks_of_rows_agree():
    p = {k: v for k, v in _params().items()}
    for _, leaf in weights.leaves(p):
        leaf.requires_grad_(True)
    batch = torch.randint(0, 96, (4, 17), generator=torch.Generator()
                          .manual_seed(2))
    l1, g1 = ref.loss_and_grads(p, batch, CFG, rows=1)
    l4, g4 = ref.loss_and_grads(p, batch, CFG, rows=4)
    assert l1 == pytest.approx(l4, rel=1e-6)
    for a, b in zip(g1, g4):
        assert torch.allclose(a, b, atol=1e-6, rtol=1e-5)


def test_matches_the_programs_float32_forward():
    from deepvision_tpu_torch.engine.config import ModelConfig
    from deepvision_tpu_torch.engine.model import forward_train

    p = _params()
    toks = torch.randint(0, 96, (1, 29), generator=torch.Generator()
                         .manual_seed(3))
    prog = forward_train(p, toks, cfg=ModelConfig(**CFG),
                         act_dtype=torch.float32)[0]
    assert torch.allclose(ref.forward(p, toks[0], CFG), prog, atol=1e-4,
                          rtol=1e-4)


def test_chain_is_adamw_under_the_schedule():
    opt = {"learning_rate": 3e-4, "warmup_steps": 2, "total_steps": 10,
           "end_lr_ratio": 0.05, "b1": 0.9, "b2": 0.999, "eps": 1e-8,
           "weight_decay": 0.01, "max_grad_norm": 1.0}
    assert ref.warmup_cosine(0, 3e-4, 2, 10, 1.5e-5) == 0.0
    assert ref.warmup_cosine(1, 3e-4, 2, 10, 1.5e-5) == 1.5e-4
    assert ref.warmup_cosine(10, 3e-4, 2, 10, 1.5e-5) == pytest.approx(
        1.5e-5)
    torch.manual_seed(0)
    a = [torch.randn(5, 3), torch.randn(7)]
    b = [t.clone().requires_grad_(True) for t in a]
    chain = ref.AdamWChain(a, opt)
    torch_opt = torch.optim.AdamW(b, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.01)
    for step in range(4):
        grads = [torch.randn_like(t) * 3 for t in a]
        clipped = chain.step(a, grads)
        norm = math.sqrt(sum(float(g.square().sum()) for g in grads))
        assert math.sqrt(sum(float(g.square().sum()) for g in clipped)) \
            == pytest.approx(min(norm, 1.0), rel=1e-5)
        for p, g in zip(b, clipped):
            p.grad = g.clone()
        for group in torch_opt.param_groups:
            group["lr"] = ref.warmup_cosine(step, 3e-4, 2, 10, 1.5e-5)
        torch_opt.step()
        for x, y in zip(a, b):
            assert torch.allclose(x, y.detach(), atol=1e-7)
