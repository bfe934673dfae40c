"""The float32 matmuls as exact bf16-term products (engine/f32_matmul.py,
engine/kernels/bf16_split.py).

On the CPU: the three-term split rebuilds float32 values bit for bit; the
term counts follow the operands' dtypes and the products kept follow
``i + j <= 2`` on every way of adding them up; the route, with its GEMMs
emulated as float32 matmuls of the bf16-valued terms, is at least as close
to float64 as plain float32 at the dv-base and dv-fast shapes, forward and
backward; ``qdot``, ``_logits`` and the row-parallel projections keep the
plain float32 matmul on CPU tensors.

The ``cuda``-marked tests skip without a GPU.  This file imports no JAX, so
on the card they run with ``python3 -m pytest --noconftest -p
no:cacheprovider tests/test_torch_f32_matmul.py -m cuda`` (the repo's
``tests/conftest.py`` imports JAX): the split kernel against its plain
version bit for bit, every dv-base product against float64 within twice
cuBLAS float32's error, the serving products of bf16 weights (plain
route) likewise, and one dv-base ``Trainer`` step against the same step
with the route patched to plain float32.
"""

import re

import pytest
import torch

from deepvision_tpu_torch.engine import f32_matmul as fm
from deepvision_tpu_torch.engine import model as tmodel
from deepvision_tpu_torch.engine import pipeline_parallel
from deepvision_tpu_torch.engine.config import get_model_config
from deepvision_tpu_torch.engine.kernels.bf16_split import (
    split_bf16,
    split_bf16_both,
    split_bf16_reference,
)

torch.set_num_threads(2)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _values(exponents, n, seed):
    """``n`` float32 values a exponent, random mantissas, both signs."""
    g = torch.Generator().manual_seed(seed)
    e = torch.tensor(exponents, dtype=torch.float64).repeat_interleave(n)
    m = 1 + torch.rand(e.numel(), generator=g, dtype=torch.float64)
    s = torch.where(torch.rand(e.numel(), generator=g) < 0.5, -1.0, 1.0)
    return (s.double() * m * torch.pow(2.0, e)).float()


def _rebuilt(t, dim):
    terms = split_bf16(t, dim).float()
    lo, mid, hi = terms.chunk(3, dim=dim)
    # smallest first, as the products add them
    return (lo + mid) + hi, (lo, mid, hi)


# -- the split -----------------------------------------------------------------

@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("transposed", [False, True])
def test_split_rebuilds_float32_bit_for_bit(dim, transposed):
    """Every finite value with |w| >= 2**-110 (exponents -110 .. 127, both
    signs, random mantissas), random normals of several scales, the
    largest finite values (past bf16's, hi takes bf16's largest) and both
    zeros: hi + mid + lo is w, bit for bit; each term is the bf16 rounding
    of what the ones before leave."""
    w = torch.cat([
        _values(range(-110, 128), 64, seed=1),
        torch.randn(4096, generator=torch.Generator().manual_seed(2))
        * torch.tensor([1e-25, 1e-3, 1.0, 1e3, 1e30]).repeat(4096 // 5 + 1)
        [:4096],
        torch.tensor([3.4028235e38, -3.4028235e38, 3.3961e38, -3.3895e38,
                      0.0, -0.0, 1.0, -2.0]),
    ])
    w = w[:w.numel() // 8 * 8].reshape(-1, 8)
    t = w.t().contiguous().t() if transposed else w
    got, (lo, mid, hi) = _rebuilt(t, dim)
    assert torch.equal(_bits(got), _bits(w))
    assert torch.equal(hi.bfloat16().float(), hi)
    r = w - hi
    assert torch.equal(mid, r.bfloat16().float())
    assert torch.equal(lo, (r - mid).bfloat16().float())


def test_split_small_values_and_subnormals_within_bf16_reach():
    """Below 2**-110 lo's lowest bit would be under bf16's smallest
    subnormal (2**-133): exponents -126 .. -111 and float32 subnormals
    (down to 2**-149) rebuild within 2**-134 of w, each term still the
    bf16 rounding of the remainder."""
    w = torch.cat([_values(range(-126, -110), 256, seed=3),
                   _values(range(-149, -126), 64, seed=4),
                   torch.tensor([1e-45, -1e-45, 1e-40, -3e-39])])
    got, (lo, mid, hi) = _rebuilt(w[None, :], 0)
    assert (got[0].double() - w.double()).abs().max() <= 2.0 ** -134
    assert torch.equal(mid[0], (w - hi[0]).bfloat16().float())
    assert torch.equal(lo[0], (w - hi[0] - mid[0]).bfloat16().float())


def test_split_non_finite_values_stay_in_hi():
    w = torch.tensor([[float("inf"), float("-inf"), float("nan"), 1.5]])
    got, (lo, mid, hi) = _rebuilt(w, 1)
    assert torch.equal(hi[0, :2], w[0, :2]) and hi[0, 2].isnan()
    assert torch.equal(mid[0, :3], torch.zeros(3))
    assert torch.equal(lo[0, :3], torch.zeros(3))
    assert got[0, 0] == float("inf") and got[0, 3] == 1.5


def test_split_layouts_and_refusals():
    """Stacked along dim 0 or 1 smallest first; a transposed input comes
    back transposed; not a float32 matrix, or another dim, raises."""
    w = torch.randn(5, 7)
    s0, s1 = split_bf16(w, 0), split_bf16(w, 1)
    assert s0.shape == (15, 7) and s1.shape == (5, 21)
    assert torch.equal(s0[10:], w.bfloat16()) and torch.equal(s1[:, 14:],
                                                              w.bfloat16())
    st = split_bf16(w.t(), 0)
    assert st.shape == (21, 5) and torch.equal(st, s1.t())
    assert torch.equal(split_bf16(w, 0), split_bf16_reference(w, 0))
    for t in (w, w.t()):
        both = split_bf16_both(t)
        assert torch.equal(both[0], split_bf16(t, 0))
        assert torch.equal(both[1], split_bf16(t, 1))
    for bad, dim in ((w.bfloat16(), 0), (w[0], 0), (w, 2)):
        with pytest.raises(ValueError):
            split_bf16(bad, dim)


# -- the products ---------------------------------------------------------------

def test_term_counts_follow_dtype():
    a = torch.randn(4, 6)
    assert fm._terms(a, 0).n == 3 and fm._terms(a.bfloat16(), 0).n == 1
    assert fm._terms(a.bfloat16(), 1).stack is not None
    with pytest.raises(TypeError):
        fm._terms(a.double(), 0)
    with pytest.raises(TypeError):
        fm._terms(a.half(), 1)


def _integer_terms(n, rows, cols, dim, seed):
    """``n`` terms of small integers (exact in bf16 and in every sum),
    stacked along ``dim`` as :func:`split_bf16` stacks them."""
    g = torch.Generator().manual_seed(seed)
    terms = [torch.randint(-4, 5, (rows, cols), generator=g).float()
             for _ in range(n)]
    stack = torch.cat(terms[::-1], dim=dim).bfloat16()
    return fm._Terms(stack, dim, n), terms


@pytest.mark.parametrize("na,nb", [(1, 1), (1, 3), (3, 1), (3, 3)])
@pytest.mark.parametrize("shape,one_acc,chunk", [
    ((64, 8, 96), 2048, 512),    # large output, short K: concatenated
    ((8, 96, 8), 2048, 512),     # small output, long K: accumulated
    ((8, 96, 8), 16, 16),        # the leading product in pieces
    ((64, 96, 64), 16, 16),      # pieces and a concatenation of the rest
])
def test_products_keep_pairs_with_i_plus_j_at_most_2(monkeypatch, na, nb,
                                                     shape, one_acc, chunk):
    """Terms of small integers make every sum exact, so the result is the
    kept pairs' sum exactly and differs from the sum over all pairs."""
    monkeypatch.setattr(fm, "_ONE_ACC", one_acc)
    monkeypatch.setattr(fm, "_CHUNK", chunk)
    monkeypatch.setattr(fm, "_FINE_CHUNK", chunk // 2)
    M, K, N = shape
    a, at = _integer_terms(na, M, K, 1, seed=na * 10 + nb)
    b, bt = _integer_terms(nb, K, N, 0, seed=na * 10 + nb + 1)
    got = fm._products(a, b)
    kept = sum(at[i] @ bt[j] for i in range(na) for j in range(nb)
               if i + j <= 2)
    every = sum(at[i] @ bt[j] for i in range(na) for j in range(nb))
    assert got.dtype == torch.float32
    assert torch.equal(got, kept)
    if na * nb == 9:
        assert not torch.equal(got, every)


def test_chunks_cut_long_contractions_evenly():
    """One accumulator up to 2,048 products; beyond, pieces of at most
    2,048 with a float32 operand, and for two bf16 operands pieces of 256
    where the partial sums take at most 160 MiB, else of 512; equal pieces
    where K allows, shorter ones where it does not."""
    small, large = 768 * 256, 16384 * 768
    for exact in (False, True):
        assert [fm._chunks(k, large, exact) for k in (256, 2048)] == [1, 1]
    assert [fm._chunks(k, large, False) for k in (2304, 4096, 16384)] == [
        2, 2, 8]
    assert [fm._chunks(k, large, True) for k in (2304, 16384)] == [6, 32]
    assert [fm._chunks(k, small, True) for k in (2304, 16384)] == [9, 64]
    assert fm._chunks(16384, 768 * 768, True) == 64
    assert fm._chunks(16384, 768 * 2048, True) == 32
    for k in (2049, 5000, 16385):
        for out in (small, large):
            for exact in (False, True):
                c = fm._chunks(k, out, exact)
                assert k % c == 0 and c >= k / fm._ONE_ACC
                assert not exact or c >= k / fm._CHUNK


def _model_shapes(name):
    c = get_model_config(name)
    q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    # w_qkv and w_gate_up: q/k/v and gate/up side by side, as
    # f32_matmuls multiplies them on the card
    return {"wq": (c.d_model, q), "wk": (c.d_model, kv),
            "wv": (c.d_model, kv), "wo": (q, c.d_model),
            "w_gate": (c.d_model, c.d_ff), "w_up": (c.d_model, c.d_ff),
            "w_down": (c.d_ff, c.d_model), "head": (c.d_model, c.vocab_size),
            "w_qkv": (c.d_model, q + 2 * kv),
            "w_gate_up": (c.d_model, 2 * c.d_ff)}


SHAPE_CASES = [(m, p) for m in ("dv-base", "dv-fast")
               for p in ("wq", "wk", "wo", "w_gate", "w_down", "head",
                         "w_qkv", "w_gate_up")]


def _operands(name, K, N, M, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=device).bfloat16()
    if name == "head":   # the tied embedding, seen as [D, V]
        w = (torch.randn(N, K, generator=g, device=device) * 0.02).t()
    else:
        w = torch.randn(K, N, generator=g, device=device) * K ** -0.5
    gy = torch.randn(M, N, generator=g, device=device)
    if name != "head":   # rounded to bf16 inside the product
        gy = gy.bfloat16()
    return x, w, gy


def _rel(y, ref):
    return ((y.double() - ref).abs().max() / ref.abs().max()).item()


def _errors(x, w, gy):
    """Max error over max |float64| of the forward, dX (float32, before
    its bf16 rounding) and dW: the route's and plain float32's."""
    ref = x.double() @ w.double()
    dx_ref = gy.double() @ w.double().t()
    dw_ref = x.double().t() @ gy.double()
    xr = x.detach().requires_grad_(True)
    wr = w.detach().clone().requires_grad_(True)
    y = fm.split_matmul(xr, wr, gy.dtype)
    y.backward(gy)
    # a float32 x takes dX back unrounded; the bf16 x, the same rounded
    x32 = x.float().requires_grad_(True)
    fm.split_matmul(x32, w, gy.dtype).backward(gy)
    dx32 = x32.grad
    assert torch.equal(xr.grad, dx32.to(x.dtype))
    split = (_rel(fm.split_matmul(x, w, torch.float32), ref),
             _rel(dx32, dx_ref), _rel(wr.grad, dw_ref))
    plain = (_rel(x.float() @ w.float(), ref),
             _rel(gy.float() @ w.float().t(), dx_ref),
             _rel(x.float().t() @ gy.float(), dw_ref))
    return split, plain


@pytest.mark.parametrize("model,proj", SHAPE_CASES)
def test_split_route_as_close_to_float64_as_float32_at_model_shapes(model,
                                                                   proj):
    """The route's CPU emulation against float64 at each projection's (K,
    N) and the head's, 128 tokens, through autograd: forward, dX and dW
    at least as close as plain float32 matmuls."""
    K, N = _model_shapes(model)[proj]
    x, w, gy = _operands(proj, K, N, 128, "cpu", seed=K + N)
    split, plain = _errors(x, w, gy)
    for part, s, p in zip(("forward", "dX", "dW"), split, plain):
        assert s <= p, (part, s, p)


def test_split_route_in_pieces_as_close_as_float32(monkeypatch):
    """The leading product cut into pieces (as the weight gradients' over
    16,384 tokens are on the card), the head's shape over 4,096 tokens
    with pieces of 512."""
    monkeypatch.setattr(fm, "_ONE_ACC", 1024)
    K, N = _model_shapes("dv-fast")["w_down"]
    x, w, gy = _operands("w_down", K, N, 4096, "cpu", seed=5)
    split, plain = _errors(x, w, gy)
    for part, s, p in zip(("forward", "dX", "dW"), split, plain):
        assert s <= p, (part, s, p)


# -- who takes which route -------------------------------------------------------

def test_cpu_products_keep_the_plain_route():
    """On CPU tensors ``qdot``'s float32 branch, ``qdots``, ``_logits``,
    the row-parallel projections and the pipeline head are the plain
    float32 matmul, bit for bit, and count as ``plain``."""
    x = torch.randn(3, 5, 64).bfloat16()
    w = torch.randn(64, 48)
    before = dict(fm.f32_matmul.routes)
    want = torch.matmul(x.float(), w.float())
    for dt in (torch.bfloat16, torch.float32):
        assert torch.equal(tmodel.qdot(x, w, dt), want.to(dt))
        assert torch.equal(tmodel._out_proj(x, w, None, dt), want.to(dt))
    assert torch.equal(tmodel.qdot(x.float(), w.bfloat16(), torch.bfloat16),
                       torch.matmul(x.float(), w.bfloat16().float())
                       .bfloat16())
    cfg = get_model_config("dv-tiny-test")
    emb = torch.randn(cfg.vocab_size, cfg.d_model)
    h = torch.randn(2, cfg.d_model).bfloat16()
    assert torch.equal(tmodel._logits(h, {"embed": emb}, cfg),
                       torch.matmul(h.float(), emb.t().float()))
    w2 = torch.randn(64, 16)
    got = tmodel.qdots(x, (w, w2), torch.bfloat16)
    assert torch.equal(got[0], want.bfloat16())
    assert torch.equal(got[1], torch.matmul(x.float(), w2).bfloat16())
    assert fm.f32_matmul.routes["split"] == before["split"]
    assert fm.f32_matmul.routes["plain"] == before["plain"] + 8
    assert pipeline_parallel.f32_matmul is fm.f32_matmul
    # bf16 products and int8 weights keep qdot's own routes
    wb = w.bfloat16()
    assert torch.equal(tmodel.qdots(x, (wb,), torch.bfloat16)[0],
                       tmodel.qdot(x, wb, torch.bfloat16))
    assert fm.f32_matmul.routes["plain"] == before["plain"] + 8


def _tiny_step(cfg, params, tokens):
    logits = tmodel.forward_train(params, tokens[:, :-1], cfg=cfg,
                                  use_kernel=True)
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1)
        .long())
    loss.backward()
    return loss.item(), {n: p.grad.norm().item() for n, p in _leaves(params)}


def _leaves(tree, prefix=""):
    for name in sorted(tree):
        if isinstance(tree[name], dict):
            yield from _leaves(tree[name], f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", tree[name]


def _plain(x, w, out_dtype=torch.float32):
    return torch.matmul(x.float(), w.float()).to(out_dtype)


def _rounded(x, w, out_dtype=torch.float32):
    """The correctly rounded float32 product (float64, then rounded)."""
    return torch.matmul(x.double(), w.double()).float().to(out_dtype)


def _assert_float32_close(step):
    """``step(route)`` -> (loss, per-leaf gradient norms) of one training
    step whose float32 products all run through ``route``.  The route and
    plain float32 matmuls differ in the order of their sums, and bf16
    activations downstream turn that into gaps of ~1e-5 in the loss and
    ~1e-3 in a leaf's norm, so float32's own tolerance here is the gap
    between plain float32 and correctly rounded products: the route may
    be no more than twice as far from the correctly rounded step."""
    loss_r, norms_r = step(_rounded)
    loss_p, norms_p = step(_plain)
    loss_s, norms_s = step(fm.split_matmul)

    def leaf_gap(norms):
        return max(abs(norms[k] - n) / n for k, n in norms_r.items() if n)

    ulp = 2.0 ** -23 * abs(loss_r)
    assert abs(loss_s - loss_r) <= 2 * abs(loss_p - loss_r) + ulp, (
        loss_s, loss_p, loss_r)
    assert leaf_gap(norms_s) <= 2 * leaf_gap(norms_p), (
        leaf_gap(norms_s), leaf_gap(norms_p))


def test_training_step_on_the_route_matches_plain_float32(monkeypatch):
    """A dv-tiny-test training step (float32 params, bf16 activations)
    with every float32 product forced onto the route, against the plain
    one, to float32 tolerance; every product of the step took the
    route."""
    from deepvision_tpu_torch.engine.weights import init_params

    cfg = get_model_config("dv-tiny-test")
    tokens = torch.randint(1, cfg.vocab_size, (2, 33),
                           generator=torch.Generator().manual_seed(6),
                           dtype=torch.int32)
    calls = []

    def step(route):
        def counted(x, w, out_dtype=torch.float32):
            calls.append(route)
            return route(x, w, out_dtype)

        def counted_many(x, ws, out_dtype=torch.float32):
            if route is fm.split_matmul:   # the card's fused products
                calls.extend([route] * len(ws))
                return fm.split_matmuls(x, ws, out_dtype)
            return tuple(counted(x, w, out_dtype) for w in ws)

        monkeypatch.setattr(tmodel, "f32_matmul", counted)
        monkeypatch.setattr(tmodel, "f32_matmuls", counted_many)
        init = init_params(cfg, device="cpu", seed=0, dtype=torch.float32)
        params = {k: ({n: t.requires_grad_(True) for n, t in v.items()}
                      if isinstance(v, dict) else v.requires_grad_(True))
                  for k, v in init.items()}
        return _tiny_step(cfg, params, tokens)

    _assert_float32_close(step)
    assert calls.count(fm.split_matmul) == 7 * cfg.n_layers + 1


# -- on the card -------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the split kernel and the "
                    "tensor-core GEMMs have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("shape", [(4099, 37), (768, 2048), (2048, 768)])
def test_cuda_split_kernel_matches_plain(shape, dim):
    """The kernel against :func:`split_bf16_reference` bit for bit, both
    layouts, read as it lies and transposed, on values of every exponent
    with zeros, infinities, NaN (a NaN's bits are the converter's own: NaN
    where the plain version has NaN) and values past bf16's largest."""
    _need_cuda()
    R, C = shape
    w = _values(range(-149, 128), R * C // 277 + 1, seed=7)[:R * C]
    w[:8] = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                          float("nan"), 3.4e38, -3.3999e38, 1e-45])
    w = w[torch.randperm(w.numel(), generator=torch.Generator()
                         .manual_seed(8))].reshape(R, C)
    for t in (w, w.t().contiguous().t()):
        want = split_bf16_reference(t, dim)
        for got in (split_bf16(t.cuda(), dim).cpu(),
                    split_bf16_both(t.cuda())[dim].cpu()):
            assert torch.equal(got.isnan(), want.isnan())
            g, h = (x.masked_fill(want.isnan(), 0).view(torch.int16)
                    for x in (got, want))
            bad = (g != h).nonzero()[:4].tolist()
            assert not bad, [(i, got[tuple(i)].item(),
                              want[tuple(i)].item()) for i in bad]


@pytest.mark.cuda
@pytest.mark.parametrize("proj", list(_model_shapes("dv-base")))
def test_cuda_products_within_twice_float32_error(proj):
    """Every dv-base projection, the head and the side-by-side q/k/v and
    gate/up products, 16,384 tokens: forward, dX and dW against float64,
    no worse than twice cuBLAS float32's error on the same inputs."""
    _need_cuda()
    K, N = _model_shapes("dv-base")[proj]
    x, w, gy = _operands(proj, K, N, 16384, "cuda", seed=K + N)
    split, plain = _errors(x, w, gy)
    for part, s, p in zip(("forward", "dX", "dW"), split, plain):
        assert s <= 2 * p, (part, s, p)


SERVING_CASES = [(m, p, t) for m in ("dv-base", "dv-fast")
                 for p in ("wo", "w_down", "head") for t in (8, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("model,proj,tokens", SERVING_CASES)
def test_cuda_serving_products_within_twice_float32_error(model, proj,
                                                          tokens):
    """bf16 serving weights: wo and w_down through ``qdot`` with a float32
    result and the tied head through ``_logits``, bf16 activations, a
    decode batch and a prefill, against float64, no worse than twice
    cuBLAS float32's error on the same inputs; two bf16 operands take the
    plain route."""
    _need_cuda()
    K, N = _model_shapes(model)[proj]
    x, w, _ = _operands(proj, K, N, tokens, "cuda", seed=K + N + tokens)
    w = w.bfloat16()
    before = dict(fm.f32_matmul.routes)
    with torch.no_grad():
        if proj == "head":
            got = tmodel._logits(x, {"embed": w.t()},
                                 get_model_config(model))
        else:
            got = tmodel.qdot(x, w, torch.float32)
    assert got.dtype == torch.float32
    assert fm.f32_matmul.routes["plain"] == before["plain"] + 1
    assert fm.f32_matmul.routes["split"] == before["split"]
    ref = x.double() @ w.double()
    assert _rel(got, ref) <= 2 * _rel(x.float() @ w.float(), ref)


@pytest.mark.cuda
def test_cuda_trainer_step_on_the_route_matches_plain_float32(monkeypatch):
    """One dv-base ``Trainer`` step (8 x 2,048 tokens, float32 params, bf16
    activations, the flash kernels) by the route against the same step
    with ``split_matmul`` patched to the plain float32 matmul, to float32
    tolerance (:func:`_assert_float32_close`); all 85 products of the step
    ran on the route, and no float32 GEMM kernel ran."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile

    from deepvision_tpu_torch.engine.training import Trainer

    cfg = get_model_config("dv-base")
    tokens = torch.randint(0, cfg.vocab_size, (8, 2049),
                           generator=torch.Generator().manual_seed(9),
                           dtype=torch.int32)
    real = fm.split_matmul

    def trainer_step(route):
        monkeypatch.setattr(fm, "split_matmul", route)
        trainer = Trainer(cfg, param_dtype=torch.float32, use_kernel=True,
                          seed=0, device="cuda")
        loss = trainer.train_step(tokens)
        return loss, {n: p.grad.norm().item()
                      for n, p in _leaves(trainer.params)}

    _assert_float32_close(trainer_step)
    monkeypatch.setattr(fm, "split_matmul", real)
    trainer = Trainer(cfg, param_dtype=torch.float32, use_kernel=True,
                      seed=0, device="cuda")
    before = dict(fm.f32_matmul.routes)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_step(tokens)
        torch.cuda.synchronize()
    assert fm.f32_matmul.routes["split"] - before["split"] == 85
    assert fm.f32_matmul.routes["plain"] == before["plain"]
    names = {e.key for e in prof.key_averages()}
    assert not [n for n in names if re.search(r"sgemm|f32f32", n)], names
