"""Matrix products with float32 semantics, on the tensor cores on the card.

A float32 value splits exactly into three bf16 terms, ``w = hi + mid + lo``
(:func:`~deepvision_tpu_torch.engine.kernels.bf16_split.split_bf16`), and
the product of two bf16 values is exact in a float32 accumulator.  So
``x @ w`` with float32 semantics is the sum of its operands' term products
``x_i @ w_j``: a bf16 operand has one term, a float32 operand three, and
the pairs kept are those with ``i + j <= 2`` (the dropped ones are below
``2**-24`` of the leading product, float32's own rounding).  A bf16 x times
a float32 w is three bf16 GEMMs, two float32 operands six, two bf16 ones
one.  Every GEMM is bf16 x bf16 with a float32 result
(``torch.mm(..., out_dtype=torch.float32)``): the result is float32's up
to the order of the sum.

:func:`f32_matmul` is :func:`split_matmul` on CUDA tensors where an
operand is float32, and ``torch.matmul(x.float(), w.float())
.to(out_dtype)`` everywhere else: on CPU tensors, the arithmetic the CPU
tests hold against the JAX package, and for two bf16 operands (the
serving path's bf16 weights with a float32 result).  Two bf16 operands
multiply exactly in plain float32 as well, which then errs only in its
sums; on an H100 a tensor-core accumulator over the 512-2,048 products of
a serving projection errs up to 18x cuBLAS float32's, and up to 3x even
in pieces of 256 (PERF.md).
:func:`f32_matmuls` does the same for weights that share their input, on
the split route as one product with the weights side by side.
``f32_matmul.routes`` counts the products by route (``"split"``,
``"plain"``).  :func:`split_matmul` runs on any device: on CPU tensors its
GEMMs are float32 matmuls of the bf16-valued terms, the same products and
accumulator, which is how the CPU tests check it.

It is differentiable through one ``torch.autograd.Function`` whose forward
and backward follow the same rule: ``dX = dY @ w.T`` and ``dW = x.T @ dY``
take as many terms of ``dY`` as its dtype has (bf16 where the result was
rounded to bf16 inside the product, as the projections that feed bf16
activations do), and ``dX`` / ``dW`` come back in ``x`` / ``w``'s dtypes,
as the casts of ``x.float()`` and ``w.float()`` round them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from deepvision_tpu_torch.engine.kernels.bf16_split import (
    split_bf16,
    split_bf16_both,
)


def f32_matmul(x: torch.Tensor, w: torch.Tensor,
               out_dtype=torch.float32) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` multiplied as float32 and rounded to
    ``out_dtype``: the bf16-term products on CUDA tensors with a float32
    operand, else the plain float32 matmul."""
    return f32_matmuls(x, (w,), out_dtype)[0]


def f32_matmuls(x: torch.Tensor, ws, out_dtype=torch.float32) -> tuple:
    """:func:`f32_matmul` of ``x`` with each weight of ``ws``; on the split
    route one product with the weights side by side
    (:func:`split_matmuls`).  ``f32_matmul.routes`` counts the products."""
    if x.is_cuda and torch.float32 in (x.dtype, *(w.dtype for w in ws)):
        f32_matmul.routes["split"] += len(ws)
        return split_matmuls(x, ws, out_dtype)
    f32_matmul.routes["plain"] += len(ws)
    return tuple(torch.matmul(x.float(), w.float()).to(out_dtype)
                 for w in ws)


f32_matmul.routes = {"split": 0, "plain": 0}


def split_matmuls(x: torch.Tensor, ws, out_dtype=torch.float32) -> tuple:
    """:func:`split_matmul` of ``x`` with each weight of ``ws``, as one
    over the weights concatenated along N: one GEMM where there would be
    one a weight, and ``dX`` summed in float32 before its rounding."""
    if len(ws) == 1:
        return (split_matmul(x, ws[0], out_dtype),)
    y = split_matmul(x, torch.cat(ws, dim=1), out_dtype)
    return y.split([w.shape[1] for w in ws], dim=-1)


def split_matmul(x: torch.Tensor, w: torch.Tensor,
                 out_dtype=torch.float32) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` (bf16 or float32 each) as the sum of the
    operands' bf16-term products, in float32, rounded to ``out_dtype``;
    differentiable in both."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _SplitMatmul.apply(x, w, out_dtype)
    x2 = x.reshape(-1, x.shape[-1])
    y = _products(_terms(x2, 1), _terms(w, 0)).to(out_dtype)
    return y.reshape(*x.shape[:-1], w.shape[-1])


class _SplitMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, out_dtype):
        x2 = x.reshape(-1, x.shape[-1])
        if w.dtype == torch.float32:
            # w's terms once, stacked for this product and for dX's
            (w_fwd, w_bwd), n = split_bf16_both(w), 3
        else:
            w_fwd = w_bwd = _terms(w, 0).stack
            n = 1
        y = _products(_terms(x2, 1), _Terms(w_fwd, 0, n)).to(out_dtype)
        # the bf16 x itself (a float32 x is split again in the backward)
        ctx.save_for_backward(x2, w_bwd)
        ctx.meta = (x.shape, n, w.dtype)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, gy):
        x2, w_bwd = ctx.saved_tensors
        x_shape, n, w_dtype = ctx.meta
        gt = _terms(gy.reshape(-1, gy.shape[-1]), 0)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _products(gt, _Terms(w_bwd.t(), 0, n))
            dx = dx.to(x2.dtype).reshape(x_shape)
        if ctx.needs_input_grad[1]:
            dw = _products(_terms(x2, 0).t(), gt).to(w_dtype)
        return dx, dw, None


# A contraction of up to _ONE_ACC products runs in one accumulator; a longer
# one (the weight gradients' over the batch's tokens, the head's over the
# vocabulary) is cut into pieces, each in an accumulator of its own (see
# _products).  With a float32 operand, whose products plain float32 rounds
# too, pieces of up to _ONE_ACC keep the error within cuBLAS float32's.  Two
# bf16 operands multiply exactly in plain float32 as well, which then errs
# only in its sums: their pieces are of _FINE_CHUNK products where the
# float32 partial sums take at most _PARTIAL_BYTES (small outputs, the
# weight gradients of the narrow projections), else of _CHUNK.  On an H100
# that keeps the error of every product of a dv-base or dv-fast training
# step within 2x cuBLAS float32's (PERF.md).
_ONE_ACC = 2048
_CHUNK = 512
_FINE_CHUNK = 256
_PARTIAL_BYTES = 160 << 20


class _Terms(NamedTuple):
    """The ``n`` bf16 terms of a matrix, stacked along ``dim`` of ``stack``
    smallest first: term 0, the leading one, is the last block."""
    stack: torch.Tensor
    dim: int
    n: int

    @property
    def shape(self):
        """The shape of one term."""
        rows, cols = self.stack.shape
        if self.dim == 0:
            return rows // self.n, cols
        return rows, cols // self.n

    def term(self, i: int) -> torch.Tensor:
        if self.n == 1:
            return self.stack
        size = self.stack.shape[self.dim] // self.n
        return self.stack.narrow(self.dim, (self.n - 1 - i) * size, size)

    def t(self) -> "_Terms":
        return _Terms(self.stack.t(), 1 - self.dim, self.n)


def _terms(t: torch.Tensor, dim: int) -> _Terms:
    """A bf16 matrix is its own one term; a float32 one has three, stacked
    along ``dim`` (the contraction dim of the product it enters keeps a
    concatenation free of copies)."""
    if t.dtype == torch.bfloat16:
        return _Terms(t, dim, 1)
    if t.dtype != torch.float32:
        raise TypeError(f"f32_matmul: bf16 or float32 operands, got "
                        f"{t.dtype}")
    return _Terms(split_bf16(t, dim), dim, 3)


def _products(a: _Terms, b: _Terms) -> torch.Tensor:
    """``sum(a_i @ b_j for i + j <= 2)`` in float32, ``a`` ``[M, K]``,
    ``b`` ``[K, N]``.

    The card's tensor cores add a GEMM's products into its float32
    accumulator rounding toward zero, so the accumulator's error grows with
    the number of products it takes, in proportion to its own size.  The
    products are therefore added smallest first, the leading one
    (``a_0 @ b_0``) last, and a long contraction of the leading one is cut
    into pieces (:func:`_chunks`), each in an accumulator of its own, which
    are then added in float32 rounding to nearest (a batched GEMM and a
    sum).  The others are ``2**-8`` and ``2**-16`` of it, and so is their
    error.

    Two ways to add the products up, chosen by the bytes each moves beyond
    the GEMMs themselves: concatenated along K (``[a_i | ...] @ [b_j;
    ...]``, one GEMM and one accumulator, at the cost of copying the
    repeated terms: the way where the output is large and K small) or one
    GEMM a product added into the output by the GEMM itself (which then
    reads and writes the output again: the way where the output is small
    and K large)."""
    pairs = _pairs(a.n, b.n)
    rest = pairs[:-1]
    (M, K), N = a.shape, b.shape[1]
    chunks = _chunks(K, M * N, exact=a.n == b.n == 1)
    if chunks == 1 and _concat_cheaper(a, b, pairs, M, K, N):
        return _mm(*_concat(a, b, pairs))
    out = _chunked_mm(a.term(0), b.term(0), chunks)
    if len(rest) > 1 and _concat_cheaper(a, b, rest, M, K, N):
        _addmm_(out, *_concat(a, b, rest))
    else:
        for i, j in rest:
            _addmm_(out, a.term(i), b.term(j))
    return out


@functools.lru_cache(maxsize=None)
def _pairs(na: int, nb: int) -> tuple:
    """The kept pairs ``(i, j)``, ``i + j <= 2``, smallest product first."""
    return tuple(sorted(((i, j) for i in range(na) for j in range(nb)
                         if i + j <= 2), key=lambda p: -sum(p)))


def _chunks(K: int, out_numel: int, exact: bool) -> int:
    """Pieces of the leading product's contraction, equal where K allows:
    one up to ``_ONE_ACC``; beyond, at most ``_ONE_ACC`` long, or for
    ``exact`` products (two bf16 operands) ``_FINE_CHUNK`` long where the
    partial sums of ``out_numel`` values each fit ``_PARTIAL_BYTES``, else
    ``_CHUNK`` long."""
    if K <= _ONE_ACC:
        return 1
    if not exact:
        return _pieces(K, _ONE_ACC)
    fine = _pieces(K, _FINE_CHUNK)
    return fine if 4 * fine * out_numel <= _PARTIAL_BYTES else _pieces(
        K, _CHUNK)


def _pieces(K: int, length: int) -> int:
    c = -(-K // length)
    while K % c:
        c += 1
    return c


def _concat_cheaper(a, b, pairs, M, K, N) -> bool:
    """Whether copying the terms for one GEMM over ``pairs`` moves fewer
    bytes than a GEMM a pair adding into the float32 output."""
    a_order, b_order = [i for i, _ in pairs], [j for _, j in pairs]
    concat = 2 * (_copies(a, a_order, 1) * M * K
                  + _copies(b, b_order, 0) * K * N)
    return concat <= 8 * (len(pairs) - 1) * M * N


def _concat(a, b, pairs):
    return (_stacked(a, [i for i, _ in pairs], 1),
            _stacked(b, [j for _, j in pairs], 0))


def _copies(t: _Terms, order: list, dim: int) -> int:
    """Terms :func:`_stacked` copies to concatenate ``order`` along
    ``dim``: none where the stack already is that."""
    if len(order) == t.n and (t.n == 1 or t.dim == dim) and order == list(
            range(t.n - 1, -1, -1)):
        return 0
    return len(order)


def _stacked(t: _Terms, order: list, dim: int) -> torch.Tensor:
    if not _copies(t, order, dim):
        return t.stack
    return torch.cat([t.term(i) for i in order], dim=dim)


def _chunked_mm(a: torch.Tensor, b: torch.Tensor, chunks: int):
    """``a [M, K] @ b [K, N]`` in float32, K cut into ``chunks`` equal
    pieces, each in its own accumulator, added rounding to nearest."""
    if chunks == 1:
        return _mm(a, b)
    L = a.shape[1] // chunks
    parts = _bmm(a.unflatten(1, (chunks, L)).transpose(0, 1),
                 b.unflatten(0, (chunks, L)))
    return parts.sum(0)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 ``a @ b`` with a float32 result: one tensor-core GEMM on the
    card; on the CPU, which has no such GEMM, the same exact products in a
    float32 matmul."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched :func:`_mm`."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _addmm_(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """``out += a @ b`` (bf16 ``a``, ``b``; float32 ``out``): the GEMM's
    own accumulator, added to ``out`` as the GEMM writes it."""
    if a.is_cuda:
        torch.addmm(out, a, b, out_dtype=torch.float32, out=out)
    else:
        out += torch.mm(a.float(), b.float())
