"""Plain float32 reference of the dv decoder and of its training step.

The dv family is a Llama-style decoder: RMSNorm with a ``1 + scale`` gain,
rotary embedding (rotate-half, ``theta ** (-2i / head_dim)``), causal
grouped-query attention scaled by ``head_dim ** -0.5`` (query head ``h``
reads kv head ``h // (H / KV)``), a SiLU-gated MLP, a final RMSNorm and
logits against the embedding (tied) or ``lm_head``.  Everything runs in
float32 with TF32 off, one sequence at a time, with no cache, kernel or
batching; it takes the benchmark's weights and inputs and imports nothing
of the program.

The training step is mean next-token cross-entropy, its gradient summed
row by row, clipping by the global norm, and AdamW with decoupled weight
decay under a linear-warmup cosine schedule (optax's
``warmup_cosine_decay_schedule``).
"""

from __future__ import annotations

import math

import torch


def exact_float32() -> None:
    """Float32 matmuls in full float32 (no TF32) from here on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def _rope(x, positions, theta):
    """x ``[S, heads, HD]`` rotated by ``positions [S]``."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[:, None] * freq[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, block: int):
    """Causal GQA over one sequence, ``block`` query rows at a time: q
    ``[S, H, HD]``, k/v ``[S, KV, HD]``."""
    S, H, HD = q.shape
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    out = []
    for a in range(0, S, block):
        b = min(S, a + block)
        scores = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * HD ** -0.5
        rows = torch.arange(a, b, device=q.device)[:, None]
        causal = torch.arange(b, device=q.device)[None, :] <= rows
        scores = scores.masked_fill(~causal, float("-inf"))
        out.append(torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1),
                                v[:b]))
    return torch.cat(out)


def forward(params: dict, tokens: torch.Tensor, cfg: dict,
            block: int = 1024) -> torch.Tensor:
    """Float32 logits ``[S, V]`` of one sequence ``tokens [S]`` (positions
    from 0), attention ``block`` query rows at a time; differentiable in
    float32 ``params``."""
    f32 = {k: v for k, v in params.items() if k != "blocks"}
    blocks = params["blocks"]
    HD, eps, theta = cfg["head_dim"], cfg["rms_eps"], cfg["rope_theta"]
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = f32["embed"].float()[tokens.long()]
    for i in range(cfg["n_layers"]):
        b = {name: leaf[i].float() for name, leaf in blocks.items()}
        h = _rms_norm(x, b["ln1"], eps)
        q = _rope((h @ b["wq"]).view(S, -1, HD), pos, theta)
        k = _rope((h @ b["wk"]).view(S, -1, HD), pos, theta)
        v = (h @ b["wv"]).view(S, -1, HD)
        x = x + _attention(q, k, v, block).reshape(S, -1) @ b["wo"]
        h = _rms_norm(x, b["ln2"], eps)
        x = x + (torch.nn.functional.silu(h @ b["w_gate"])
                 * (h @ b["w_up"])) @ b["w_down"]
    x = _rms_norm(x, f32["final_norm"].float(), eps)
    head = (f32["embed"].float().t() if cfg["tie_embeddings"]
            else f32["lm_head"].float())
    return x @ head


# ---------------------------------------------------------------------------
# Serving: the gap of each served token below the reference's best
# ---------------------------------------------------------------------------

@torch.no_grad()
def served_token_gaps(params, prompt, served, cfg, device) -> torch.Tensor:
    """``max(logits) - logits[served token]`` at every served position:
    one forward over the prompt and the served tokens but the last."""
    ids = torch.tensor(list(prompt) + list(served[:-1]), dtype=torch.long,
                       device=device)
    logits = forward(params, ids, cfg)[len(prompt) - 1:]
    tok = torch.tensor(list(served), dtype=torch.long, device=device)
    return logits.amax(-1) - logits.gather(-1, tok[:, None])[:, 0]


# ---------------------------------------------------------------------------
# Training: loss, gradients and the AdamW chain
# ---------------------------------------------------------------------------

def loss_and_grads(params: dict, batch: torch.Tensor, cfg: dict,
                   rows: int = 1):
    """Mean next-token cross-entropy of ``batch [B, S + 1]`` and its
    gradients (a list in the leaves' sorted order), ``rows`` rows at a
    time."""
    B = batch.shape[0]
    total = 0.0
    grads = None
    leaves = _flat(params)
    for r in range(0, B, rows):
        loss = 0.0
        for row in batch[r:r + rows].long():
            logits = forward(params, row[:-1], cfg)
            loss = loss + torch.nn.functional.cross_entropy(
                logits, row[1:]) / B
        g = torch.autograd.grad(loss, leaves)
        grads = list(g) if grads is None else [a + b for a, b in
                                               zip(grads, g)]
        total += float(loss.detach())
        del logits, loss
    return total, grads


def _flat(tree: dict) -> list:
    out = []
    for name in sorted(tree):
        leaf = tree[name]
        out.extend(_flat(leaf) if isinstance(leaf, dict) else [leaf])
    return out


def warmup_cosine(count: int, peak: float, warmup: int, total: int,
                  end: float) -> float:
    if count < warmup:
        return peak * count / warmup
    t = min(count - warmup, total - warmup)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / (total - warmup)))
    return end + (peak - end) * cosine


class AdamWChain:
    """Clip by the global norm, then AdamW with decoupled weight decay:
    ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``."""

    def __init__(self, leaves: list, opt: dict):
        self.opt = opt
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.count = 0

    @torch.no_grad()
    def step(self, leaves: list, grads: list) -> list:
        """Applies one update in place; returns the clipped gradients."""
        o = self.opt
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        coef = 1.0 if norm < o["max_grad_norm"] else o["max_grad_norm"] / norm
        grads = [g * coef for g in grads]
        lr = warmup_cosine(self.count, o["learning_rate"], o["warmup_steps"],
                           o["total_steps"],
                           o["end_lr_ratio"] * o["learning_rate"])
        self.count += 1
        b1, b2 = o["b1"], o["b2"]
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for p, g, m, v in zip(leaves, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m / bc1) / ((v / bc2).sqrt() + o["eps"])
            p.sub_(lr * (upd + o["weight_decay"] * p))
        return grads
