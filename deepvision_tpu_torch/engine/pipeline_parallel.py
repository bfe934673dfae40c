"""Pipeline parallelism (GPipe) over a group of stage ranks.

The counterpart of the JAX package's ``engine/pipeline_parallel.py``:

* the stacked block params' leading layer axis is cut into contiguous
  ``L / n`` chunks, one a stage; the embedding, the final norm and an
  untied head are replicated;
* a batch splits into ``n_micro`` microbatches that stream through the
  stages; activations hop stage to stage;
* the loss is the mean of the microbatches' next-token cross-entropy, the
  same value on every stage, and equals the single-device loss.

The JAX package writes the schedule as one differentiable ``lax.scan``
over ticks, with ``ppermute`` hops, and lets ``jax.grad`` transpose it.
In eager PyTorch a stage that drops a received activation also drops the
hop's backward, and its neighbour then waits for a gradient that never
comes.  So the schedule here is GPipe's, written out: every microbatch
forward (each stage receives from the stage before it, runs its layers
and sends to the next, keeping its graph), then every microbatch backward
in reverse (each stage receives the gradient of its output, runs its
backward and sends its input's gradient back).  Every stage posts the
same ordered point-to-point messages, tagged by microbatch, so no stage
waits on a message that is not coming.  Bubbles compute nothing, where
the JAX scan computes zeros.  A replicated leaf's gradient is the sum of
every stage's part (the first stage's lookup and the last stage's tied
head for the embedding): one ``all_reduce`` over the stages.

Stages run the dense attention (``flash_attention_reference``) in float32
activations by default, as the JAX stages do, and the loss, as the JAX
one, leaves out ``logit_softcap`` (which no preset sets).

Each stage is a process (``parallel.RankProcesses``); :class:`PPTrainer`
is a stage's trainer, and rank 0's drives the others with commands sent
over the group (``train_model.py --pp``).
"""

from __future__ import annotations

import torch

from deepvision_tpu_torch.engine import model as model_lib
from deepvision_tpu_torch.engine.config import ModelConfig
from deepvision_tpu_torch.engine.f32_matmul import f32_matmul
from deepvision_tpu_torch.engine.kernels.flash_attention import (
    flash_attention_reference,
)
from deepvision_tpu_torch.engine.parallel import (
    TPGroup,
    gather_params,
    join_axis,
    shard,
)
from deepvision_tpu_torch.engine.training import (
    _leaves,
    as_trainable,
    cross_entropy_loss,
    global_grad_norm,
    sum_grads_,
)

_BLOCK_LEAVES = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up",
                 "w_down")


def make_pp_mesh(n_stages: int, *, rank: int, store_path: str,
                 device="cuda") -> TPGroup:
    """Stage ``rank``'s group of an ``n_stages``-rank pipeline, meeting
    the others at the file ``store_path``; stage ``r`` on ``cuda:(r %
    device_count)`` (one card holds every stage) or the CPU."""
    return join_axis(n_stages, rank=rank, store_path=store_path,
                     device=device, what="pipeline")


def pp_param_specs(cfg: ModelConfig) -> dict:
    """The dim each leaf is cut along over the stages (None: replicated):
    the blocks' layer axis; embedding, norm and head replicated."""
    specs = {"embed": None, "final_norm": None,
             "blocks": {name: 0 for name in _BLOCK_LEAVES}}
    if not cfg.tie_embeddings:
        specs["lm_head"] = None
    return specs


def pp_stage_layers(cfg: ModelConfig, n_stages: int) -> int:
    if cfg.n_layers % n_stages != 0:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pipeline stages "
            f"{n_stages}")
    return cfg.n_layers // n_stages


def place_pp_params(params: dict, group: TPGroup, cfg: ModelConfig) -> dict:
    """Stage ``group.rank``'s params from the full tree: its contiguous
    chunk of every block leaf's layers, the rest whole."""
    pp_stage_layers(cfg, group.size)
    specs = pp_param_specs(cfg)

    def walk(node, d):
        if isinstance(node, dict):
            return {k: walk(v, d[k]) for k, v in node.items()}
        return shard(node, d, group.rank, group.size)

    return walk(params, specs)


def gather_pp_params(params: dict, group: TPGroup, cfg: ModelConfig) -> dict:
    """The full tree from every stage's params (the ``[L, ...]`` stacks
    re-gathered); every stage must call it."""
    return gather_params(params, pp_param_specs(cfg), group)


def _stage_forward(blocks_local, x, cfg: ModelConfig, act_dtype):
    """This stage's layers on ``x [B, S, D]``: the training forward's layer
    body with the dense attention."""
    B, S, _ = x.shape
    rope = model_lib.rope_tables(torch.arange(S, device=x.device),
                                 cfg.head_dim, cfg.rope_theta)
    seq_lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
    for i in range(blocks_local["ln1"].shape[0]):
        x = model_lib.train_layer(
            {name: leaf[i] for name, leaf in blocks_local.items()}, x,
            cfg=cfg, act_dtype=act_dtype, attn_fn=flash_attention_reference,
            rope=rope, seq_lens=seq_lens)
    return x


def _head_loss(h, targets, params, cfg: ModelConfig):
    """The last stage's loss of one microbatch: final norm, float32 logits
    against the (tied) head, mean cross-entropy."""
    h = model_lib.rms_norm(h, params["final_norm"], cfg.rms_eps)
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = f32_matmul(h, w, torch.float32)
    return cross_entropy_loss(logits, targets)


def _backward(kept: list, group: TPGroup, n_micro: int) -> None:
    """Every kept microbatch backward, last first: the last stage from its
    loss, the others from the gradient of their output that the next stage
    sends; each stage but the first sends its input's gradient back."""
    stage, n = group.rank, group.size
    sends = []
    for m in reversed(range(n_micro)):
        x_in, out = kept.pop()
        if stage == n - 1:
            out.backward()
        else:
            out.backward(group.recv(out, stage + 1, tag=n_micro + m))
        if stage > 0:
            sends.append(group.send(x_in.grad, stage - 1, tag=n_micro + m))
        del x_in, out
    for pending in sends:
        pending.wait()


def pp_value_and_grad(params: dict, tokens: torch.Tensor, *,
                      cfg: ModelConfig, group: TPGroup, n_micro: int,
                      act_dtype=torch.float32,
                      grad: bool = True) -> torch.Tensor:
    """The pipeline's loss on ``tokens [B, S + 1]`` (``B % n_micro == 0``),
    the same scalar on every stage; with ``grad``, every param leaf's
    gradient accumulated into its ``.grad`` (a replicated leaf's summed
    over the stages).  Every stage calls it with the same tokens."""
    stage, n = group.rank, group.size
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    B, S = inputs.shape
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by {n_micro} "
                         "microbatches")
    mb = B // n_micro
    tok_mb = inputs.reshape(n_micro, mb, S)
    tgt_mb = targets.reshape(n_micro, mb, S)
    like = torch.empty((mb, S, cfg.d_model), dtype=act_dtype,
                       device=tokens.device)
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    kept, sends = [], []
    with torch.set_grad_enabled(grad):
        for m in range(n_micro):
            if stage == 0:
                x_in = model_lib._scaled_embed(params, tok_mb[m], cfg,
                                               act_dtype)
            else:
                x_in = group.recv(like, stage - 1, tag=m)
                x_in.requires_grad_(grad)
            out = _stage_forward(params["blocks"], x_in, cfg, act_dtype)
            if stage == n - 1:
                out = _head_loss(out, tgt_mb[m], params, cfg) / n_micro
                total = total + out.detach()
            else:
                sends.append(group.send(out.detach(), stage + 1, tag=m))
            if grad:
                kept.append((x_in, out))
            del x_in, out
    for pending in sends:
        pending.wait()
    if grad:
        _backward(kept, group, n_micro)
        replicated = [params[k] for k in sorted(params) if k != "blocks"]
        for p in replicated:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sum_grads_(replicated, group)
    # the last stage's sum, zeros elsewhere: the JAX psum
    return group.all_reduce(total)


def make_pp_loss_fn(cfg: ModelConfig, group: TPGroup, n_micro: int,
                    act_dtype=torch.float32):
    """``loss_fn(params, tokens) -> loss``: the pipeline's forward
    schedule (no gradients; :func:`pp_value_and_grad` gives them), the same
    value on every stage and the single-device ``forward_train`` loss up
    to float32 summation order."""
    def loss_fn(params, tokens):
        return pp_value_and_grad(params, tokens, cfg=cfg, group=group,
                                 n_micro=n_micro, act_dtype=act_dtype,
                                 grad=False)

    return loss_fn


def make_pp_train_step(cfg: ModelConfig, optimizer, group: TPGroup,
                       n_micro: int, act_dtype=torch.float32):
    """``step(params, opt_state, tokens) -> loss``: one pipeline forward
    and backward and one optimizer update of the stage's params in place
    (clipping takes the norm of the whole model's gradients)."""
    dims = list(_leaves(pp_param_specs(cfg)))

    def step(params, opt_state, tokens):
        opt_state.optimizer.zero_grad(set_to_none=True)
        loss = pp_value_and_grad(params, tokens, cfg=cfg, group=group,
                                 n_micro=n_micro, act_dtype=act_dtype)
        optimizer.update(opt_state,
                         lambda leaves: global_grad_norm(leaves, dims, group))
        return loss

    return step


class PPTrainer:
    """One stage's trainer: its params (cut from the full tree ``init``,
    in ``param_dtype`` on the group's device), optimizer state and step.

    Rank 0 calls the public methods, and each first sends the command to
    every other stage (a header and the batch, broadcast over the group);
    the other stages sit in :meth:`follow`, which runs the commands until
    :meth:`stop`.  The same batches thus reach every stage in the same
    order, and the stages meet in each step's messages.
    """

    _STOP, _TRAIN, _EVAL, _GATHER = 0, 1, 2, 3

    def __init__(self, cfg: ModelConfig, group: TPGroup, n_micro: int,
                 tx, init: dict, *, param_dtype=torch.float32,
                 act_dtype=torch.float32, eval_dtype=torch.bfloat16):
        self.cfg, self.group, self.n_micro = cfg, group, n_micro
        self.device = group.device
        self.params = as_trainable(place_pp_params(init, group, cfg),
                                   self.device, param_dtype)
        self.tx = tx
        self.opt_state = tx.init(self.params)
        self._step = make_pp_train_step(cfg, tx, group, n_micro, act_dtype)
        # the validation loss: forward_train's default activations
        self._loss = make_pp_loss_fn(cfg, group, n_micro, eval_dtype)
        self.step_count = 0

    # -- rank 0 -------------------------------------------------------------

    def _order(self, op: int, tokens=None) -> torch.Tensor:
        shape = tuple(tokens.shape) if tokens is not None else (0, 0)
        self.group.broadcast(torch.tensor([op, *shape], dtype=torch.int64))
        if tokens is None:
            return None
        tokens = torch.as_tensor(tokens, dtype=torch.int32)
        return self.group.broadcast(tokens.contiguous()).to(self.device)

    def train_step_async(self, tokens) -> torch.Tensor:
        loss = self._step(self.params, self.opt_state,
                          self._order(self._TRAIN, tokens))
        self.step_count += 1
        return loss

    def train_step(self, tokens) -> float:
        return float(self.train_step_async(tokens))

    @torch.no_grad()
    def eval_loss(self, tokens) -> float:
        return float(self._loss(self.params,
                                self._order(self._EVAL, tokens)))

    def full_params(self) -> dict:
        self._order(self._GATHER)
        return gather_pp_params(self.params, self.group, self.cfg)

    def stop(self) -> None:
        self._order(self._STOP)

    # -- the other stages ---------------------------------------------------

    def follow(self) -> None:
        """Run rank 0's commands until it says stop."""
        while True:
            op, rows, cols = self.group.broadcast(
                torch.zeros(3, dtype=torch.int64)).tolist()
            if op == self._STOP:
                return
            tokens = None
            if rows:
                tokens = self.group.broadcast(torch.zeros(
                    (rows, cols), dtype=torch.int32)).to(self.device)
            if op == self._TRAIN:
                self._step(self.params, self.opt_state, tokens)
                self.step_count += 1
            elif op == self._EVAL:
                with torch.no_grad():
                    self._loss(self.params, tokens)
            elif op == self._GATHER:
                gather_pp_params(self.params, self.group, self.cfg)
            else:
                raise ValueError(f"unknown pipeline command {op}")


def pp_stage_main(rank: int, store_path: str, spec: dict) -> int:
    """A spawned stage of ``train_model.py --pp`` (``RankProcesses``): the
    same params and optimizer as rank 0's (the seed's or the resumed
    checkpoint, float32), its chunk of the layers, then rank 0's commands.
    Returns the steps it ran."""
    from deepvision_tpu_torch.engine.training import train_model_chain
    from deepvision_tpu_torch.engine.weights import init_params, load_npz

    cfg = spec["cfg"]
    if spec["resume"]:
        init = load_npz(spec["resume"], device="cpu")
    else:
        init = init_params(cfg, device="cpu", seed=spec["seed"],
                           dtype=torch.float32)
    if spec["device"] == "cpu":
        torch.set_num_threads(spec.get("threads", 1))
    group = make_pp_mesh(spec["n_stages"], rank=rank, store_path=store_path,
                         device=spec["device"])
    tx = train_model_chain(*spec["chain"])
    trainer = PPTrainer(cfg, group, spec["n_micro"], tx, init)
    del init
    trainer.follow()
    return trainer.step_count
