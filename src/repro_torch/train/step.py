"""train_step: next-token loss + AdamW (port of ``repro/train/step.py``).

* layers run under ``torch.utils.checkpoint`` when ``remat`` (activation
  memory bounded to about one layer's input a layer),
* the LM head + cross entropy run seq-chunked, each chunk checkpointed, so
  the [B, S, V] logits never exist whole (float32 logits and logsumexp a
  chunk at a time),
* gradients by ``torch.autograd.grad`` (the reference's
  ``jax.value_and_grad``), then global-norm clipping and AdamW, both in
  place on the state's tensors (the reference's jitted step donates them).

The objective keeps the reference's double shift: the data pipeline yields
``targets`` = ``tokens`` shifted by one, and the loss shifts once more
(``hidden[:, :-1]`` against ``targets[:, 1:]``), so under the driver the
hidden state at position i is trained to predict token i + 2.  Called as
the reference's tests call it (``targets = tokens``), it is the usual
next-token loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.state import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import params_from_numpy
from repro_torch.optim import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm_,
    cosine_schedule,
)
from repro_torch.pytree import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    opt: AdamWState


def train_state_init(rng, cfg: ModelConfig, param_dtype=torch.float32, *,
                     device=None) -> TrainState:
    """Parameters drawn by ``transformer.init_params`` from ``rng`` (a
    ``torch.Generator``, on its device, or an int seed: on the card unless
    ``device`` names another) and a zeroed optimizer state beside them."""
    params = transformer.init_params(rng, cfg, param_dtype, device=device)
    return TrainState(params=params, opt=adamw_init(params))


def train_state_from_numpy(state, device=None) -> TrainState:
    """The reference's ``TrainState`` with numpy leaves (``jax.tree.map(
    np.asarray, state)``) as the port's, on the card unless ``device`` names
    another; bfloat16 leaves cross as their bit patterns."""
    dev = resolve_device(device)
    return TrainState(
        params=params_from_numpy(state.params, dev),
        opt=AdamWState(
            step=torch.tensor(np.asarray(state.opt.step), dtype=torch.int32, device=dev),
            m=params_from_numpy(state.opt.m, dev),
            v=params_from_numpy(state.opt.v, dev),
        ),
    )


def _chunk_nll(xc, head, tc, mc):
    logits = (xc @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return torch.sum((lse - tgt) * mc), torch.sum(mc)


def chunked_lm_loss(x, head, targets, mask, *, chunk: int = 512):
    """Cross entropy over seq chunks; logits stay [B, chunk, V].  Whole
    chunks first, then the remainder as one more chunk, as the reference
    maps and then adds the tail."""
    B, S, D = x.shape
    chunk = min(chunk, S)
    n = S // chunk
    rem = S - n * chunk

    def one(lo, ln):
        return checkpoint(_chunk_nll, x[:, lo:lo + ln], head, targets[:, lo:lo + ln],
                          mask[:, lo:lo + ln], use_reentrant=False, preserve_rng_state=False)

    tot, cnt = 0.0, 0.0
    if n:
        parts = [one(i * chunk, chunk) for i in range(n)]
        tot = torch.sum(torch.stack([p[0] for p in parts]))
        cnt = torch.sum(torch.stack([p[1] for p in parts]))
    if rem:
        t2, c2 = one(n * chunk, rem)
        tot, cnt = tot + t2, cnt + c2
    return tot / torch.clamp(cnt, min=1.0)


def make_loss_fn(
    cfg: ModelConfig,
    *,
    remat: bool = True,
    loss_chunk: int = 512,
    layer_loop: str = "scan",
    act_spec=None,
):
    transformer.check_act_spec(act_spec)

    def loss_fn(params, batch):
        compute = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        hidden = transformer.forward_hidden(
            params,
            cfg,
            batch["tokens"],
            batch.get("prefix_embeds"),
            remat=remat,
            layer_loop=layer_loop,
            act_spec=act_spec,
        )
        head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"]).to(compute)
        targets = batch["targets"]
        St = targets.shape[1]
        text_hidden = hidden[:, -St:, :]
        # next-token objective: position i predicts target i+1
        mask = torch.ones(targets[:, 1:].shape, dtype=torch.float32, device=targets.device)
        return chunked_lm_loss(
            text_hidden[:, :-1], head, targets[:, 1:], mask, chunk=loss_chunk
        )

    return loss_fn


def make_train_step(
    cfg: ModelConfig,
    *,
    lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
    max_grad_norm: float = 1.0,
    remat: bool = True,
    loss_chunk: int = 512,
    layer_loop: str = "scan",
    act_spec=None,
):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm", "step"})``.
    The step writes the state's parameter and moment tensors in place and
    returns a state holding them; the metrics are 0-d device tensors, so
    the step never waits on the host."""
    loss_fn = make_loss_fn(
        cfg,
        remat=remat,
        loss_chunk=loss_chunk,
        layer_loop=layer_loop,
        act_spec=act_spec,
    )
    schedule = cosine_schedule(lr, warmup, total_steps)

    def train_step(state: TrainState, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(state.params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(state.params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        gnorm = clip_by_global_norm_(grads, max_grad_norm)
        new_params, new_opt = adamw_update(
            state.params, tree_unflatten(state.params, grads), state.opt, schedule
        )
        metrics = {"loss": loss.detach(), "grad_norm": gnorm, "step": new_opt.step}
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step
