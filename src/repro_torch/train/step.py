"""Train and serve steps: the port's counterpart of
`repro.train.step`.

The loss is float32 whatever the model's dtype: the logits are cast for
the per-token logsumexp and gather, as the reference does. No function
here reads a value back to the host: the metrics stay device tensors.

The reference's ``grad_specs`` (a GSPMD pin of the gradients to the
parameters' sharding) has no meaning on one card; it belongs to the
mesh launcher (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device
from repro_torch.models.model import Model, ModelConfig, Params, init_params
from repro_torch.train.optim import (AdamWConfig, adamw_init, adamw_update,
                                     tree_leaves, tree_map)

AUX_WEIGHTS = {"load_balance_loss": 0.01, "router_z_loss": 0.001}


@dataclasses.dataclass
class TrainState:
    params: Params
    opt: dict
    step: torch.Tensor


def train_state_init(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     generator: torch.Generator, *,
                     device=None) -> TrainState:
    """Parameters drawn by `init_params` on ``generator`` (whose device
    must be the state's: the card unless the caller names another), zero
    moments and step 0."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"the generator draws on {generator.device}, the "
                         f"train state is to live on {device}")
    params = init_params(cfg, generator)
    return TrainState(params=params, opt=adamw_init(opt_cfg, params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=generator.device))


def lm_loss(model: Model, params: Params, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """batch: tokens [B, S] (optional), embeds [B, S_e, d] (optional),
    targets [B, S_t], loss_mask [B, S_t] (optional). The targets align
    with the LAST S_t positions of the sequence (the text tail for a VLM,
    the whole sequence for an LM or an audio encoder). Returns the mean
    masked cross-entropy, plus 0.01·load-balance and 0.001·router-z
    losses when the model has an MoE slot, and the metrics ``ce_loss``
    and the aux losses."""
    logits, aux = model.forward(batch.get("tokens"), batch.get("embeds"),
                                params=params)
    targets = batch["targets"]
    logits = logits[:, -targets.shape[1]:, :].float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    total = loss
    if "load_balance_loss" in aux:
        total = total + AUX_WEIGHTS["load_balance_loss"] \
            * aux["load_balance_loss"] \
            + AUX_WEIGHTS["router_z_loss"] * aux["router_z_loss"]
    return total, {"ce_loss": loss, **aux}


def loss_and_grads(model: Model, params: Params, batch: dict
                   ) -> tuple[torch.Tensor, dict, Params]:
    """`lm_loss` and its gradient in every parameter leaf (zeros for a
    leaf the loss does not reach, as ``jax.grad`` gives), through
    aliases of ``params`` that require grad; ``params`` themselves
    record nothing. Returns (loss, metrics, grads), all detached."""
    alias = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(alias)
    with torch.enable_grad():
        loss, metrics = lm_loss(model, alias, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads)])
    # tree_leaves walks sorted keys: rebuild the tree in that order
    grad_tree = _unflatten(alias, grads)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        grad_tree


def _unflatten(tree, leaves):
    if isinstance(tree, dict):
        return {key: _unflatten(tree[key], leaves) for key in sorted(tree)}
    return next(leaves)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """Returns ``train_step(state, batch) → (state, metrics)``: the loss
    and its gradients (`loss_and_grads`), then `adamw_update`. The step
    updates ``state`` in place (parameters, moments and counts; the
    reference returns a new state) and returns it. The metrics ``loss``,
    ``ce_loss``, the aux losses, ``grad_norm`` and ``lr`` are device
    tensors."""
    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        model = Model(cfg, state.params)
        loss, metrics, grads = loss_and_grads(model, state.params, batch)
        _, _, opt_metrics = adamw_update(opt_cfg, state.params, grads,
                                         state.opt)
        state.step = state.step + 1
        return state, {**metrics, **opt_metrics, "loss": loss}

    return train_step


def make_serve_step(cfg: ModelConfig):
    """Returns ``serve_step(params, cache, tokens [B, 1], pos, *,
    backend="cuda") → (logits [B, V], cache)``: ONE new token against
    the cache, through `Model.decode_step` (the cache updated in
    place)."""
    def serve_step(params: Params, cache: dict, tokens: torch.Tensor,
                   pos: int, *, backend: str = "cuda"):
        return Model(cfg, params).decode_step(cache, tokens, pos,
                                              backend=backend)

    return serve_step


def make_prefill(cfg: ModelConfig):
    """Returns ``prefill(params, batch) → logits``: the full-sequence
    forward on the batch's tokens and/or embeds, recording no
    gradient."""
    def prefill(params: Params, batch: dict) -> torch.Tensor:
        with torch.no_grad():
            logits, _ = Model(cfg, params).forward(
                batch.get("tokens"), batch.get("embeds"))
        return logits

    return prefill
