"""Train and serve steps: the port's counterpart of
`repro.train.step`.

The loss is float32 whatever the model's dtype: the logits are cast for
the per-token logsumexp and gather, as the reference does. No function
here reads a value back to the host: the metrics stay device tensors.

On a mesh (`repro_torch.launch.specs.input_specs`) the parameters,
moments and batch are DTensors: the loss's per-token part runs on each
rank's shard of the logits (`_nll`), and ``grad_specs`` redistributes the
gradients to the parameters' placements before AdamW, the counterpart of
the reference's ``with_sharding_constraint`` on the gradients.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device
from repro_torch.models import spmd
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
    nll = _nll(logits[:, -targets.shape[1]:, :], targets)
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    total = loss
    if "load_balance_loss" in aux:
        total = total + AUX_WEIGHTS["load_balance_loss"] \
            * aux["load_balance_loss"] \
            + AUX_WEIGHTS["router_z_loss"] * aux["router_z_loss"]
    return total, {"ce_loss": loss, **aux}


def _token_nll(logits: torch.Tensor, targets: torch.Tensor
               ) -> torch.Tensor:
    """logsumexp − the target's logit, in float32, per token."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return lse - gold


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood [B, S] of logits [B, S, V]. On
    a mesh each rank takes its shard of the logits as they lie (batch and
    sequence shards kept; a vocab shard on ``model`` kept too, its
    log-sum-exp and target logit merged across the vocab shards by
    DTensor max and sum reductions), so no logits move."""
    if not spmd.is_dtensor(logits):
        return _token_nll(logits, targets)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = logits.device_mesh
    lpl, tpl, vocab = [], [], []
    for i, pl in enumerate(logits.placements):
        if type(pl) is Shard and pl.dim in (0, 1):
            lpl.append(pl)
            tpl.append(pl)
        elif type(pl) is Shard and pl.dim == 2:
            lpl.append(pl)
            tpl.append(Replicate())
            vocab.append(i)
        else:
            lpl.append(Replicate())
            tpl.append(Replicate())
    lg, tg = spmd.local_shards((logits, targets), (lpl, tpl))
    shape = tuple(logits.shape[:2])
    if not vocab:
        return spmd.wrap(_token_nll(lg, tg), mesh, tpl, shape)

    def reduce(local, op):
        pl = [Partial(op) if i in vocab else p for i, p in enumerate(tpl)]
        return spmd.wrap(local, mesh, pl, shape).redistribute(
            mesh, tuple(tpl))

    lg = lg.float()
    lo = spmd.local_range(logits, 2)[0]
    m = reduce(lg.amax(dim=-1).detach(), "max").to_local()
    sum_exp = reduce(torch.exp(lg - m[..., None]).sum(dim=-1), "sum")
    idx = tg.long() - lo
    inside = (idx >= 0) & (idx < lg.shape[-1])
    gold = torch.where(inside, lg.gather(
        -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0],
        torch.zeros_like(m))
    gold = reduce(gold, "sum")
    lse = torch.log(sum_exp.to_local()) + m
    return spmd.wrap(lse, mesh, tpl, shape) - gold


def loss_and_grads(model: Model, params: Params, batch: dict
                   ) -> tuple[torch.Tensor, dict, Params]:
    """`lm_loss` and its gradient in every parameter leaf (zeros for a
    leaf the loss does not reach, as ``jax.grad`` gives), through
    aliases of ``params`` that require grad; ``params`` themselves
    record nothing. Returns (loss, metrics, grads), all detached."""
    alias = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(alias)
    with torch.enable_grad(), spmd.implicit(spmd.on_mesh(leaves[0])):
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


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    grad_specs=None):
    """Returns ``train_step(state, batch) → (state, metrics)``: the loss
    and its gradients (`loss_and_grads`), then `adamw_update`. The step
    updates ``state`` in place (parameters, moments and counts; the
    reference returns a new state) and returns it. The metrics ``loss``,
    ``ce_loss``, the aux losses, ``grad_norm`` and ``lr`` are device
    tensors.

    ``grad_specs`` (a tree of (mesh, placements) like the parameters',
    `repro_torch.launch.sharding.make_shardings`) redistributes each
    DTensor gradient to its parameter's placements before the update, so
    a gradient summed over the batch shards lands in its parameter's
    FSDP shard; plain gradients pass as they are."""
    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        model = Model(cfg, state.params)
        loss, metrics, grads = loss_and_grads(model, state.params, batch)
        on_mesh = spmd.is_dtensor(loss)
        if grad_specs is not None:
            grads = tree_map(_place_grad, grads, grad_specs)
        with spmd.implicit(on_mesh):
            _, _, opt_metrics = adamw_update(opt_cfg, state.params, grads,
                                             state.opt)
            state.step = state.step + 1
        return state, {**metrics, **opt_metrics, "loss": loss}

    return train_step


def _place_grad(grad: torch.Tensor, sharding) -> torch.Tensor:
    if sharding is None or not spmd.is_dtensor(grad):
        return grad
    mesh, placements = sharding
    return spmd.to_placements(grad, placements)


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
