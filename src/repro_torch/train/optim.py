"""AdamW with decoupled weight decay, a cosine schedule and global-norm
clipping, on dicts of tensors: the port's counterpart of
`repro.train.optim`.

A plain function on tensors, not ``torch.optim.AdamW``: the reference's
update is what is ported, with its moments in ``moment_dtype`` (bfloat16
keeps m and v at half the bytes), its schedule and bias corrections in
float32, and its metrics. `adamw_update` writes the new parameters and
moments into the tensors it is given (the reference returns new
pytrees), so a step needs no second copy of the train state; its metrics
stay on the device.

Trees are nested dicts whose leaves are tensors; `tree_leaves` walks them
in sorted key order, the order of ``jax.tree.leaves``, so sums over the
leaves add in the reference's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"


def tree_leaves(tree: Tree) -> list:
    """The leaves of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in
                tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (dicts of the same keys), as a dict of the same keys."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


def adamw_init(cfg: AdamWConfig, params: Tree) -> dict:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, and
    the step count, an int32 scalar on the parameters' device."""
    mdt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor), in float32: a
    linear warmup, then a cosine from ``lr`` to ``min_lr_ratio·lr``."""
    warm = torch.clamp_max(step.float() / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps).float()
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(tree: Tree) -> torch.Tensor:
    """√(Σ over the leaves of Σ x²), each leaf in float32, the leaves
    added in sorted key order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: dict) -> tuple[Tree, dict, dict]:
    """One AdamW step, in place: the gradients clipped to global norm
    ``grad_clip``, the moments updated and bias-corrected in float32,
    and each parameter moved by ``lr·(m̂/(√v̂+ε) + wd·p)``. Writes the
    parameters, the moments (rounded to their dtype) and the step count
    into ``params`` and ``state`` and returns them with the metrics
    ``{"grad_norm", "lr"}``, float32 tensors on the device (no host
    read)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp_max(gnorm.new_tensor(cfg.grad_clip)
                           / torch.clamp_min(gnorm, 1e-12), 1.0)
    lr = _schedule(cfg, step)
    bc1 = 1.0 - cfg.beta1 ** step.float()
    bc2 = 1.0 - cfg.beta2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"]),
                          strict=True):
        g = g.float() * clip
        m32 = cfg.beta1 * m.float() + (1 - cfg.beta1) * g
        v32 = cfg.beta2 * v.float() + (1 - cfg.beta2) * g * g
        p32 = p.float()
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
