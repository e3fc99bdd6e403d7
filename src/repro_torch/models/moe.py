"""Mixture of experts with grouped, sort-based capacity dispatch: the
port's counterpart of `repro.models.moe`.

Covers deepseek-moe-16b (64 routed experts top-6 + 2 shared), phi3.5-moe
and jamba-1.5-large (16 experts top-2). The tokens [T, d] split into
``groups`` dispatch groups of T/G; in each group:

1. router softmax, top-k, the k weights renormalised (floor 1e-9);
2. the (token, choice) pairs stably sorted by expert, each pair's rank
   within its expert, pairs at rank ≥ capacity dropped (the drop bin
   ``e``);
3. the kept tokens written to an [E, C, d] buffer, a dense SwiGLU per
   expert over all of its C capacity rows (as the reference computes
   it: every expert's weights are read, whatever the routing);
4. each pair's output gathered back, weighted, and summed over the
   token's k choices.

Shared experts (DeepSeek) add a dense SwiGLU over every token. Aux
losses: the switch load-balance loss and the router z-loss.

On the card nothing here reads a value back to the host, and the result
does not depend on the order of atomics: the capacity rows are written
by a plain indexed write (kept slots are unique, dropped pairs all write
zeros to the drop bin), and the combine gathers each token's k outputs
through the inverse of the sort and sums them in a fixed order, where
the reference scatter-adds. Top-k is a stable descending sort, so ties
go to the lower expert as in ``jax.lax.top_k``.

On a mesh (DTensor tokens; ``shard`` = the (data axes, model axis) of
``cfg.moe_shard``) each rank dispatches its own tokens, one dispatch
group per data shard as in the reference, and runs the SwiGLU of its own
slice of the experts (expert parallelism over ``model``, the weights'
FSDP shards gathered); the combine adds its experts' share of each
token's output, and the shares are summed over ``model`` (a DTensor
partial sum). The aux losses' statistics are averaged over the data
shards.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import spmd


@dataclasses.dataclass(frozen=True)
class MoEDims:
    num_experts: int
    experts_per_token: int
    d_model: int
    d_ff: int                     # per (routed) expert
    num_shared_experts: int = 0
    capacity_factor: float = 1.25


def moe_capacity(dims: MoEDims, tokens_per_group: int) -> int:
    """Rows per expert per group: ⌊T_g·k/E·factor⌋ + 1 rounded up to 8,
    at most T_g·k and at least 8 (static shapes: a Python int)."""
    cap = tokens_per_group * dims.experts_per_token / dims.num_experts
    cap = int(cap * dims.capacity_factor) + 1
    cap = min(-(-cap // 8) * 8,
              tokens_per_group * dims.experts_per_token)
    return max(cap, 8)


def _swiglu_experts(xe: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor
                    ) -> torch.Tensor:
    """Per-expert SwiGLU: xe [G, E, C, d] → [G, E, C, d]."""
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, w_gate))
    h = h * torch.einsum("gecd,edf->gecf", xe, w_up)
    return torch.einsum("gecf,efd->gecd", h, w_down)


def moe_forward(x: torch.Tensor, router_w: torch.Tensor,
                w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, dims: MoEDims, *,
                shared_w_gate: torch.Tensor | None = None,
                shared_w_up: torch.Tensor | None = None,
                shared_w_down: torch.Tensor | None = None,
                groups: int = 1, shard: tuple | None = None
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """x [T, d] flattened tokens, router [d, E], experts [E, d, f] /
    [E, f, d], shared experts [d, f_s] / [f_s, d]. Returns (output
    [T, d], {"load_balance_loss", "router_z_loss"}). ``groups`` falls
    back to 1 when it does not divide T, as in the reference."""
    t = x.shape[0]
    e, k = dims.num_experts, dims.experts_per_token
    g = groups if t % groups == 0 else 1
    if spmd.is_dtensor(x):
        out, probs_mean, counts, z_sq = _moe_on_mesh(
            x, router_w, w_gate, w_up, w_down, dims, g, shard)
    else:
        out, probs, counts, z_sq = _moe_local(x, router_w, w_gate, w_up,
                                              w_down, dims, g, 0, e)
        probs_mean = probs.mean(dim=(0, 1))
        counts = counts.sum(0)
        z_sq = z_sq.mean()

    if shared_w_gate is not None:
        sh = F.silu(x @ shared_w_gate) * (x @ shared_w_up)
        out = out + sh @ shared_w_down

    ce = counts.float() / (t * k)
    load_balance = e * torch.sum(probs_mean * ce)
    return out, {"load_balance_loss": load_balance, "router_z_loss": z_sq}


def _moe_local(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor, w_down: torch.Tensor, dims: MoEDims,
               g: int, e0: int, e_loc: int):
    """Dispatch of x [T, d] in ``g`` groups over all E experts, and the
    SwiGLU and combine of experts [e0, e0 + e_loc) (w_* hold those
    experts only). Returns (out [T, d]: those experts' share of each
    token's output, probs [G, Tg, E], counts [G, E], z² [G])."""
    t, d = x.shape
    e, k = dims.num_experts, dims.experts_per_token
    tg = t // g
    cap = moe_capacity(dims, tg)
    dev = x.device
    xg = x.reshape(g, tg, d)

    logits = (xg @ router_w).float()                         # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    sorted_p, sorted_e = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    top_p, top_e = sorted_p[..., :k], sorted_e[..., :k]      # [G, Tg, k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    flat_e = top_e.reshape(g, tg * k)
    flat_p = top_p.reshape(g, tg * k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices  # [G, Tg·k]
    s_e = flat_e.gather(1, order)
    s_p = flat_p.gather(1, order)
    s_t = torch.div(order, k, rounding_mode="floor")         # token of pair
    counts = torch.zeros((g, e), dtype=torch.long, device=dev) \
        .scatter_add_(1, s_e, torch.ones_like(s_e))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(tg * k, device=dev)[None, :] - starts.gather(1, s_e)
    keep = rank < cap
    slot_e = torch.where(keep, s_e, e)                       # e = drop bin
    slot_r = torch.where(keep, rank, 0)

    rows = (slot_e * cap + slot_r)[..., None].expand(-1, -1, d)
    xs = xg.gather(1, s_t[..., None].expand(-1, -1, d))
    buf = torch.zeros((g, (e + 1) * cap, d), dtype=x.dtype, device=dev)
    buf.scatter_(1, rows, torch.where(keep[..., None], xs,
                                      torch.zeros_like(xs)))
    expert_in = buf[:, e0 * cap:(e0 + e_loc) * cap].reshape(g, e_loc, cap, d)
    expert_out = _swiglu_experts(expert_in, w_gate, w_up, w_down)

    # pairs routed to this slice of the experts (all kept pairs when the
    # slice is every expert: the drop bin e lies outside it)
    local_e = slot_e - e0
    mine = keep & (local_e >= 0) & (local_e < e_loc)
    back = (torch.clamp(local_e, 0, e_loc - 1) * cap + slot_r)[..., None] \
        .expand(-1, -1, d)
    gathered = expert_out.reshape(g, e_loc * cap, d).gather(1, back)
    weighted = torch.where(mine[..., None], gathered,
                           torch.zeros_like(gathered)) \
        * s_p[..., None].to(expert_out.dtype)
    inverse = torch.empty_like(order).scatter_(
        1, order, torch.arange(tg * k, device=dev).expand(g, -1))
    per_choice = weighted.gather(1, inverse[..., None].expand(-1, -1, d))
    out = per_choice.reshape(g, tg, k, d).sum(dim=2).reshape(t, d)
    z_sq = (torch.logsumexp(logits, dim=-1) ** 2).mean(dim=-1)   # [G]
    return out, probs, counts, z_sq


def _moe_on_mesh(x, router_w, w_gate, w_up, w_down, dims: MoEDims, g: int,
                 shard: tuple | None):
    """`_moe_local` on each rank's tokens and experts (module docstring).
    Returns (out [T, d] DTensor in the tokens' layout, the mean router
    probabilities [E], the expert counts [E], the mean z² ), the last
    three summed or averaged over the data shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    t = x.shape[0]
    e = dims.num_experts
    dp_names = spmd._names(shard[0]) if shard else ()
    tp_name = shard[1] if shard else "model"
    dp_dims = [i for i, n in enumerate(names) if n in dp_names]
    dp_size = spmd.prod_sizes(mesh, dp_dims)
    if not dp_dims or g % dp_size or t % dp_size:
        dp_dims, dp_size = [], 1             # one group over all tokens
    tp_dim = names.index(tp_name) if tp_name in names else None
    if tp_dim is not None and (tp_dim in dp_dims or e % mesh.size(tp_dim)):
        tp_dim = None
    e_loc = e // (mesh.size(tp_dim) if tp_dim is not None else 1)
    e0 = mesh.get_coordinate()[tp_dim] * e_loc if tp_dim is not None else 0

    x_pl = tuple(Shard(0) if i in dp_dims else Replicate()
                 for i in range(len(names)))
    w_pl = tuple(Shard(0) if i == tp_dim else Replicate()
                 for i in range(len(names)))
    rep = (Replicate(),) * len(names)
    xl, rl, gl, ul, dl = spmd.local_shards(
        (x, router_w, w_gate, w_up, w_down), (x_pl, rep, w_pl, w_pl, w_pl))
    out, probs, counts, z_sq = _moe_local(xl, rl, gl, ul, dl, dims,
                                          g // dp_size, e0, e_loc)

    def over_dp(local, op, shape):
        pl = [Partial(op) if i in dp_dims else Replicate()
              for i in range(len(names))]
        return spmd.wrap(local, mesh, pl, shape).redistribute(mesh, rep)

    out_pl = [Partial("sum") if i == tp_dim else p
              for i, p in enumerate(x_pl)]
    out = spmd.wrap(out, mesh, out_pl, tuple(x.shape)) \
        .redistribute(mesh, x_pl)
    probs_mean = over_dp(probs.mean(dim=(0, 1)), "avg", (e,))
    counts = over_dp(counts.sum(0), "sum", (e,))
    z_sq = over_dp(z_sq.mean(), "avg", ())
    return out, probs_mean, counts, z_sq
