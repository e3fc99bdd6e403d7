"""Sharding rules: the port's counterpart of `repro.launch.sharding`.

Every parameter, optimizer, batch and cache tensor gets a
`PartitionSpec` on the production mesh, and `placements` turns a spec
into the DTensor placements of a `DeviceMesh`.

Logical axes:
  fsdp — parameter shards over the data(-parallel) axes (pod, data),
         ZeRO-3 style;
  tp   — tensor parallel over the ``model`` axis: attention heads (flat
         head·dim), FFN hidden, vocab, the MoE expert dim, SSM/RWKV inner
         dims;
  dp   — batch over (pod, data).

Divisibility fallback: a dim that its mesh axes do not divide is
replicated (smollm's 9 heads on a 16-way model axis), and DTensor's
redistributions supply the collectives.

A spec here is a `PartitionSpec`: a tuple with an entry per leading
tensor dim (missing trailing entries replicate), each entry None, an axis
name, or a tuple of axis names (a dim sharded over several axes, in mesh
order). The specs equal the reference's entry for entry.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.launch.mesh import mesh_axes

Tree = Any


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of axis
    names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec

# per-parameter logical axes of the trailing dims (a leading group-stack
# axis is prepended for the "slot{i}" parameters); the reference's table
_PARAM_RULES: dict[str, tuple[str | None, ...]] = {
    "embed": ("tp", "fsdp"),
    "lm_head": ("fsdp", "tp"),
    "final_norm": (None,),
    # attention
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    # dense ffn
    "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    "b_up": ("tp",), "b_down": (None,),
    # moe
    "router": ("fsdp", None),
    "moe_gate": ("tp", "fsdp", None), "moe_up": ("tp", "fsdp", None),
    "moe_down": ("tp", None, "fsdp"),
    "sh_gate": ("fsdp", "tp"), "sh_up": ("fsdp", "tp"),
    "sh_down": ("tp", "fsdp"),
    # mamba
    "in_x": ("fsdp", "tp"), "in_z": ("fsdp", "tp"), "out": ("tp", "fsdp"),
    "conv_w": (None, "tp"),
    "dt_down": ("tp", None), "dt_up": (None, "tp"),
    "dt_bias": ("tp",), "d_skip": ("tp",),
    "w_b": ("tp", None), "w_c": ("tp", None), "a_log": ("tp", None),
    # rwkv
    "wr": ("fsdp", "tp"), "wk_t": ("fsdp", "tp"), "wv_t": ("fsdp", "tp"),
    "wg": ("fsdp", "tp"),
    "wa": ("fsdp", None), "wb": (None, "tp"),
    "w0": (None,), "u": ("tp", None), "gn": (None,),
    "mu_r": (None,), "mu_k": (None,), "mu_v": (None,), "mu_w": (None,),
    "mu_g": (None,), "mu_c": (None,),
    "cm_r": ("fsdp", "tp"), "cm_k": ("fsdp", "tp"), "cm_v": ("tp", "fsdp"),
    # norms
    "norm_mix": (None,), "norm_ffn": (None,),
}
POLICIES = ("tp", "dp", "serve")


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, keys in the tree's order."""
    if isinstance(tree, dict):
        return {key: _map_with_path(fn, value, path + (key,))
                for key, value in tree.items()}
    return fn(path, tree)


class ShardingRules:
    """policy:
      "tp"    — FSDP over (pod, data) and tensor parallel over model;
      "dp"    — pure data parallelism: the model axis joins the batch
                axes and weights replicate over it (FSDP still over
                (pod, data));
      "serve" — inference: parameters shard over ``model`` only (no FSDP).

    ``mesh`` is a `DeviceMesh` or an `AbstractMesh`
    (`repro_torch.launch.mesh`)."""

    def __init__(self, mesh, policy: str = "tp"):
        if policy not in POLICIES:
            raise ValueError(f"ShardingRules: unknown policy {policy!r}; "
                             f"expected one of {POLICIES}")
        self.mesh = mesh
        self.policy = policy
        self.axes = mesh_axes(mesh)
        names = tuple(self.axes)
        dp = [a for a in ("pod", "data") if a in names]
        if policy == "dp" and "model" in names:
            dp.append("model")
            self.tp_axis = None
        else:
            self.tp_axis = "model" if "model" in names else None
        self.dp_axes = tuple(dp)
        self.fsdp_axes = () if policy == "serve" else tuple(
            a for a in ("pod", "data") if a in names)
        self.dp_size = math.prod(self.axes[a] for a in self.dp_axes)
        self.fsdp_size = math.prod(self.axes[a] for a in self.fsdp_axes)
        self.tp_size = self.axes[self.tp_axis] if self.tp_axis else 1

    def with_policy(self, policy: str) -> "ShardingRules":
        return ShardingRules(self.mesh, policy=policy)

    # ---- helpers -----------------------------------------------------------
    def _resolve(self, logical: str | None, dim: int):
        if logical is None:
            return None
        if logical == "fsdp":
            if self.fsdp_axes and dim % self.fsdp_size == 0:
                return self.fsdp_axes if len(self.fsdp_axes) > 1 \
                    else self.fsdp_axes[0]
            return None
        if logical == "tp":
            if self.tp_axis and dim % self.tp_size == 0:
                return self.tp_axis
            return None
        raise ValueError(logical)

    def spec_for(self, rule: tuple, shape: tuple, stacked: bool) -> P:
        trailing = tuple(shape[1:]) if stacked else tuple(shape)
        if len(rule) != len(trailing):
            raise ValueError(f"rule {rule} does not fit shape {shape}")
        axes = [self._resolve(r, d) for r, d in zip(rule, trailing)]
        return P(*([None] + axes if stacked else axes))

    # ---- params / optimizer ------------------------------------------------
    def params_specs(self, params_shape: Tree) -> Tree:
        """A spec per parameter leaf (anything with ``.shape``): by its
        name's rule, the group-stack axis first for ``slot{i}`` leaves;
        an unknown name, or a rule that does not fit, replicates."""
        def leaf_spec(path, leaf):
            stacked = str(path[0]).startswith("slot")
            shape = tuple(leaf.shape)
            rule = _PARAM_RULES.get(path[-1])
            if rule is None or len(rule) != len(
                    shape[1:] if stacked else shape):
                return P()
            return self.spec_for(rule, shape, stacked)

        return _map_with_path(leaf_spec, params_shape)

    def opt_specs(self, opt_shape: Tree, params_specs_tree: Tree) -> dict:
        return {"m": params_specs_tree, "v": params_specs_tree, "step": P()}

    # ---- activations / batches ---------------------------------------------
    def dp_spec(self):
        if not self.dp_axes:
            return None
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    def batch_specs(self, batch_shape: dict, global_batch: int) -> dict:
        dp = self.dp_spec() if global_batch % self.dp_size == 0 else None
        out = {}
        for key, value in batch_shape.items():
            ndim = len(value.shape)
            if ndim == 2:
                out[key] = P(dp, None)
            elif ndim == 3:                       # embeds [B, S, d]
                out[key] = P(dp, None, None)
            else:
                out[key] = P()
        return out

    # ---- decode cache ------------------------------------------------------
    def cache_specs(self, cache_shape: Tree, batch: int) -> Tree:
        """KV caches [g, B, S, K, dh], states [g, B, ...]. The batch goes
        to dp when it divides; otherwise the sequence or inner dim is
        sharded (context parallelism at B 1)."""
        dp = self.dp_spec()
        batch_on_dp = dp is not None and batch % self.dp_size == 0
        tp_axis, tp_size = self.tp_axis, self.tp_size

        def leaf_spec(path, leaf):
            name, shape = path[-1], tuple(leaf.shape)
            if name in ("k", "v"):                     # [g, B, S, K, dh]
                kv_heads, seq = shape[3], shape[2]
                tp = tp_axis if (tp_axis and kv_heads % tp_size == 0) \
                    else None
                if batch_on_dp:
                    # kv heads the model axis does not divide: the cache's
                    # sequence dim takes it instead
                    seq_tp = (tp_axis if (tp is None and tp_axis
                                          and seq % tp_size == 0) else None)
                    return P(None, dp, seq_tp, tp, None)
                seq_dp = dp if (dp and seq % self.dp_size == 0) else None
                return P(None, None, seq_dp, tp, None)
            if name in ("k_scale", "v_scale"):         # [g, B, S, K]
                seq = shape[2]
                if batch_on_dp:
                    seq_tp = (tp_axis if (tp_axis and seq % tp_size == 0)
                              else None)
                    kv_tp = tp_axis if shape[3] % tp_size == 0 else None
                    return P(None, dp, None if kv_tp else seq_tp, kv_tp)
                seq_dp = dp if (dp and seq % self.dp_size == 0) else None
                return P(None, None, seq_dp, None)
            if name == "pos":                          # [g, W]
                return P(None, None)
            bdp = dp if batch_on_dp else None
            if name == "state" and len(shape) == 5:    # rwkv [g,B,H,dh,dh]
                tp = tp_axis if shape[2] % tp_size == 0 else None
                return P(None, bdp, tp, None, None)
            if name == "state":                        # mamba [g,B,di,N]
                tp = tp_axis if shape[2] % tp_size == 0 else None
                return P(None, bdp, tp, None)
            if name == "conv":                         # [g, B, K-1, di]
                tp = tp_axis if shape[3] % tp_size == 0 else None
                return P(None, bdp, None, tp)
            if name in ("shift_t", "shift_c"):         # [g, B, d]
                return P(None, bdp, None)
            return P()

        return _map_with_path(leaf_spec, cache_shape)


def placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim d whose entry names that axis, else
    ``Replicate()``. A dim sharded over ("pod", "data") is ``Shard(d)``
    on both mesh dims, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    owner: dict[str, int] = {}
    for dim, entry in enumerate(spec or ()):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for name in names:
            if name in owner:
                raise ValueError(f"placements: axis {name!r} shards dims "
                                 f"{owner[name]} and {dim} of {spec}")
            owner[name] = dim
    axes = tuple(mesh_axes(mesh))
    unknown = set(owner) - set(axes)
    if unknown:
        raise ValueError(f"placements: {spec} names axes {sorted(unknown)} "
                         f"the mesh {axes} lacks")
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in axes)


def make_shardings(rules: ShardingRules, spec_tree: Tree) -> Tree:
    """The tree of (mesh, placements) of a tree of specs."""
    def walk(node):
        if isinstance(node, PartitionSpec):
            return rules.mesh, placements(node, rules.mesh)
        if isinstance(node, dict):
            return {key: walk(value) for key, value in node.items()}
        raise TypeError(f"make_shardings: {type(node)} is not a spec")

    return walk(spec_tree)


def distribute(tree: Tree, shardings: Tree) -> Tree:
    """Each tensor of ``tree`` as a DTensor with the (mesh, placements)
    of ``shardings`` (`make_shardings`), sliced from the whole tensor
    every rank holds; a leaf whose sharding is None stays as it is."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {key: distribute(value, shardings[key])
                for key, value in tree.items()}
    if shardings is None:
        return tree
    mesh, place = shardings
    out = distribute_tensor(tree, mesh, list(place))
    local = out.to_local()
    if local.untyped_storage().nbytes() != local.numel() \
            * local.element_size():
        # a view into the whole tensor: give the shard storage of its own,
        # so the whole tensor is freed and the shard's bytes are its own
        out = type(out).from_local(
            local.clone(memory_format=torch.contiguous_format), mesh,
            list(place), run_check=False, shape=out.shape,
            stride=out.stride())
    return out
