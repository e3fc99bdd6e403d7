"""Per-device costs of a step on a mesh: the port's counterpart of
`repro.launch.hlo_analysis`.

The reference compiles a pair and reads its costs from the partitioned
HLO text. Torch has no HLO: `CostMode` is a ``TorchDispatchMode`` that
watches the step run once, op by op, on each rank's local shards (under
``FakeTensorMode`` in the dry run, so nothing runs and nothing is
allocated). What replaces each of the reference's counts:

  flops            dot FLOPs 2·|result|·|contracted| of mm, bmm, addmm,
                   baddbmm and attention (``torch.utils.flop_counter``'s
                   formulas); |result| per arithmetic elementwise op and
                   per transcendental; |operand| per reduction. All on the
                   local shards, so the counts are per device. The port
                   runs its layers in a Python loop at full depth, so there
                   is no loop whose trips need recovering: ``num_whiles``
                   and ``unknown_trip_counts`` are 0.
  transcendentals  |result| of exp, log, tanh, rsqrt, sqrt, cos, sin,
                   sigmoid (and silu), erf, expm1 and log1p.
  collectives      result bytes of each ``_c10d_functional`` op that a
                   DTensor redistribution issues, by the reference's five
                   kinds (all-gather, all-reduce, reduce-scatter,
                   all-to-all, collective-permute; nothing the port runs
                   issues the last). On a CPU mesh (the dry run's fake
                   group) DTensor turns an all-to-all into an all-gather
                   and a local chunk, and the count follows what it issues.
  bytes            the reference's fusion-boundary HBM model has no
                   counterpart in eager torch: operand plus result bytes of
                   every aten op that is not a view, an unfused upper
                   bound (``bytes_model: "unfused"`` in the dry run's JSON).
  top lists        the reference's ``top_collectives`` and
                   ``top_memory_ops``: bytes × count aggregated per
                   (collective kind or aten op, local result shape),
                   largest first, cut to `TOP_ENTRIES`. The count is how
                   many times the op ran (the reference's trip-count
                   multiplier).
  peak memory      the high-water mark of live storage bytes on the local
                   shards over the step: the arguments' shards (parameters,
                   optimizer state, inputs, cache) at the start, then every
                   storage an op creates until it is freed. The port's own
                   accounting (weak references to storages), not
                   ``torch.distributed._tools.mem_tracker``.

Ops that DTensor runs to infer shapes while it propagates shardings are
left out: they are no work of the step.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.launch.mesh import (HBM_BANDWIDTH, LINK_BANDWIDTH,
                                     PEAK_FLOPS_BF16)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "where", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "clamp", "clamp_min",
    "clamp_max", "remainder", "fmod", "pow", "floor", "ceil", "round",
    "trunc", "sign", "reciprocal", "square", "masked_fill", "lerp",
    "addcmul", "addcdiv", "floor_divide",
}
# transcendental ops: (transcendentals, flops) a result element
_TRANSCENDENTAL = {
    "exp": (1, 1), "exp2": (1, 1), "log": (1, 1), "log2": (1, 1),
    "tanh": (1, 1), "rsqrt": (1, 1), "sqrt": (1, 1), "cos": (1, 1),
    "sin": (1, 1), "sigmoid": (1, 1), "erf": (1, 1), "expm1": (1, 1),
    "log1p": (1, 1), "atan2": (1, 1), "silu": (1, 2), "softplus": (2, 3),
    "gelu": (1, 8),
}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "var", "std", "norm", "cumsum", "argmax",
               "argmin", "any", "all", "_softmax", "_log_softmax"}
# ops that move no data of their own (allocation without a write, device
# queries, waits on a collective already counted)
_NO_BYTES = {"empty", "empty_strided", "empty_like", "device", "wait_tensor",
             "detach", "lift_fresh", "_local_scalar_dense"}
_PROPAGATION_FILES = ("_sharding_prop.py", "_op_schema.py")
TOP_ENTRIES = 40
_DTYPE_NAMES = {torch.float32: "f32", torch.float64: "f64",
                torch.bfloat16: "bf16", torch.float16: "f16",
                torch.int8: "s8", torch.int32: "s32", torch.int64: "s64",
                torch.bool: "pred", torch.uint8: "u8"}


def _is_propagation() -> bool:
    """True inside DTensor's sharding propagation (its shape inference
    runs ops on placeholder tensors of the global shape)."""
    frame = sys._getframe(2)
    depth = 0
    while frame is not None and depth < 48:
        path = frame.f_code.co_filename
        if path.endswith(_PROPAGATION_FILES) and "distributed" in path:
            return True
        frame = frame.f_back
        depth += 1
    return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    coll_ops: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    ops: int = 0
    peak_memory: float = 0.0
    argument_bytes: float = 0.0
    # (kind, result shapes) → [bytes, count, op name] and (op, result
    # shapes) → [bytes, count], summed over the run (`_shape_key`)
    coll_by_shape: dict = dataclasses.field(default_factory=dict)
    mem_by_shape: dict = dataclasses.field(default_factory=dict)

    @property
    def top_collectives(self) -> list[tuple]:
        """(bytes × count, kind, result shape, count, op name), largest
        first, at most `TOP_ENTRIES`."""
        rows = [(b, kind, _shape_text(shape), n, name)
                for (kind, shape), (b, n, name)
                in self.coll_by_shape.items()]
        return sorted(rows, key=lambda r: -r[0])[:TOP_ENTRIES]

    @property
    def top_memory_ops(self) -> list[tuple]:
        """(bytes × count, aten op, result shape, count), largest first,
        at most `TOP_ENTRIES`."""
        rows = [(b, op, _shape_text(shape), n)
                for (op, shape), (b, n) in self.mem_by_shape.items()]
        return sorted(rows, key=lambda r: -r[0])[:TOP_ENTRIES]


class CostMode(TorchDispatchMode):
    """Counts `Costs` of the local ops run inside it (see the module
    docstring). ``arguments`` (any nested structure of tensors, DTensors
    included) are the step's inputs: their local storages are live from
    the start."""

    def __init__(self, arguments=()):
        super().__init__()
        self.costs = Costs()
        self._live = 0
        self._seen = WeakIdKeyDictionary()
        for t in _flatten(arguments):
            local = _local(t)
            if local is not None:
                self._track(local)
        self.costs.argument_bytes = self._live

    # ---- storage accounting --------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        if storage in self._seen:
            return
        n = storage.nbytes()
        self._seen[storage] = n
        self._live += n
        self.costs.peak_memory = max(self.costs.peak_memory, self._live)
        weakref.finalize(storage, self._free, n)

    def _free(self, n: int) -> None:
        self._live -= n

    # ---- dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from repro_torch.models.spmd import dtensor_type
        dtensor = dtensor_type()
        flat = tree_leaves((args, kwargs))
        if dtensor is not None and any(isinstance(a, dtensor) for a in flat):
            # DTensor places the op and runs its local ops, which come
            # back here
            return NotImplemented
        out = func(*args, **kwargs)
        if _is_propagation():
            return out
        self._count(func, args, kwargs, flat, out)
        for o in tree_leaves(out):
            if isinstance(o, torch.Tensor):
                self._track(o)
        return out

    def _count(self, func, args, kwargs, flat_in, out) -> None:
        c = self.costs
        c.ops += 1
        name = func._overloadpacket.__name__
        namespace = func.namespace
        tensors_in = [a for a in flat_in if isinstance(a, torch.Tensor)]
        tensors_out = [o for o in tree_leaves(out)
                       if isinstance(o, torch.Tensor)]
        res_elems = sum(o.numel() for o in tensors_out)
        if namespace in ("_c10d_functional", "c10d_functional") \
                and name in _COLLECTIVE_OPS:
            kind = _COLLECTIVE_OPS[name]
            moved = sum(_nbytes(o) for o in tensors_out)
            c.coll_bytes[kind] += moved
            c.coll_ops[kind] += 1
            entry = c.coll_by_shape.setdefault(
                (kind, _shape_key(tensors_out)),
                [0, 0, f"{namespace}.{name}"])
            entry[0] += moved
            entry[1] += 1
        elif namespace == "aten":
            packet = func._overloadpacket
            from torch.utils.flop_counter import flop_registry
            if packet in flop_registry:
                c.flops += flop_registry[packet](*args, **kwargs,
                                                 out_val=out)
            elif name.rstrip("_") in _ELEMENTWISE:
                c.flops += res_elems
            elif name.rstrip("_") in _TRANSCENDENTAL:
                trans, flops = _TRANSCENDENTAL[name.rstrip("_")]
                c.transcendentals += trans * res_elems
                c.flops += flops * res_elems
            elif name in _REDUCTIONS:
                c.flops += tensors_in[0].numel() if tensors_in else 0
        if name in _NO_BYTES or getattr(func, "is_view", False):
            return
        moved = sum(_nbytes(t) for t in tensors_in) \
            + sum(_nbytes(o) for o in tensors_out)
        c.bytes += moved
        entry = c.mem_by_shape.setdefault(
            (f"{namespace}.{name}", _shape_key(tensors_out)), [0, 0])
        entry[0] += moved
        entry[1] += 1


def _shape_key(tensors: list) -> tuple:
    return tuple((t.dtype, tuple(t.shape)) for t in tensors)


def _shape_text(key: tuple) -> str:
    """HLO-style text of a `_shape_key`: ``bf16[8,256,1024]``, a tuple in
    parentheses."""
    parts = [f"{_DTYPE_NAMES.get(dt, str(dt).split('.')[-1])}"
             f"[{','.join(map(str, shape))}]" for dt, shape in key]
    return parts[0] if len(parts) == 1 else f"({', '.join(parts)})"


def _flatten(tree) -> list:
    """The tensors of nested dicts, lists, tuples and dataclasses (the
    train state)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _flatten(item)]
    return []


def _local(t):
    from repro_torch.models.spmd import is_dtensor
    if is_dtensor(t):
        return t.to_local()
    return t if isinstance(t, torch.Tensor) else None


# ------------------------------------------------------------------ roofline
@dataclasses.dataclass
class Roofline:
    flops: float                  # per device
    bytes_accessed: float         # per device (unfused upper bound)
    coll_bytes: dict              # per device, by collective kind
    peak_memory: float | None     # per device
    transcendentals: float = 0.0
    num_whiles: int = 0
    unknown_trip_counts: int = 0

    @property
    def total_coll_bytes(self) -> float:
        return float(sum(self.coll_bytes.values()))

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BANDWIDTH

    @property
    def collective_s(self) -> float:
        return self.total_coll_bytes / LINK_BANDWIDTH

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "transcendentals_per_device": self.transcendentals,
            "collective_bytes_per_device": self.coll_bytes,
            "peak_memory_per_device": self.peak_memory,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "num_whiles": self.num_whiles,
            "unknown_trip_counts": self.unknown_trip_counts,
        }


def roofline(costs: Costs) -> Roofline:
    return Roofline(flops=costs.flops, bytes_accessed=costs.bytes,
                    coll_bytes=dict(costs.coll_bytes),
                    peak_memory=float(costs.peak_memory),
                    transcendentals=costs.transcendentals)


def analyze(fn, *args, **kwargs) -> tuple[object, Costs]:
    """Run ``fn(*args, **kwargs)`` once under `CostMode` (the arguments
    live from the start); returns (its result, the costs)."""
    mode = CostMode((args, kwargs))
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.costs


def model_flops_per_step(cfg, shape, active_params: int) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (train) or 2·N_active·tokens
    (forward)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active_params * tokens
