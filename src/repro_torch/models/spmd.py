"""The model on a mesh: DTensor helpers of `repro_torch.models`.

Under `repro_torch.launch.specs.input_specs` the parameters, the batch
and the decode cache are DTensors placed by
`repro_torch.launch.sharding.ShardingRules`. The model's matmuls and
elementwise ops run on them as DTensor ops, and DTensor's sharding
propagation inserts the collectives, as GSPMD does in the reference.
The parts whose ops DTensor cannot place (the attention's online softmax,
the recurrent scans, the MoE dispatch, the loss's gather) run on the
local shards through `local_call`, after their inputs are redistributed
to a layout in which each rank's part is independent: batch over the
data axes, heads or inner dims over ``model``.

Every function here returns its input unchanged on plain tensors, so
the one-device path keeps its bits.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

_DTENSOR = None


def dtensor_type():
    """The DTensor class, or None where torch has no distributed
    package."""
    global _DTENSOR
    if _DTENSOR is None:
        if not torch.distributed.is_available():
            return None
        from torch.distributed.tensor import DTensor
        _DTENSOR = DTensor
    return _DTENSOR


def is_dtensor(t) -> bool:
    cls = dtensor_type()
    return cls is not None and isinstance(t, cls)


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def constrain(t: torch.Tensor, spec: Sequence | None) -> torch.Tensor:
    """``t`` redistributed to ``spec``'s placements: the counterpart of
    the reference's ``with_sharding_constraint``. A plain tensor, or no
    spec, passes through."""
    if spec is None or not is_dtensor(t):
        return t
    from repro_torch.launch.sharding import placements
    return to_placements(t, placements(spec, t.device_mesh))


def to_placements(t: torch.Tensor, placements: Sequence) -> torch.Tensor:
    """A DTensor ``t`` redistributed to ``placements`` (no-op when
    equal)."""
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, tuple(placements))


def _contiguous_stride(shape: Sequence[int]) -> tuple[int, ...]:
    stride, acc = [], 1
    for size in reversed(shape):
        stride.append(acc)
        acc *= size
    return tuple(reversed(stride))


def wrap(local: torch.Tensor, mesh, placements: Sequence,
         shape: Sequence[int]) -> torch.Tensor:
    """The DTensor of global ``shape`` whose local shard is ``local``."""
    cls = dtensor_type()
    return cls.from_local(local, mesh, tuple(placements), run_check=False,
                          shape=torch.Size(shape),
                          stride=_contiguous_stride(shape))


def local_shards(tensors: Sequence, placements: Sequence[Sequence]) -> list:
    """Each DTensor redistributed to its placements, then its local
    shard; a plain tensor (replicated on every rank) as it is."""
    out = []
    for t, pl in zip(tensors, placements):
        if is_dtensor(t):
            out.append(to_placements(t, pl).to_local())
        else:
            out.append(t)
    return out


def local_call(fn: Callable, mesh, args: Sequence, in_placements: Sequence,
               out_placements: Sequence, out_shapes: Sequence):
    """``fn`` on the local shards of ``args`` (each redistributed to its
    entry of ``in_placements``; plain tensors and None pass as they are),
    its outputs (a tensor or a tuple) wrapped as DTensors of
    ``out_placements`` and global ``out_shapes``. Differentiable: the
    redistributions and wraps are DTensor's autograd functions."""
    out = fn(*local_shards(args, in_placements))
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(wrap(o, mesh, pl, shape) for o, pl, shape in
                    zip(outs, out_placements, out_shapes))
    return wrapped[0] if single else wrapped


def mesh_dims_sharding(t, dim: int) -> list[int]:
    """Mesh dims on which the DTensor ``t`` shards tensor dim ``dim``
    (exact ``Shard``, not a strided one)."""
    from torch.distributed.tensor import Shard
    return [i for i, pl in enumerate(t.placements)
            if type(pl) is Shard and pl.dim == dim]


def local_range(t, dim: int) -> tuple[int, int]:
    """[start, stop) of this rank's shard of the DTensor ``t`` along
    ``dim``: each mesh dim that shards it, in mesh order, splits the
    range left by the one before as ``torch.chunk`` does."""
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    lo, size = 0, int(t.shape[dim])
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            chunk = -(-size // mesh.size(i))
            start = min(coord[i] * chunk, size)
            stop = min(start + chunk, size)
            lo, size = lo + start, stop - start
    return lo, lo + size


def assign(dst: torch.Tensor, index: tuple, src: torch.Tensor) -> None:
    """``dst[index] = src`` in place, ``index`` ints and slices over
    leading dims. On a DTensor the write runs on the local shard: an
    index into a sharded dim lands on the rank whose shard holds it (the
    others write nothing), and ``src`` is first redistributed to the
    layout of the indexed view."""
    if not is_dtensor(dst):
        dst[index] = src
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = dst.device_mesh
    # placements of the view dst[index]: a mesh dim sharding an indexed
    # dim holds the whole view on its owner rank only, so src replicates
    # there; other shards move down past the dims that ints remove
    view_pl = []
    for pl in dst.placements:
        if type(pl) is Shard and pl.dim < len(index) \
                and index[pl.dim] != slice(None):
            view_pl.append(Replicate())
        elif type(pl) is Shard:
            dropped = sum(isinstance(i, int) for i in index[:pl.dim])
            view_pl.append(Shard(pl.dim - dropped))
        else:
            view_pl.append(pl)
    src_local = to_placements(src, view_pl).to_local() if is_dtensor(src) \
        else src
    local = dst.to_local()
    local_index = []
    for dim, idx in enumerate(index):
        if idx == slice(None):
            local_index.append(idx)
            continue
        lo, hi = local_range(dst, dim)
        if isinstance(idx, int):
            if not lo <= idx < hi:
                return
            local_index.append(idx - lo)
        else:
            start, stop, step = idx.indices(dst.shape[dim])
            if step != 1 or start < lo or stop > hi:
                if stop <= lo or start >= hi:
                    return
                raise ValueError(f"assign: slice {idx} of dim {dim} spans "
                                 f"shards [{lo}, {hi})")
            local_index.append(slice(start - lo, stop - lo))
    with torch.no_grad():
        local[tuple(local_index)] = src_local


# ---------------------------------------------------------------- layouts
def attention_layout(q, k, tp_axis: str | None = "model"):
    """(q/out placements, k/v placements, sequence mesh dims) for the
    attention of q [B, Sq, H, dh] against k/v [B, Skv, K, dh] on local
    shards: the batch on q's batch mesh dims, heads on ``tp_axis`` when
    it divides H and K and no batch dim uses it, and k/v's sequence on
    the mesh dims that shard it already (a cache sharded by sequence)."""
    from torch.distributed.tensor import Replicate, Shard

    ref = q if is_dtensor(q) else k
    mesh = ref.device_mesh
    names = mesh.mesh_dim_names
    batch = mesh_dims_sharding(q, 0) if is_dtensor(q) else []
    seq = mesh_dims_sharding(k, 1) if is_dtensor(k) else []
    h, kh = q.shape[2], k.shape[2]
    head = None
    if tp_axis in names:
        i = names.index(tp_axis)
        size = mesh.size(i)
        if i not in batch and i not in seq and h % size == 0 \
                and kh % size == 0:
            head = i
    qpl, kpl = [], []
    for i in range(len(names)):
        if i in batch and i not in seq:
            qpl.append(Shard(0))
            kpl.append(Shard(0))
        elif i == head:
            qpl.append(Shard(2))
            kpl.append(Shard(2))
        elif i in seq:
            qpl.append(Replicate())
            kpl.append(Shard(1))
        else:
            qpl.append(Replicate())
            kpl.append(Replicate())
    return tuple(qpl), tuple(kpl), [i for i in seq if i not in batch]


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     mesh, placements: Sequence, seq_dims: list[int],
                     shape: Sequence[int]) -> torch.Tensor:
    """Merge online-softmax partials (m, l [B, Sq, H], acc [B, Sq, H, dh],
    float32, on local shards) across the mesh dims ``seq_dims`` that
    shard the keys: M = max m, out = Σ e^{m − M}·acc / Σ e^{m − M}·l,
    through DTensor ``Partial`` max and sum reductions. Returns the
    DTensor output of ``placements`` and global ``shape``."""
    from torch.distributed.tensor import Partial

    def reduce(local, op):
        pl = [Partial(op) if i in seq_dims else p
              for i, p in enumerate(placements)]
        return wrap(local, mesh, pl, tuple(shape[:local.ndim])) \
            .redistribute(mesh, tuple(placements)).to_local()

    big_m = reduce(m, "max")
    w = torch.exp(m - big_m)
    l_tot = reduce(l * w, "sum")
    acc_tot = reduce(acc * w[..., None], "sum")
    return acc_tot / torch.clamp_min(l_tot[..., None], 1e-30)


def prod_sizes(mesh, dims: Sequence[int]) -> int:
    return math.prod(mesh.size(i) for i in dims)


def on_mesh(*tensors) -> bool:
    return any(is_dtensor(t) for t in tensors)


def implicit(active: bool):
    """DTensor's implicit replication while ``active``: plain tensors
    made inside the model (positions, masks, scalars) join DTensor ops
    as replicated. A null context otherwise."""
    import contextlib
    if not active or getattr(dtensor_type()._op_dispatcher,
                             "_allow_implicit_replication", False):
        # torch's context resets the switch on exit instead of restoring
        # it, so an inner one would end an outer one early
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


FSDP_AXES = ("pod", "data")


def unshard(w: torch.Tensor) -> torch.Tensor:
    """A parameter with its FSDP shards (over the ``pod`` and ``data``
    mesh axes) gathered for use, its tensor-parallel shards (``model``)
    kept: what FSDP does before a layer runs. Its backward is the
    gradient's reduce-scatter back into the shards."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard

    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in FSDP_AXES
                 and isinstance(pl, Shard) else pl
                 for i, pl in enumerate(w.placements))
    return to_placements(w, want)


def unshard_layer(layer: list[dict]) -> list[dict]:
    """`unshard` over a layer group's per-slot parameter dicts (the
    plain group as it is)."""
    if not any(is_dtensor(t) for slot in layer[:1] for t in slot.values()):
        return layer
    return [{name: unshard(t) for name, t in slot.items()}
            for slot in layer]


class Layout:
    """A layout in which a per-(batch, inner) computation is local: the
    batch on the mesh dims that shard ``ref``'s dim 0 (exact shards),
    the inner dim (heads, d_inner) on ``tp_axis`` when that mesh dim
    divides ``inner_size`` and shards no batch, everything else
    replicated."""

    def __init__(self, ref, inner_size: int, *, tp_axis: str = "model"):
        self.mesh = ref.device_mesh
        names = self.mesh.mesh_dim_names
        self.batch = mesh_dims_sharding(ref, 0)
        self.inner = None
        if tp_axis in names:
            i = names.index(tp_axis)
            if i not in self.batch and inner_size % self.mesh.size(i) == 0:
                self.inner = i

    def placements(self, ndim: int, *, batch: int | None = None,
                   inner: int | None = None) -> tuple:
        """Placements of an ``ndim``-dim tensor whose batch is dim
        ``batch`` and inner dim is ``inner`` (None: it has none)."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for i in range(self.mesh.ndim):
            if batch is not None and i in self.batch:
                out.append(Shard(batch))
            elif inner is not None and i == self.inner:
                out.append(Shard(inner))
            else:
                out.append(Replicate())
        return tuple(out)


def split_last(t: torch.Tensor, heads: int, size: int) -> torch.Tensor:
    """``t`` [..., heads·size] viewed as [..., heads, size]. On a mesh,
    when the mesh dims that shard the last dim do not divide ``heads``
    (8 kv heads on a 16-way model axis), that dim is gathered first:
    DTensor cannot cut a head across shards."""
    shape = (*t.shape[:-1], heads, size)
    if is_dtensor(t):
        dims = mesh_dims_sharding(t, t.ndim - 1)
        if dims and heads % prod_sizes(t.device_mesh, dims):
            from torch.distributed.tensor import Replicate
            t = to_placements(t, [Replicate() if i in dims else pl
                                  for i, pl in enumerate(t.placements)])
    return t.reshape(shape)


def merge_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` [..., heads, size] viewed as [..., heads·size]. On a mesh the
    view is taken on the local shard (a shard of the heads becomes a
    contiguous shard of the merged dim), so neither direction asks
    DTensor to cut a head across shards (40 heads on a 16-way axis)."""
    if not is_dtensor(t):
        return t.reshape(*t.shape[:-2], -1)
    from torch.distributed.tensor import Replicate, Shard

    n = t.ndim
    if mesh_dims_sharding(t, n - 1) or any(
            not isinstance(pl, (Shard, Replicate)) for pl in t.placements):
        t = to_placements(t, [Replicate() if not isinstance(pl, Shard)
                              or pl.dim >= n - 1 else pl
                              for pl in t.placements])
    local = t.to_local()
    return wrap(local.reshape(*local.shape[:-2], -1), t.device_mesh,
                t.placements, (*t.shape[:-2], t.shape[-2] * t.shape[-1]))
