"""Packed runtime for the Eq. 19 DeKRR-DDRF iteration.

The counterpart of `repro.dist.dekrr_spmd` (the file name is kept so the
two are found side by side).

1. **Packing** (`pack_problem`): every per-node auxiliary padded to the
   network maximum D_max and stacked over nodes —

     G:  [J, D_max, D_max]      (Eq. 17 inverse, applied)
     d:  [J, D_max] or [J, D_max, Dy]
     S:  [J, D_max, D_max]
     P:  [J, K, D_max, D_max]   (neighbour couplings, K slots per node)

   plus `theta_mask` and the slot table `nbr_idx`/`nbr_mask` [J, K].
   Padding is zero in the matrices, so a round maps padded inputs to
   padded outputs exactly: row i ≥ D_j of G_j is zero. The default
   ``method="batched"`` computes Eq. 17 batched over the node axis; the
   Z Zᵀ Gram blocks go through the `rff_gram` kernel
   (``gram_backend="cuda"``, the default). ``method="aux"`` copies the
   solver's ragged auxiliaries.

2. **Execution** (`step_batched` / `solve_batched`) with the backend
   switch ``torch | cuda | cuda_fused``:

     * ``"torch"``: the batched matmul round; the solve is a Python loop;
     * ``"cuda"``: the `dekrr_step` kernel, one launch per round;
     * ``"cuda_fused"``: the `dekrr_solve` kernel, whole blocks of rounds
       in one cooperative launch.

   On CPU tensors the ``cuda*`` backends run the kernels' plain versions.

3. **SPMD** (`make_spmd_solver`): one node per rank of a
   `torch.distributed` process group, each rank holding only its node's
   blocks and exchanging only θ with its neighbours each round (ring
   shifts or an all-gather). `repro_torch.dist.ranks.run_ranks` starts
   the ranks.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.obs.spans import span
from repro_torch.obs.trace import SolveTrace

__all__ = [
    "PackedProblem",
    "pack_problem",
    "pack_theta",
    "unpack_theta",
    "step_batched",
    "solve_batched",
    "comm_bytes_per_round",
    "exchange_counts",
    "make_spmd_solver",
    "reset_exchange_counts",
]


@dataclasses.dataclass
class PackedProblem:
    """Eq. 17 auxiliaries padded to [J, D_max, …] with a neighbour slot table.

    Tensors (J nodes, K slots, D_max features), all on one device:
      g [J, D, D], d [J, D] or [J, D, Dy], s [J, D, D], p [J, K, D, D]
      (zero for masked slots), theta_mask [J, D] (1.0 on live
      coordinates), nbr_idx [J, K] int32 (node feeding slot k of node j;
      j itself on padded slots), nbr_mask [J, K] (1.0 on live slots).

    Host metadata:
      offsets: circulant shift set when the slot table is laid out
        [(+s_1), (−s_1), (+s_2), …]; None for the padded adjacency.
      node_dims: per-node feature counts (D_1, …, D_J).
      num_edges_directed: live slot count Σ_j |N_j|.
    """

    g: torch.Tensor
    d: torch.Tensor
    s: torch.Tensor
    p: torch.Tensor
    theta_mask: torch.Tensor
    nbr_idx: torch.Tensor
    nbr_mask: torch.Tensor
    offsets: tuple[int, ...] | None = None
    node_dims: tuple[int, ...] | None = None
    num_edges_directed: int | None = None

    @property
    def num_nodes(self) -> int:
        return self.d.shape[0]

    @property
    def max_features(self) -> int:
        return self.d.shape[1]

    @property
    def num_slots(self) -> int:
        return self.nbr_idx.shape[1]

    @property
    def num_outputs(self) -> int:
        """Dy — trailing output width (1 for scalar-target packings)."""
        return self.d.shape[2] if self.d.ndim == 3 else 1

    @property
    def device(self) -> torch.device:
        return self.d.device


def _circulant_slot_table(offsets: Sequence[int],
                          num_nodes: int) -> np.ndarray:
    """Slot table in ring-shift order [(+s_1), (−s_1), (+s_2), (−s_2), …]."""
    idx = np.zeros((num_nodes, 2 * len(offsets)), dtype=np.int32)
    for m, s in enumerate(offsets):
        for j in range(num_nodes):
            idx[j, 2 * m] = (j + s) % num_nodes
            idx[j, 2 * m + 1] = (j - s) % num_nodes
    return idx


def _validate_slot_table(nbr_idx: np.ndarray, nbr_mask: np.ndarray,
                         num_nodes: int) -> int:
    """Every slot entry (padded slots carry an in-range self index) must
    lie in [0, J); returns the live directed-edge count Σ_j |N_j|."""
    if nbr_idx.shape != nbr_mask.shape:
        raise ValueError(f"slot table shape mismatch: nbr_idx "
                         f"{nbr_idx.shape} vs nbr_mask {nbr_mask.shape}")
    if nbr_idx.size and (nbr_idx.min() < 0 or nbr_idx.max() >= num_nodes):
        raise ValueError(f"nbr_idx: indices must lie in [0, {num_nodes}) "
                         f"but span [{nbr_idx.min()}, {nbr_idx.max()}]")
    return int(np.count_nonzero(nbr_mask))


def _slot_table(topo):
    """(nbr_idx [J, K] int32, nbr_mask [J, K] bool, offsets | None):
    the ring-shift layout for circulant graphs whose ±s neighbours are
    distinct, else the padded adjacency of `Topology.neighbor_table()`."""
    offsets = topo.circulant_offsets
    if offsets is not None and topo.max_degree == 2 * len(offsets):
        nbr_idx = _circulant_slot_table(offsets, topo.num_nodes)
        return (nbr_idx, np.ones(nbr_idx.shape, dtype=bool),
                tuple(int(s) for s in offsets))
    nbr_idx, live = topo.neighbor_table()
    return nbr_idx, live, None


_PACK_METHODS = ("batched", "aux")
_GRAM_BACKENDS = ("torch", "cuda")


def pack_problem(solver, *, method: str = "batched",
                 gram_backend: str | None = None,
                 device: str | torch.device | None = None) -> PackedProblem:
    """Build a `PackedProblem` from a `repro_torch.core.DeKRRSolver`.

    ``method="batched"`` computes Eq. 17 batched over the node axis;
    ``gram_backend`` picks how its Z Zᵀ blocks are formed: ``"cuda"``
    (the `rff_gram` kernel, cos_bias maps only — cos_sin maps use the
    torch matmuls; the default) or ``"torch"``. ``method="aux"`` copies
    the solver's ragged auxiliaries; bagged solvers, solvers with a
    ``gram_fn`` and mixed feature kinds are downgraded to it with a
    warning, unless ``"cuda"`` was asked for by name, which then raises.

    The packed tensors live on ``device`` (the card unless the caller
    names another).
    """
    if method not in _PACK_METHODS:
        raise ValueError(f"method must be one of {_PACK_METHODS}, "
                         f"got {method!r}")
    if gram_backend not in (None,) + _GRAM_BACKENDS:
        raise ValueError(f"gram_backend must be one of {_GRAM_BACKENDS}, "
                         f"got {gram_backend!r}")
    device = resolve_device(device)
    kinds = {fm.kind for fm in solver.feature_maps}
    has_bags = any(nd.bags is not None for nd in solver.data)
    has_gram_fn = solver._gram_fn is not None
    if method == "batched" and (len(kinds) > 1 or has_gram_fn or has_bags):
        reason = ("the solver has a custom gram_fn" if has_gram_fn
                  else "the solver has aggregate-observation (bagged) "
                       "nodes, whose Agg operator only the ragged build "
                       "applies"
                  if has_bags
                  else f"the solver mixes feature kinds {sorted(kinds)}")
        if gram_backend == "cuda":
            raise ValueError(
                f"pack_problem(gram_backend='cuda') is impossible here: "
                f"{reason}, which only the ragged method='aux' build "
                f"honors, and that build ignores gram_backend. Pass "
                f"gram_backend='torch' or use a uniform cos_bias solver "
                f"without gram_fn.")
        warnings.warn(
            f"pack_problem(method='batched') downgraded to method='aux': "
            f"{reason}. The aux build is a per-node Python loop — expect "
            f"it to be slow at scale.", UserWarning, stacklevel=2)
        method = "aux"
    if method == "aux":
        if gram_backend == "cuda":
            raise ValueError(
                "pack_problem(method='aux') copies the solver's ragged "
                "auxiliaries and ignores gram_backend — "
                "gram_backend='cuda' would silently not be honored. Use "
                "method='batched' for the rff_gram kernel path.")
        with span("pack_problem", nodes=solver.J, method="aux"):
            return _pack_problem_from_aux(solver, device)
    with span("pack_problem", nodes=solver.J, method="batched"):
        with span("pack.stage"):
            staged = _stage_packed_inputs(solver, device)
        inputs = staged["inputs"]
        if (gram_backend or "cuda") == "cuda" and inputs["kind"] == "cos_bias":
            inputs.update(_kernel_gram_blocks(inputs))
        with span("pack.aux"):
            built = _node_aux(**inputs)
        return _finish_packed(staged, built)


def _pack_problem_from_aux(solver, device) -> PackedProblem:
    """Per-node loop copying `solver.aux` (ragged) into the padded layout."""
    j_nodes = solver.J
    dims = tuple(fm.num_features for fm in solver.feature_maps)
    d_max = max(dims)
    aux = solver.aux
    dtype = aux.d[0].dtype
    nbr_idx, nbr_mask, offsets = _slot_table(solver.topology)
    num_edges = _validate_slot_table(nbr_idx, nbr_mask, j_nodes)
    k_slots = nbr_idx.shape[1]
    kw = dict(dtype=dtype, device=device)
    out_tail = tuple(aux.d[0].shape[1:])
    g = torch.zeros((j_nodes, d_max, d_max), **kw)
    d = torch.zeros((j_nodes, d_max) + out_tail, **kw)
    s = torch.zeros((j_nodes, d_max, d_max), **kw)
    p = torch.zeros((j_nodes, k_slots, d_max, d_max), **kw)
    theta_mask = torch.zeros((j_nodes, d_max), **kw)
    for j in range(j_nodes):
        dj = dims[j]
        g[j, :dj, :dj] = aux.g[j]
        d[j, :dj] = aux.d[j]
        s[j, :dj, :dj] = aux.s[j]
        theta_mask[j, :dj] = 1.0
        for k in range(k_slots):
            if nbr_mask[j, k]:
                pjp = aux.p[j][int(nbr_idx[j, k])]
                p[j, k, :pjp.shape[0], :pjp.shape[1]] = pjp
    return PackedProblem(
        g=g, d=d, s=s, p=p, theta_mask=theta_mask,
        nbr_idx=torch.as_tensor(nbr_idx, device=device),
        nbr_mask=torch.as_tensor(nbr_mask.astype(np.float64), **kw),
        offsets=offsets, node_dims=dims, num_edges_directed=num_edges)


# --------------------------------------------------------------------------
# Batched Eq. 17 build (default pack_problem path)
# --------------------------------------------------------------------------
def _stage_feature_maps(fmaps, dtype, device) -> dict:
    """Stage a uniform-kind feature-map list as padded [J, …] tensors:
    omega [J, F_max, d], bias [J, F_max], feat_idx [J, D_max] (row map
    from raw featurize space — F_max or 2·F_max rows — into the packed
    feature space: identity for cos_bias; for cos_sin node j's live rows
    are [0, F_j) ∪ [F_max, F_max + F_j) made contiguous), feat_mask
    [J, D_max], and the per-node scale (√(2/F_j) or 1/√F_j)."""
    kinds = {fm.kind for fm in fmaps}
    if len(kinds) > 1:
        raise ValueError(
            f"feature-map staging requires a uniform kind across nodes "
            f"(got {sorted(kinds)}) — mixed kinds are only supported by "
            f"the ragged pack_problem(method='aux') path")
    kind = fmaps[0].kind
    j_nodes = len(fmaps)
    dim_in = fmaps[0].omega.shape[1]
    freqs = np.array([fm.num_frequencies for fm in fmaps])
    dims = np.array([fm.num_features for fm in fmaps])
    f_max, d_max = int(freqs.max()), int(dims.max())
    kw = dict(dtype=dtype, device=device)

    omega = torch.zeros((j_nodes, f_max, dim_in), **kw)
    bias = torch.zeros((j_nodes, f_max), **kw)
    for j, fm in enumerate(fmaps):
        omega[j, :freqs[j]] = fm.omega
        if fm.bias is not None:
            bias[j, :freqs[j]] = fm.bias
    feat_mask = (np.arange(d_max)[None, :] < dims[:, None]).astype(np.float64)
    if kind == "cos_bias":
        feat_idx = np.broadcast_to(np.arange(d_max, dtype=np.int64),
                                   (j_nodes, d_max)).copy()
        scale = np.sqrt(2.0 / freqs)
    else:
        feat_idx = np.zeros((j_nodes, d_max), dtype=np.int64)
        for j, fj in enumerate(freqs):
            feat_idx[j, :2 * fj] = np.concatenate(
                [np.arange(fj), f_max + np.arange(fj)])
        scale = 1.0 / np.sqrt(freqs)
    return dict(omega=omega, bias=bias,
                feat_idx=torch.as_tensor(feat_idx, device=device),
                feat_mask=torch.as_tensor(feat_mask, **kw),
                scale=torch.as_tensor(scale, **kw), kind=kind,
                node_dims=tuple(int(v) for v in dims))


def _stage_packed_inputs(solver, device) -> dict:
    """Padded [J, …] inputs of the batched Eq. 17 build, with every
    neighbour input gathered per slot ([J, K, …]) so the build itself is
    one batched program over the node axis."""
    j_nodes = solver.J
    dtype = solver.data[0].x.dtype
    kw = dict(dtype=dtype, device=device)
    maps = _stage_feature_maps(solver.feature_maps, dtype, device)
    sizes = np.array([nd.num_samples for nd in solver.data])
    n_max = int(sizes.max())
    dim_in = solver.data[0].x.shape[0]

    x = torch.zeros((j_nodes, dim_in, n_max), **kw)
    multi = solver.data[0].y.ndim > 1
    dy = solver.data[0].num_outputs
    y = torch.zeros((j_nodes, n_max, dy) if multi else (j_nodes, n_max),
                    **kw)
    for j, nd in enumerate(solver.data):
        x[j, :, :sizes[j]] = nd.x
        y[j, :sizes[j]] = nd.y if multi else nd.y.reshape(-1)
    col_mask = torch.as_tensor(
        (np.arange(n_max)[None, :] < sizes[:, None]).astype(np.float64),
        **kw)

    ct_self, ct_nei = solver.coupling_coefficients()
    nbr_idx, nbr_mask, offsets = _slot_table(solver.topology)
    idx = torch.as_tensor(nbr_idx, dtype=torch.int64, device=device)
    gather = lambda a: a[idx]                # [J, K, …] by slot table
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64), **kw)
    inputs = dict(
        omega=maps["omega"], bias=maps["bias"], x=x, y=y,
        col_mask=col_mask, feat_mask=maps["feat_mask"],
        feat_idx=maps["feat_idx"], scale=maps["scale"],
        omega_n=gather(maps["omega"]), bias_n=gather(maps["bias"]),
        x_n=gather(x), col_mask_n=gather(col_mask),
        feat_mask_n=gather(maps["feat_mask"]),
        feat_idx_n=gather(maps["feat_idx"]), scale_n=gather(maps["scale"]),
        ct_self=as_t(ct_self), ct_nei=as_t(ct_nei),
        ct_nei_n=as_t(ct_nei)[idx],
        degree=as_t(solver.topology.degrees),
        nbr_mask=as_t(nbr_mask),
        lam_over_j=solver.config.lam / solver.J,
        n_total=float(solver.N), kind=maps["kind"],
    )
    return dict(inputs=inputs, node_dims=maps["node_dims"],
                nbr_idx=nbr_idx, nbr_mask=nbr_mask, offsets=offsets)


def _gram_kernel_calls(inputs: dict) -> list[tuple]:
    """Operands of the `rff_gram` launches of the Eq. 17 Gram blocks, at
    unit scale: every node's own block (with zy; the kernel's zy is
    scalar-target only) and, when there are slots, node j's map on each
    slot neighbour's data, flattened over (j, k)."""
    omega, bias = inputs["omega"], inputs["bias"]
    x, y, cm = inputs["x"], inputs["y"], inputs["col_mask"]
    j_nodes, k_slots = inputs["nbr_mask"].shape
    calls = [(omega, bias, x, y if y.ndim == 2 else torch.zeros_like(cm),
              cm)]
    if k_slots:
        f_max, dim_in = omega.shape[1:]
        om_rep = omega[:, None].expand(j_nodes, k_slots, f_max, dim_in) \
            .reshape(-1, f_max, dim_in)
        bi_rep = bias[:, None].expand(j_nodes, k_slots, f_max) \
            .reshape(-1, f_max)
        x_n = inputs["x_n"].reshape((-1,) + tuple(x.shape[1:]))
        cm_n = inputs["col_mask_n"].reshape(-1, cm.shape[1])
        calls.append((om_rep, bi_rep, x_n, torch.zeros_like(cm_n), cm_n))
    return calls


def _kernel_gram_blocks(inputs: dict) -> dict:
    """The Eq. 17 Z Zᵀ blocks through the `rff_gram` kernel: gram_jj/zy
    for every node (one launch) and Gram(Z_{j,p}) for every slot (one
    launch). `_node_aux` applies the per-node √(2/D_j) and the feature
    mask, and forms a multi-output d from the packed features."""
    from repro_torch.kernels.ops import rff_gram_batched

    j_nodes, k_slots = inputs["nbr_mask"].shape
    calls = _gram_kernel_calls(inputs)
    with span("pack.gram"):
        graw, zyraw = rff_gram_batched(*calls[0])
        f_max = graw.shape[1]
        if k_slots == 0:
            gcross = graw.new_zeros((j_nodes, 0, f_max, f_max))
        else:
            gcross = rff_gram_batched(*calls[1])[0].reshape(
                j_nodes, k_slots, f_max, f_max)
    return dict(gram_raw=graw, zy_raw=zyraw, gram_cross_raw=gcross)


def _gauss_jordan_inv(a: torch.Tensor) -> torch.Tensor:
    """Unpivoted Gauss–Jordan inverse over a leading batch axis (safe:
    Eq. 17's matrix is SPD and the padding is an identity block). Used
    instead of `torch.linalg.inv` because LAPACK's blocked factorization
    rounds differently at different batch sizes; this form is built from
    elementwise operations, so each node's inverse does not depend on how
    many nodes are batched with it."""
    dim = a.shape[-1]
    eye = torch.eye(dim, dtype=a.dtype, device=a.device).expand_as(a)
    aug = torch.cat([a, eye], dim=-1)
    for i in range(dim):
        piv = aug[:, i] / aug[:, i, i:i + 1]
        aug = aug - aug[:, :, i:i + 1] * piv[:, None, :]
        aug[:, i] = piv
    return aug[..., dim:]


def _featurize_raw(omega, bias, x, kind):
    """Unscaled raw features, batched: omega [..., F, d], x [..., d, N]
    → [..., R, N] (R = F, or 2F for cos_sin)."""
    proj = omega @ x
    if kind == "cos_bias":
        return torch.cos(proj + bias[..., None])
    return torch.cat([torch.cos(proj), torch.sin(proj)], dim=-2)


def _pack_rows(raw, idx, fm, sc, cm):
    """raw [..., R, N] → Z [..., D, N]: packed rows, scaled, masked."""
    z = torch.gather(raw, -2, idx[..., None].expand(
        idx.shape + raw.shape[-1:]))
    return z * sc[..., None, None] * fm[..., None] * cm[..., None, :]


def _node_aux(omega, bias, x, y, col_mask, feat_mask, feat_idx, scale,
              omega_n, bias_n, x_n, col_mask_n, feat_mask_n, feat_idx_n,
              scale_n, ct_self, ct_nei, ct_nei_n, degree, nbr_mask,
              lam_over_j, n_total, *, kind,
              gram_raw=None, zy_raw=None, gram_cross_raw=None):
    """Eq. 17 auxiliaries for all nodes in the padded layout, batched over
    the leading node axis. Neighbour inputs arrive gathered per slot
    ([J, K, …]); masked slots carry nbr_mask 0 and cancel exactly."""
    z = _pack_rows(_featurize_raw(omega, bias, x, kind),
                   feat_idx, feat_mask, scale, col_mask)       # Z_jj [J, D, N]
    k_slots = omega_n.shape[1]
    # neighbour maps on own data / own map on neighbour data / neighbour-own
    z_n_on_j = _pack_rows(
        _featurize_raw(omega_n, bias_n, x[:, None], kind),
        feat_idx_n, feat_mask_n, scale_n,
        col_mask[:, None].expand(-1, k_slots, -1))             # [J, K, D, N]
    z_j_on_n = _pack_rows(
        _featurize_raw(omega[:, None], bias[:, None], x_n, kind),
        feat_idx[:, None].expand(-1, k_slots, -1),
        feat_mask[:, None].expand(-1, k_slots, -1),
        scale[:, None].expand(-1, k_slots), col_mask_n)
    z_nn = _pack_rows(_featurize_raw(omega_n, bias_n, x_n, kind),
                      feat_idx_n, feat_mask_n, scale_n, col_mask_n)

    # mult + sum, as the reference forms d (its matvec rounded differently
    # at different batch sizes)
    if y.ndim == 2:
        d_vec_z = torch.sum(z * y[:, None, :], dim=2) / n_total
    else:
        d_vec_z = torch.sum(z[..., None] * y[:, None], dim=2) / n_total

    fouter = feat_mask[:, :, None] * feat_mask[:, None, :]
    sc2 = (scale ** 2)[:, None, None]
    if gram_raw is not None:
        # rff_gram kernel output (unit-scale frequency space == packed
        # feature space for cos_bias); mask and scale here
        gram_jj = gram_raw * sc2 * fouter
        d_vec = (zy_raw * scale[:, None] * feat_mask / n_total
                 if y.ndim == 2 else d_vec_z)
        gram_cross = gram_cross_raw * sc2[:, None] * fouter[:, None]
    else:
        gram_jj = z @ z.transpose(1, 2)
        d_vec = d_vec_z
        gram_cross = z_j_on_n @ z_j_on_n.transpose(2, 3)

    coef = (1.0 / n_total + 2.0 * ct_self + degree * ct_nei)[:, None, None]
    a = coef * gram_jj
    a = a + lam_over_j * torch.diag_embed(feat_mask)
    a = a + torch.einsum("jk,jkab->jab", nbr_mask * ct_nei_n, gram_cross)
    with span("pack.inverse"):
        g = _gauss_jordan_inv(a + torch.diag_embed(1.0 - feat_mask))
    g = g * fouter

    s = 2.0 * ct_self[:, None, None] * gram_jj
    p = (ct_nei[:, None, None, None] * (z[:, None] @ z_n_on_j.transpose(2, 3))
         + ct_nei_n[:, :, None, None]
         * (z_j_on_n @ z_nn.transpose(2, 3)))
    p = p * nbr_mask[:, :, None, None]
    return g, d_vec, s, p


def _finish_packed(staged: dict, built) -> PackedProblem:
    g, d, s, p = built
    dims = staged["node_dims"]
    nbr_idx, nbr_mask = staged["nbr_idx"], staged["nbr_mask"]
    num_edges = _validate_slot_table(nbr_idx, nbr_mask, len(dims))
    inputs = staged["inputs"]
    return PackedProblem(
        g=g, d=d, s=s, p=p, theta_mask=inputs["feat_mask"],
        nbr_idx=torch.as_tensor(nbr_idx, device=g.device),
        nbr_mask=inputs["nbr_mask"], offsets=staged["offsets"],
        node_dims=dims, num_edges_directed=num_edges)


def pack_theta(packed: PackedProblem,
               theta: Sequence[torch.Tensor]) -> torch.Tensor:
    """Ragged per-node θ list → padded [J, D_max] (or [J, D_max, Dy]).

    Vectors shorter than their node's D_j re-pad with exact zeros; longer
    ones, or ones with another output width Dy, are stale against this
    layout and rejected.
    """
    theta = list(theta)
    if len(theta) != packed.num_nodes:
        raise ValueError(
            f"pack_theta got {len(theta)} θ vectors for a packed problem "
            f"with {packed.num_nodes} nodes")
    d_max = packed.max_features
    out_tail = tuple(packed.d.shape[2:])     # () scalar, (Dy,) multi-output
    for j, t in enumerate(theta):
        if tuple(t.shape[1:]) != out_tail:
            want = (f"[D_j, Dy={out_tail[0]}]" if out_tail
                    else "[D_j] (scalar targets)")
            raise ValueError(
                f"theta[{j}] has shape {tuple(t.shape)} but this packing "
                f"carries {want} per-node θ — this θ was packed under a "
                f"different output width Dy and cannot be re-laid-out "
                f"silently. Re-derive it for the current targets.")
        limit = (packed.node_dims[j] if packed.node_dims is not None
                 else d_max)
        if t.shape[0] > limit:
            raise ValueError(
                f"theta[{j}] has {t.shape[0]} coordinates but node {j} "
                f"has D_j = {limit} (D_max = {d_max}) — this θ is stale "
                f"against the packed layout. Re-derive it for the current "
                f"dims.")
    out = torch.zeros((packed.num_nodes, d_max) + out_tail,
                      dtype=packed.d.dtype, device=packed.device)
    for j, t in enumerate(theta):
        out[j, :t.shape[0]] = t
    return out


def unpack_theta(packed: PackedProblem,
                 theta: torch.Tensor) -> list[torch.Tensor]:
    """Padded [J, D_max] (or [J, D_max, Dy]) θ → ragged per-node list,
    after checking θ against the packed layout (feature and output
    width)."""
    if packed.node_dims is None:
        raise ValueError("packed problem has no node_dims recorded")
    want = tuple(packed.d.shape)
    if tuple(theta.shape) != want:
        raise ValueError(
            f"unpack_theta got θ of shape {tuple(theta.shape)} for a "
            f"packed problem of θ-shape {want} (Dy = "
            f"{packed.num_outputs}) — this θ belongs to a different "
            f"packing. Unpack it with its own packing, then re-pack.")
    return [theta[j, :dj] for j, dj in enumerate(packed.node_dims)]


# --------------------------------------------------------------------------
# One Eq. 19 round and the solve
# --------------------------------------------------------------------------
_BACKENDS = ("torch", "cuda", "cuda_fused")
# Default tol-check cadence of the fused solve: surfacing θ every round
# would take away what fusing the rounds gains.
_FUSED_CHUNK_DEFAULT = 32


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, "
                         f"got {backend!r}")


def _step_torch(packed: PackedProblem, theta: torch.Tensor,
                nbr_theta: torch.Tensor | None = None) -> torch.Tensor:
    """The batched matmul round on [J, D, Dy] (scalar θ rides as Dy = 1,
    so both layouts run the same arithmetic). ``nbr_theta`` [J, K, D(, Dy)]
    replaces the gather ``theta[nbr_idx]`` as the coupling source."""
    th = theta if theta.ndim == 3 else theta[..., None]
    if nbr_theta is None:
        nbr = th[packed.nbr_idx.long()]
    else:
        nbr = nbr_theta if theta.ndim == 3 else nbr_theta[..., None]
    nbr = nbr * packed.nbr_mask[:, :, None, None].to(th.dtype)
    coupled = (packed.p @ nbr).sum(dim=1)                 # [J, D, Dy]
    d = packed.d if packed.d.ndim == 3 else packed.d[..., None]
    new = packed.g @ (d + packed.s @ th + coupled)
    return new if theta.ndim == 3 else new[..., 0]


def _self_idx(packed: PackedProblem) -> torch.Tensor:
    return torch.arange(packed.num_nodes, dtype=torch.int32,
                        device=packed.device)


def step_batched(packed: PackedProblem, theta: torch.Tensor,
                 backend: str = "cuda", *,
                 active: torch.Tensor | None = None,
                 nbr_theta: torch.Tensor | None = None) -> torch.Tensor:
    """One Jacobi round of Eq. 19 over all nodes, where the packed
    tensors live. theta [J, D_max] → [J, D_max] (or [J, D_max, Dy]).
    Padding stays exactly zero.

    ``backend="torch"`` is the batched matmul round; ``"cuda"`` and
    ``"cuda_fused"`` run the `dekrr_step` kernel (its plain version on
    CPU tensors) — the two differ only at the solve level.

    Two extras serve the asynchronous gossip (`repro_torch.dist.
    async_gossip`):

    * ``active`` ([J], any dtype): nodes with active[j] == 0 pass their θ
      rows through — `torch.where` on "torch", the masked kernel on the
      ``cuda*`` backends. Omitted or all ones, the round is the
      synchronous one bit for bit.
    * ``nbr_theta`` ([J, K, D_max(, Dy)]): the staleness buffers to couple
      against instead of ``theta[nbr_idx]``. On the ``cuda*`` backends
      they are appended below θ as table rows J + j·K + k and the slot
      table points there, so the kernel gathers as before.
    """
    _check_backend(backend)
    if backend == "torch":
        new = _step_torch(packed, theta, nbr_theta)
        if active is None:
            return new
        gate = (active != 0).reshape((-1,) + (1,) * (theta.ndim - 1))
        return torch.where(gate, new, theta)
    from repro_torch.kernels.ops import dekrr_step

    j_nodes, k_slots = packed.num_nodes, packed.num_slots
    if nbr_theta is None:
        table, nbr_idx = theta, packed.nbr_idx
    else:
        table = torch.cat([theta, nbr_theta.reshape(
            (j_nodes * k_slots,) + tuple(theta.shape[1:]))])
        nbr_idx = j_nodes + torch.arange(
            j_nodes * k_slots, dtype=torch.int32,
            device=packed.device).reshape(j_nodes, k_slots)
    return dekrr_step(packed.g, packed.d, packed.s, packed.p, table,
                      nbr_idx, _self_idx(packed), packed.nbr_mask, active)


def _run_rounds(packed: PackedProblem, theta: torch.Tensor, num_rounds: int,
                backend: str, trace: bool):
    """`num_rounds` rounds from `theta` → (θ, per-round residuals [R] or
    None). "cuda_fused" is one `dekrr_solve` launch; the per-round
    backends loop `step_batched`, keeping the residuals on the device."""
    if num_rounds == 0:
        res = theta.new_zeros((0,)) if trace else None
        return theta, res
    if backend == "cuda_fused":
        from repro_torch.kernels.ops import dekrr_solve

        out = dekrr_solve(packed.g, packed.d, packed.s, packed.p, theta,
                          packed.nbr_idx, _self_idx(packed), packed.nbr_mask,
                          num_rounds=num_rounds, trace=trace)
        if trace:
            return out[0], torch.amax(out[1], dim=1)
        return out, None
    res = []
    for _ in range(num_rounds):
        new = step_batched(packed, theta, backend=backend)
        if trace:
            res.append(torch.max(torch.abs(new - theta)))
        theta = new
    return theta, (torch.stack(res) if trace else None)


def solve_batched(packed: PackedProblem, num_iters: int,
                  theta0: torch.Tensor | None = None,
                  backend: str = "cuda_fused", *, tol: float = 0.0,
                  chunk_rounds: int | None = None,
                  return_rounds: bool = False,
                  return_trace: bool = False):
    """Run up to `num_iters` rounds from θ = 0 (or theta0).

    ``backend="torch"|"cuda"`` loop the per-round step;
    ``"cuda_fused"`` runs whole blocks of rounds in one `dekrr_solve`
    launch.

    ``tol > 0`` stops early once max|θ^{k+c} − θ^k| < tol, checked every
    `chunk_rounds` rounds (default 1 on the per-round backends and
    ``_FUSED_CHUNK_DEFAULT`` on "cuda_fused"; one host read per check).
    ``chunk_rounds`` without tol chunks the rounds the same way; the
    result does not depend on it.

    ``return_rounds=True`` adds the number of rounds run (an int);
    ``return_trace=True`` adds a `SolveTrace` whose residuals [num_iters]
    hold max|θ^{r+1} − θ^r| per round (0 after a tol stop). Return order
    is ``(theta[, rounds][, trace])``.
    """
    _check_backend(backend)
    if tol < 0:
        raise ValueError(f"tol must be >= 0, got {tol}")
    if chunk_rounds is not None and chunk_rounds < 1:
        raise ValueError(f"chunk_rounds must be >= 1, got {chunk_rounds}")
    theta = torch.zeros_like(packed.d) if theta0 is None else theta0
    num_iters = int(num_iters)
    if chunk_rounds is not None:
        chunk = chunk_rounds
    elif tol > 0:
        chunk = _FUSED_CHUNK_DEFAULT if backend == "cuda_fused" else 1
    else:
        chunk = num_iters
    chunk = min(chunk, max(num_iters, 1))
    residuals = theta.new_zeros((num_iters,)) if return_trace else None

    rounds = 0
    with span("solve"):
        while rounds < num_iters:
            n = min(chunk, num_iters - rounds)
            new, res = _run_rounds(packed, theta, n, backend, return_trace)
            if return_trace:
                residuals[rounds:rounds + n] = res
            converged = False
            if tol > 0:
                with span("solve.tol_read"):     # the host waits on the chain
                    converged = float(torch.max(torch.abs(new - theta))) < tol
            theta = new
            rounds += n
            if converged:
                break

    out = (theta,)
    if return_rounds:
        out += (rounds,)
    if return_trace:
        out += (SolveTrace(residuals=residuals),)
    return out if len(out) > 1 else theta


# --------------------------------------------------------------------------
# SPMD: one node per rank of a torch.distributed process group
# --------------------------------------------------------------------------
_MODES = ("ppermute", "allgather")

# θ bytes this process received from other ranks in SPMD exchanges, and
# the exchanges run (the wire check of the SPMD solvers reads them).
EXCHANGES = {"exchanges": 0, "bytes": 0}


def reset_exchange_counts() -> None:
    for k in EXCHANGES:
        EXCHANGES[k] = 0


def exchange_counts() -> dict[str, int]:
    return dict(EXCHANGES)


def _host_staged(group) -> bool:
    """Gloo's point-to-point calls take host tensors only, so a gloo group
    moves card-resident θ through host buffers. That is the group's own
    property: the backend is whatever the caller's group runs."""
    return dist.get_backend(group) == "gloo"


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _make_exchange(mode: str, group, offsets: tuple[int, ...] | None,
                   slots: Sequence[int]):
    """Per-rank neighbour exchange ``vec [1, W…] → [K, W…]`` — the one
    wiring the sync and async SPMD solvers share (their bit-for-bit
    equivalence at full activation rests on it).

    ``"ppermute"``: for each circulant offset s one forward shift (receive
    from node j+s) and one backward shift (receive from j−s), in the
    packed slot order [(+s₁), (−s₁), (+s₂), …], through one
    `dist.batch_isend_irecv`. ``"allgather"``: every rank's row 0 is
    gathered, then this node's ``slots`` (its `nbr_idx` row) are taken.
    On a gloo group, θ on the card goes through host buffers and the
    received rows are copied back.
    """
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    stage = _host_staged(group)
    slots = [int(k) for k in slots]

    def exchange(vec: torch.Tensor) -> torch.Tensor:
        send = (vec.cpu() if stage else vec).contiguous()
        if mode == "ppermute":
            recvs, p2p = [], []
            for m, shift in enumerate(offsets):
                for tag, src, dst in ((2 * m, rank + shift, rank - shift),
                                      (2 * m + 1, rank - shift,
                                       rank + shift)):
                    buf = torch.empty_like(send)
                    p2p += [dist.P2POp(dist.isend, send,
                                       _global_rank(group, dst % world),
                                       group, tag),
                            dist.P2POp(dist.irecv, buf,
                                       _global_rank(group, src % world),
                                       group, tag)]
                    recvs.append(buf)
            if p2p:
                for work in dist.batch_isend_irecv(p2p):
                    work.wait()
            from_others = len(recvs)
        else:
            everyone = [torch.empty_like(send) for _ in range(world)]
            dist.all_gather(everyone, send, group=group)
            recvs = [everyone[k] for k in slots]
            from_others = world - 1
        EXCHANGES["exchanges"] += 1
        EXCHANGES["bytes"] += from_others * send.numel() * send.element_size()
        out = (torch.cat(recvs) if recvs
               else send.new_zeros((0,) + tuple(send.shape[1:])))
        return out.to(vec.device)

    return exchange


def _all_max(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of ``t`` over the group's ranks, on t's device."""
    buf = (t.cpu() if _host_staged(group) else t).clone(
        memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return buf.to(t.device)


def _all_rows(row: torch.Tensor, group) -> torch.Tensor:
    """Every rank's [1, …] row, stacked in rank order, on row's device."""
    send = (row.cpu() if _host_staged(group) else row).contiguous()
    rows = [torch.empty_like(send)
            for _ in range(dist.get_world_size(group))]
    dist.all_gather(rows, send, group=group)
    return torch.cat(rows).to(row.device)


def _check_spmd_problem(packed: PackedProblem, group, mode: str) -> None:
    """Launch-time validation shared by the sync and async SPMD solvers:
    one node per rank of the group, and the circulant slot layout when
    the exchange is ring shifts."""
    j_nodes = packed.num_nodes
    world = dist.get_world_size(group)
    if world != j_nodes:
        raise ValueError(
            f"the process group has {world} ranks but the problem has "
            f"{j_nodes} nodes (one node per rank)")
    if mode == "ppermute":
        if packed.offsets is None:
            raise ValueError(
                "ppermute mode needs a circulant-packed problem "
                "(packed.offsets is None — use mode='allgather')")
        if packed.num_slots != 2 * len(packed.offsets):
            raise ValueError("slot table is not in circulant layout")


def _check_spmd_args(mode: str, backend: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    _check_backend(backend)


def _rank_device(device) -> torch.device:
    """The rank's device: the current card unless the caller names one."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class _NodeRound:
    """This rank's node: its rows of the packed problem on its device, and
    one Eq. 19 round on the local θ table [own θ; K neighbour θ] — the
    batched matmul round (``torch``) or the `dekrr_step` kernel with
    ``nbr_idx = [[1 … K]]`` and ``self_idx = [0]`` (``cuda``;
    ``cuda_fused`` too: rounds cannot fuse across the exchange). The
    index tables are built once, here."""

    def __init__(self, packed: PackedProblem, group, device: torch.device,
                 backend: str):
        self.rank = r = dist.get_rank(group)
        rows = lambda t: t[r:r + 1].to(device).contiguous()   # noqa: E731
        k_slots = packed.num_slots
        self.node = PackedProblem(
            g=rows(packed.g), d=rows(packed.d), s=rows(packed.s),
            p=rows(packed.p), theta_mask=rows(packed.theta_mask),
            nbr_idx=torch.arange(1, k_slots + 1, dtype=torch.int32,
                                 device=device)[None],
            nbr_mask=rows(packed.nbr_mask), offsets=packed.offsets)
        self.slots = packed.nbr_idx[r].tolist()
        self.self_idx = torch.zeros((1,), dtype=torch.int32, device=device)
        self.backend = backend

    def __call__(self, theta: torch.Tensor, nbr: torch.Tensor,
                 active: torch.Tensor | None = None) -> torch.Tensor:
        """theta [1, D(, Dy)], nbr [K, D(, Dy)], active [1] or None."""
        node = self.node
        if self.backend == "torch":
            new = _step_torch(node, theta, nbr[None])
            if active is None:
                return new
            gate = (active != 0).reshape((1,) + (1,) * (theta.ndim - 1))
            return torch.where(gate, new, theta)
        from repro_torch.kernels.ops import dekrr_step

        return dekrr_step(node.g, node.d, node.s, node.p,
                          torch.cat([theta, nbr]), node.nbr_idx,
                          self.self_idx, node.nbr_mask, active)


def make_spmd_solver(group=None, mode: str = "ppermute",
                     backend: str = "cuda", *, device=None):
    """Build ``run(packed, num_iters, theta0=None, *, tol=0.0,
    return_rounds=False, return_trace=False)`` for one node per rank of
    ``group`` (the default group when None): rank r IS node r, keeps only
    its node's G/d/S/P on ``device`` (the current card unless the caller
    names another) and exchanges only θ with its neighbours each round:

      * ``"ppermute"``: one ring shift each way per circulant offset
        (a circulant-packed problem only); Σ_j |N_j| · D_max rows a round;
      * ``"allgather"``: gather every rank's θ, take the slots; any
        topology; J · (J − 1) · D_max rows a round.

    ``backend`` picks the round: "torch" (`_step_torch` on the one-node
    slice) or "cuda" (the `dekrr_step` kernel on the local θ table; its
    plain version on CPU tensors). "cuda_fused" is accepted and runs the
    per-round kernel: each round waits for the exchange, so rounds cannot
    fuse across it.

    The runner:

      * ``theta0`` ([J, D_max(, Dy)]) warm-starts the iteration; each rank
        takes its row.
      * ``tol > 0`` stops early: every round the rank's max|Δθ| goes
        through one all-reduce (max), so every rank takes the same stop
        decision; nothing runs after the converging round. θ and the
        rounds match ``solve_batched(..., tol=tol, chunk_rounds=1)``.
      * ``return_rounds`` appends the rounds run (an int);
        ``return_trace`` a `SolveTrace` of the network-wide per-round
        max|Δθ| [num_iters] (0 after a stop): each rank records its own
        series and one all-reduce after the loop combines them.

    θ comes back as [J, D_max(, Dy)] on every rank, on its device. Return
    order: ``(theta[, rounds][, trace])``.
    """
    _check_spmd_args(mode, backend)
    device = _rank_device(device)

    def run(packed: PackedProblem, num_iters: int,
            theta0: torch.Tensor | None = None, *, tol: float = 0.0,
            return_rounds: bool = False, return_trace: bool = False):
        _check_spmd_problem(packed, group, mode)
        if tol < 0:
            raise ValueError(f"tol must be >= 0, got {tol}")
        num_iters = int(num_iters)
        step = _NodeRound(packed, group, device, backend)
        exchange = _make_exchange(mode, group, packed.offsets, step.slots)
        r = step.rank
        theta = (torch.zeros_like(step.node.d) if theta0 is None
                 else theta0[r:r + 1].to(device))
        residuals = theta.new_zeros((num_iters,)) if return_trace else None
        rounds = 0
        while rounds < num_iters:
            new = step(theta, exchange(theta))
            if return_trace or tol > 0:
                local = torch.amax(torch.abs(new - theta))
            if return_trace:
                residuals[rounds] = local
            rounds += 1
            converged = tol > 0 and float(_all_max(local, group)) < tol
            theta = new
            if converged:
                break
        out = (_all_rows(theta, group),)
        if return_rounds:
            out += (rounds,)
        if return_trace:
            out += (SolveTrace(residuals=_all_max(residuals, group)),)
        return out if len(out) > 1 else out[0]

    return run


# --------------------------------------------------------------------------
# §II-C communication cost model
# --------------------------------------------------------------------------


def comm_bytes_per_round(packed: PackedProblem, mode: str, *,
                         activation_prob: float = 1.0,
                         censor_fraction: float = 0.0,
                         gossip: str = "bernoulli") -> int | float:
    """(Expected) bytes moved across the network per Eq. 19 round.

    ``"ppermute"`` (neighbour exchange): Σ_j |N_j| · D_max · Dy · itemsize;
    ``"allgather"``: J · (J−1) · D_max · Dy · itemsize. Async gossip
    scales it to the expected payload: ``gossip="bernoulli"`` by
    p · (1 − c); ``gossip="edge"`` is two censored deliveries per round.
    The synchronous defaults return an exact int.
    """
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if not 0.0 < activation_prob <= 1.0:
        raise ValueError(f"activation_prob must be in (0, 1], "
                         f"got {activation_prob}")
    if not 0.0 <= censor_fraction <= 1.0:
        raise ValueError(f"censor_fraction must be in [0, 1], "
                         f"got {censor_fraction}")
    if gossip not in ("bernoulli", "edge"):
        raise ValueError(f"gossip must be 'bernoulli' or 'edge', "
                         f"got {gossip!r}")
    j_nodes = packed.num_nodes
    d_max = packed.max_features * packed.num_outputs
    itemsize = packed.d.element_size()
    if gossip == "edge":
        return 2 * d_max * itemsize * (1.0 - censor_fraction)
    if mode == "ppermute":
        edges = packed.num_edges_directed
        if edges is None:
            edges = int(torch.count_nonzero(packed.nbr_mask))
        base = edges * d_max * itemsize
    else:
        base = j_nodes * (j_nodes - 1) * d_max * itemsize
    if activation_prob == 1.0 and censor_fraction == 0.0:
        return base
    return base * activation_prob * (1.0 - censor_fraction)
