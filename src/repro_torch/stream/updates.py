"""Incremental maintenance of the Eq. 17 auxiliaries under streaming data.

The counterpart of `repro.stream.updates`. The batch build
(`repro_torch.dist.pack_problem`) forms every node's auxiliaries from all
data at once: O(D² N) featurize and Gram work plus an O(D³) inverse a
node. When node j ingests a minibatch (X_b, Y_b) of b samples, only
low-rank pieces of the network state change, and this module folds them
in exactly:

  * Gram_jj              += Z_b,j Z_b,jᵀ      (node j's map on the batch)
  * Gram(Z_{p,j}), p∈N_j += Z_b,p Z_b,pᵀ      (each neighbour's map on it)
  * d̃_j                  += Z_b,j Y_bᵀ
  * S̃_j                  += (2c_self,j/|N̂_j|) Z_b,j Z_b,jᵀ
  * P̃_{j,p} / P̃_{p,j}    += rank-b cross terms Z_b,j Z_b,pᵀ / Z_b,p Z_b,jᵀ

so each Eq. 17 matrix A_i of the 1 + |N_j| affected nodes moves by a
rank-b symmetric update c·U Uᵀ, and its maintained inverse follows by the
Woodbury identity

    G ← G − (G U) (c⁻¹ I_b + Uᵀ G U)⁻¹ (G U)ᵀ            — O(D² b + b³)

instead of an O(D³) re-inversion. The 1 + |N_j| nodes update as one
batched program (`ingest`), gathered and scattered through the packed
[J, D_max, …] layout, so an ingest costs O(deg · D² b) whatever J or the
accumulated sample count.

Normalization. Every data term of Eq. 17 carries a global 1/N, which
would couple every node's matrix to every ingest. The state therefore
lives in unnormalized space, where the coefficients are N-free:

    B_j = u_self,j Gram_jj + Σ_{p∈N_j} u_cross,p Gram(Z_{j,p})
    u_self,j  = 1 + (2 c_self,j + |N_j| c_nei,j) / |N̂_j|
    u_cross,j = c_nei,j / |N̂_j|

and `to_packed` re-applies the live 1/N when it materializes a
`PackedProblem` (an elementwise rescale; the Eq. 19 round map does not
change under it). The ridge is the one term that is not a rescale: the
paper's (λ/J) I sits outside the 1/N, so in unnormalized space it is ν I
with ν = λ N/J. The stream pins ν at construction (ν = λ n_ref / J,
n_ref = the sample count at stream start), the online-ridge convention.
The stream state after any ingest sequence then equals `pack_problem` on
the accumulated data with λ_eff = λ · n_ref / n_live (`reference_lam`),
at rtol 1e-9 in float64 while cond(A) ≲ 1e6 (Woodbury and a direct
inverse agree to about cond·eps).

A per-node DDRF feature refresh (new frequencies, possibly a new D_j) is
not low-rank: every term with the node's feature map changes basis.
`refresh_node` rebuilds exactly that node's slot, and the P̃_{p,·} slots
of its neighbours that couple against it, from the accumulated data; it
leaves every other node's inverse untouched and re-pads the layout when
max(node_dims) changes.

Device discipline. Every tensor of the state lies on the solver's device.
The per-node tables an ingest reads (`ingest_tables`: the affected rows,
their gates, their Woodbury coefficients and the reverse slots) are made
there once, and the coupling coefficients are host floats, so an ingest
reads nothing back from the device. The arrays are functional: `ingest`
and `refresh_node` return a new `StreamAux` and never write into the
tensors of the one they were given.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.rff import FeatureMap
from repro_torch.dist.dekrr_spmd import (PackedProblem, _featurize_raw,
                                        _gauss_jordan_inv, _pack_rows,
                                        _stage_feature_maps, pack_problem)

__all__ = [
    "StreamAux",
    "init_stream_aux",
    "ingest",
    "refresh_node",
    "to_packed",
    "repad_theta",
    "reference_lam",
]


# --------------------------------------------------------------------------
# State container
# --------------------------------------------------------------------------
@dataclasses.dataclass
class StreamAux:
    """Streaming sufficient statistics in the packed [J, D_max, …] layout.

    Tensors (unnormalized space, see the module docstring), all on one
    device:
      binv: [J, D_max, D_max]    (B_j + ν I)⁻¹, Woodbury-maintained; the
                                 padded diagonal block is the identity
                                 (masked off at materialization).
      zy:   [J, D_max]           d̃_j = Z_jj Y_jᵀ ([J, D_max, Dy] for a
                                 multi-output stream).
      st:   [J, D_max, D_max]    S̃_j.
      pt:   [J, K, D_max, D_max] P̃_{j, nbr_idx[j,k]}.
      theta_mask / nbr_idx / nbr_mask: the packed layout tables
                                 (`repro_torch.dist.PackedProblem`).
      omega [J, F_max, d], bias [J, F_max], feat_idx [J, D_max] (int64),
      scale [J]: the staged feature maps (`_stage_feature_maps`), which
                                 let any node featurize a minibatch in one
                                 padded program.
      ingest_tables: (idx [J, 1+K] int64, gate [J, 1+K], cvec [J, 1+K],
                                 rslot [J, K] int64) — each node's
                                 affected rows (itself, then its slots),
                                 live-slot gates, Woodbury coefficients
                                 and reverse slots, made once on the
                                 device so an ingest reads nothing back.

    Host metadata: u_self / u_cross / u_s [J] (numpy, the N-free coupling
    coefficients), rslot [J, K] (numpy: rslot[j, k] = the slot of node j
    inside node nbr_idx[j, k]'s table, 0 on masked slots), n_live (the
    accumulated sample count, the 1/N of materialization), nu (the pinned
    ridge λ·n_ref/J), n_ref, node_dims, offsets and kind.
    """

    binv: torch.Tensor
    zy: torch.Tensor
    st: torch.Tensor
    pt: torch.Tensor
    theta_mask: torch.Tensor
    nbr_idx: torch.Tensor
    nbr_mask: torch.Tensor
    omega: torch.Tensor
    bias: torch.Tensor
    feat_idx: torch.Tensor
    scale: torch.Tensor
    u_self: np.ndarray
    u_cross: np.ndarray
    u_s: np.ndarray
    ingest_tables: tuple
    rslot: np.ndarray
    n_live: int
    nu: float
    n_ref: int
    node_dims: tuple[int, ...]
    offsets: tuple[int, ...] | None
    kind: str

    @property
    def num_nodes(self) -> int:
        return int(self.zy.shape[0])

    @property
    def max_features(self) -> int:
        return int(self.zy.shape[1])

    @property
    def num_slots(self) -> int:
        return int(self.nbr_idx.shape[1])

    @property
    def device(self) -> torch.device:
        return self.zy.device


def reference_lam(aux: StreamAux) -> float:
    """The ridge a from-scratch `DeKRRSolver` on the accumulated data must
    use to reproduce this stream state exactly: λ_eff = ν·J/N_live
    (= λ·n_ref/n_live, the pinned ridge at the live normalization)."""
    return aux.nu * aux.num_nodes / aux.n_live


def _as_tensor(a, **kw) -> torch.Tensor:
    """An owned copy of a tensor or array-like (a read-only numpy array
    is fine), on the device and dtype `kw` name: the stream keeps what it
    is given, so a caller's later writes cannot reach its state. Host
    data goes to a CUDA device from pinned memory without a wait, so an
    ingest never stalls the host on the device's queue."""
    if isinstance(a, torch.Tensor):
        return a.to(**kw, copy=True)
    host = torch.from_numpy(np.array(a))
    if torch.device(kw.get("device") or "cpu").type == "cuda":
        return host.pin_memory().to(**kw, non_blocking=True)
    return host.to(**kw)


# --------------------------------------------------------------------------
# Layout helpers (the feature-map staging, featurize and row packing are
# pack_problem's own, so the two can never drift apart)
# --------------------------------------------------------------------------
def _reverse_slots(nbr_idx: np.ndarray, nbr_mask: np.ndarray) -> np.ndarray:
    """rslot[j, k] = slot index of node j inside node nbr_idx[j, k]'s
    table (0 on masked slots, whose updates are exact zeros)."""
    j_nodes, k_slots = nbr_idx.shape
    rslot = np.zeros((j_nodes, k_slots), dtype=np.int32)
    for j in range(j_nodes):
        for k in range(k_slots):
            if not nbr_mask[j, k]:
                continue
            p = int(nbr_idx[j, k])
            (hits,) = np.nonzero((nbr_idx[p] == j) & (nbr_mask[p] != 0))
            rslot[j, k] = int(hits[0])
    return rslot


def _ingest_tables(nbr_idx: np.ndarray, nbr_mask: np.ndarray,
                   u_self: np.ndarray, u_cross: np.ndarray,
                   rslot: np.ndarray, dtype: torch.dtype,
                   device: torch.device) -> tuple:
    """Per-node (idx, gate, cvec, rslot) rows of `ingest` as device
    tensors, constant between refreshes."""
    j_nodes, k_slots = nbr_idx.shape
    idx = np.concatenate([np.arange(j_nodes)[:, None], nbr_idx], axis=1)
    gate = np.concatenate([np.ones((j_nodes, 1)), (nbr_mask != 0)], axis=1)
    cvec = np.concatenate(
        [u_self[:, None], np.broadcast_to(u_cross[:, None],
                                          (j_nodes, k_slots))], axis=1)
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                         device=device)
    return (as_t(idx, torch.int64), as_t(gate, dtype), as_t(cvec, dtype),
            as_t(rslot, torch.int64))


def init_stream_aux(solver, packed: PackedProblem | None = None
                    ) -> StreamAux:
    """Seed the streaming state from a `DeKRRSolver`.

    Uses (or builds, on the solver's device) the batched `pack_problem`
    of the solver and converts it to unnormalized space: binv = g/N (plus
    identity padding; the packed g is N·(B + νI)⁻¹ on live coordinates),
    d̃ = d·N, S̃ = s·N, P̃ = p·N. Pins the ridge at ν = λ·N/J.
    """
    if getattr(solver, "_gram_fn", None) is not None:
        raise ValueError("repro_torch.stream cannot maintain auxiliaries "
                         "built through a custom gram_fn")
    if any(getattr(nd, "bags", None) is not None for nd in solver.data):
        raise ValueError(
            "repro_torch.stream cannot maintain auxiliaries for "
            "aggregate-observation (bagged) nodes — a bag couples its "
            "members through the label term, so a minibatch fold is not "
            "rank-b in the bagged Gram")
    if packed is None:
        packed = pack_problem(solver, device=solver.device)
    dtype, device = packed.d.dtype, packed.device
    n = solver.N
    staged = _stage_feature_maps(solver.feature_maps, dtype, device)
    if staged["node_dims"] != packed.node_dims:
        raise ValueError("solver feature maps disagree with packed.node_dims")

    mask = packed.theta_mask
    pad_eye = torch.eye(packed.max_features, dtype=dtype, device=device)[None] \
        * (1.0 - mask)[:, :, None] * (1.0 - mask)[:, None, :]
    binv = packed.g / n + pad_eye

    degs = solver.topology.degrees.astype(np.float64)
    hood = degs + 1.0
    c_nei = np.asarray(solver.c_nei, np.float64)
    c_self = np.asarray(solver.c_self, np.float64)
    u_self = 1.0 + (2.0 * c_self + degs * c_nei) / hood
    u_cross = c_nei / hood
    u_s = 2.0 * c_self / hood

    nbr_idx = packed.nbr_idx.cpu().numpy().astype(np.int64)
    nbr_mask = packed.nbr_mask.cpu().numpy()
    rslot = _reverse_slots(nbr_idx, nbr_mask)
    return StreamAux(
        binv=binv, zy=packed.d * n, st=packed.s * n, pt=packed.p * n,
        theta_mask=mask, nbr_idx=packed.nbr_idx, nbr_mask=packed.nbr_mask,
        omega=staged["omega"], bias=staged["bias"],
        feat_idx=staged["feat_idx"], scale=staged["scale"],
        u_self=u_self, u_cross=u_cross, u_s=u_s,
        ingest_tables=_ingest_tables(nbr_idx, nbr_mask, u_self, u_cross,
                                     rslot, dtype, device),
        rslot=rslot, n_live=int(n),
        nu=float(solver.config.lam * n / solver.J), n_ref=int(n),
        node_dims=packed.node_dims, offsets=packed.offsets,
        kind=staged["kind"])


# --------------------------------------------------------------------------
# Rank-b Woodbury ingest — one batched program over the affected nodes
# --------------------------------------------------------------------------
def _packed_featurize(omega, bias, feat_idx, feat_mask, scale, x, col_mask,
                      kind):
    """Node maps on a minibatch in packed feature space, batched over any
    leading axes: [..., D_max, B]. `pack_problem`'s own featurize and row
    packing, so the stream and the batch build round alike."""
    return _pack_rows(_featurize_raw(omega, bias, x, kind), feat_idx,
                      feat_mask, scale, col_mask)


def _fold(binv, zy, st, pt, theta_mask, omega, bias, feat_idx, scale,
          idx, gate, cvec, rslot_j, u_s_j, u_cross_j, xb, yb, col_mask, *,
          kind):
    """Fold one minibatch at node idx[0] into (binv, zy, st, pt); returns
    new tensors.

    idx [1+K]: the affected rows (the node, then its slot table; padded
    slots repeat the node's own index); gate [1+K]: 1.0 for the node and
    live slots, 0.0 for padded ones (their contributions are exact
    zeros); cvec [1+K]: the rank-b coefficients (u_self of the node, then
    its u_cross for every neighbour row). Every scatter accumulates, so
    the padded slots' repeats of the node add zeros to its own update
    instead of overwriting it.
    """
    zb = _packed_featurize(omega[idx], bias[idx], feat_idx[idx],
                           theta_mask[idx], scale[idx], xb, col_mask, kind)
    zb = zb * gate[:, None, None]                      # [A, D_max, B]

    # Woodbury: G += -(G U)(c⁻¹I + Uᵀ G U)⁻¹(G U)ᵀ per affected node
    gu = binv[idx] @ zb                                # [A, D, B]
    utgu = zb.transpose(1, 2) @ gu                     # [A, B, B]
    live_c = cvec != 0
    safe_c = torch.where(live_c, cvec, torch.ones_like(cvec))
    eye = torch.eye(zb.shape[-1], dtype=zb.dtype, device=zb.device)
    mid = eye[None] / safe_c[:, None, None] + utgu
    sol = torch.linalg.solve_ex(mid, gu.transpose(1, 2))[0]   # [A, B, D]
    corr = -(gu @ sol) * live_c[:, None, None]
    binv = binv.index_add(0, idx, corr)

    zbj, zbn = zb[0], zb[1:]
    row = idx[:1]
    zy = zy.index_add(0, row, (zbj @ yb)[None])
    st = st.index_add(0, row, (u_s_j * (zbj @ zbj.T))[None])
    # P̃_{j,k} += u_cross[j]·Z_b,j Z_b,pᵀ ; P̃_{p,rslot} += u_cross[j]·Z_b,p Z_b,jᵀ
    pt = pt.index_add(0, row, (u_cross_j * (zbj @ zbn.transpose(1, 2)))[None])
    pt = pt.index_put((idx[1:], rslot_j), u_cross_j * (zbn @ zbj.T),
                      accumulate=True)
    return binv, zy, st, pt


def _bucket(b: int) -> int:
    """Pad minibatches to power-of-two widths (min 8), so the batched
    program sees one shape per bucket, not one per batch size."""
    return max(8, 1 << (b - 1).bit_length())


def ingest(aux: StreamAux, node: int, xb, yb) -> StreamAux:
    """Fold minibatch (xb [d, b], yb [b] — or [b, Dy] when the state
    carries a multi-output `zy` [J, D_max, Dy]) arriving at `node` into
    the stream state: O(deg · D² b) exact rank-b updates, no O(D³) work.
    xb and yb may be numpy arrays or tensors. Returns a new `StreamAux`;
    the given one is left as it was."""
    j = int(node)
    if not 0 <= j < aux.num_nodes:
        raise ValueError(f"node {j} out of range for J={aux.num_nodes}")
    kw = dict(dtype=aux.zy.dtype, device=aux.device)
    xb = _as_tensor(xb, **kw)
    yb = _as_tensor(yb, **kw)
    if aux.zy.ndim == 3:
        dy = aux.zy.shape[2]
        if yb.ndim != 2 or yb.shape[1] != dy:
            raise ValueError(f"multi-output stream (Dy={dy}) needs "
                             f"y [b, {dy}]; got {tuple(yb.shape)}")
    else:
        yb = yb.reshape(-1)
    if xb.ndim != 2 or xb.shape[1] != yb.shape[0]:
        raise ValueError(f"minibatch must be x [d, b], y [b]; got "
                         f"{tuple(xb.shape)} / {tuple(yb.shape)}")
    b = xb.shape[1]
    if b == 0:
        return aux
    bb = _bucket(b)
    col_mask = (torch.arange(bb, device=aux.device) < b).to(aux.zy.dtype)
    xb = F.pad(xb, (0, bb - b))
    yb = F.pad(yb, (0, 0, 0, bb - b) if yb.ndim == 2 else (0, bb - b))

    idx_t, gate_t, cvec_t, rslot_t = aux.ingest_tables
    binv, zy, st, pt = _fold(
        aux.binv, aux.zy, aux.st, aux.pt, aux.theta_mask, aux.omega,
        aux.bias, aux.feat_idx, aux.scale, idx_t[j], gate_t[j], cvec_t[j],
        rslot_t[j], float(aux.u_s[j]), float(aux.u_cross[j]), xb, yb,
        col_mask, kind=aux.kind)
    return dataclasses.replace(aux, binv=binv, zy=zy, st=st, pt=pt,
                               n_live=aux.n_live + b)


# --------------------------------------------------------------------------
# Per-node feature refresh (DDRF re-selection after drift)
# --------------------------------------------------------------------------
def _resize_packed(arr: torch.Tensor, old_d: int, new_d: int,
                   matrix_axes: tuple) -> torch.Tensor:
    """A new tensor with the feature axes of a packed tensor grown (zero
    padding) or shrunk to new_d. Shrinking only cuts padding, since
    new_d = max(new node_dims)."""
    if new_d > old_d:
        pad = [0] * (2 * arr.ndim)
        for ax in matrix_axes:
            pad[2 * (arr.ndim - 1 - ax) + 1] = new_d - old_d
        return F.pad(arr, pad)
    slicer = [slice(None)] * arr.ndim
    for ax in matrix_axes:
        slicer[ax] = slice(0, new_d)
    return arr[tuple(slicer)].clone()


def refresh_node(aux: StreamAux, node: int, new_fmap: FeatureMap,
                 feature_maps: Sequence[FeatureMap],
                 data_x: Sequence, data_y) -> StreamAux:
    """Rebuild node `node`'s slot after a DDRF feature refresh.

    `feature_maps` is the post-refresh list (entry `node` is `new_fmap`);
    `data_x[i]` is node i's accumulated inputs [d, N_i] (tensors or numpy;
    only the node and its live neighbours are read, other entries may be
    None); `data_y` the node's accumulated labels.

    Only state that involves the refreshed map is recomputed: the node's
    B/inverse/d̃/S̃/P̃ row and the neighbours' P̃ slots that couple against
    it. Neighbour B_p do not involve the node's map (their cross terms
    are fm_p on X_node, which is unchanged), so every other inverse keeps
    its bits. When max(node_dims) changes the whole layout re-pads; carry
    per-node θ across with `repad_theta`. The tensors stay on the state's
    device and the given state is left as it was.
    """
    j = int(node)
    kw = dict(dtype=aux.zy.dtype, device=aux.device)
    if feature_maps[j] is not new_fmap:
        raise ValueError(
            "feature_maps[node] must be the refreshed map itself — the "
            "slot is rebuilt from feature_maps, so a stale entry would "
            "silently rebuild with the OLD map")
    staged = _stage_feature_maps(feature_maps, kw["dtype"], kw["device"])
    new_dims = staged["node_dims"]
    if new_dims[:j] + new_dims[j + 1:] != \
            aux.node_dims[:j] + aux.node_dims[j + 1:]:
        raise ValueError("refresh_node may only change the refreshed "
                         "node's feature count")
    old_d = aux.max_features
    new_d = max(new_dims)

    # Re-pad to the new D_max (the grown region of binv gets its identity
    # padding back; shrinking only ever cuts padding).
    binv = _resize_packed(aux.binv, old_d, new_d, (1, 2))
    if new_d > old_d:
        grown = torch.arange(old_d, new_d, device=aux.device)
        binv[:, grown, grown] = 1.0
    zy = _resize_packed(aux.zy, old_d, new_d, (1,))
    st = _resize_packed(aux.st, old_d, new_d, (1, 2))
    pt = _resize_packed(aux.pt, old_d, new_d, (2, 3))
    fmask = staged["feat_mask"]
    omega, bias = staged["omega"], staged["bias"]
    feat_idx, scale = staged["feat_idx"], staged["scale"]

    def feats(i: int, x) -> torch.Tensor:
        x = _as_tensor(x, **kw)
        ones = torch.ones((x.shape[1],), **kw)
        return _packed_featurize(omega[i], bias[i], feat_idx[i], fmask[i],
                                 scale[i], x, ones, aux.kind)

    y_j = _as_tensor(data_y, **kw)
    y_j = y_j.reshape(-1, aux.zy.shape[2]) if aux.zy.ndim == 3 \
        else y_j.reshape(-1)
    z_self = feats(j, data_x[j])                       # [D', N_j]
    u_cross = aux.u_cross
    gram_self = z_self @ z_self.T
    b_new = float(aux.u_self[j]) * gram_self
    zy_new = z_self @ y_j
    st_new = float(aux.u_s[j]) * gram_self

    nbr_row = aux.nbr_idx[j].tolist()
    live_row = aux.nbr_mask[j].tolist()
    pt[j] = 0.0
    for k in range(aux.num_slots):
        if not live_row[k]:
            continue
        p = int(nbr_row[k])
        cj, cp = float(u_cross[j]), float(u_cross[p])
        z_jp = feats(j, data_x[p])                     # fm_new on X_p
        z_pj = feats(p, data_x[j])                     # fm_p on X_j
        z_pp = feats(p, data_x[p])                     # fm_p on X_p
        b_new = b_new + cp * (z_jp @ z_jp.T)
        pt[j, k] = cj * (z_self @ z_pj.T) + cp * (z_jp @ z_pp.T)
        pt[p, int(aux.rslot[j, k])] = cp * (z_pp @ z_jp.T) \
            + cj * (z_pj @ z_self.T)

    mj = fmask[j]
    a_unnorm = b_new + aux.nu * torch.diag(mj) + torch.diag(1.0 - mj)
    binv_j = _gauss_jordan_inv(a_unnorm[None])[0]
    binv[j] = binv_j * mj[:, None] * mj[None, :] + torch.diag(1.0 - mj)
    zy[j] = zy_new
    st[j] = st_new

    return dataclasses.replace(
        aux, binv=binv, zy=zy, st=st, pt=pt, theta_mask=fmask,
        omega=omega, bias=bias, feat_idx=feat_idx, scale=scale,
        node_dims=new_dims)


# --------------------------------------------------------------------------
# Materialization + θ carry
# --------------------------------------------------------------------------
def to_packed(aux: StreamAux) -> PackedProblem:
    """Materialize the live `PackedProblem` at the current normalization —
    an elementwise rescale (no inverse, no featurize). The result equals
    `pack_problem` on the accumulated data with λ_eff =
    `reference_lam(aux)` at rtol 1e-9 in float64, and plugs into every
    solver of the packed runtime (`solve_batched`, `async_solve_batched`,
    `repro_torch.core.acceleration`)."""
    n = torch.tensor(float(aux.n_live), dtype=aux.zy.dtype,
                     device=aux.device)
    mask = aux.theta_mask
    fouter = mask[:, :, None] * mask[:, None, :]
    num_edges = int(torch.count_nonzero(aux.nbr_mask))
    return PackedProblem(g=aux.binv * fouter * n, d=aux.zy / n,
                         s=aux.st / n, p=aux.pt / n, theta_mask=mask,
                         nbr_idx=aux.nbr_idx, nbr_mask=aux.nbr_mask,
                         offsets=aux.offsets, node_dims=aux.node_dims,
                         num_edges_directed=num_edges)


def repad_theta(theta, old_dims: Sequence[int], new_dims: Sequence[int],
                *, reset: Sequence[int] = ()) -> torch.Tensor:
    """Carry a packed θ across a node_dims change (feature refresh).

    Rows in `reset` (the refreshed nodes, whose θ lives in the old
    feature basis) restart from zero; every other row re-pads into the
    new [J, max(new_dims)] layout (a multi-output θ [J, max(old_dims), Dy]
    keeps its trailing Dy axis), on θ's device. A non-reset row whose D_j
    shrank is a stale iterate and raises: truncating it would silently
    drop live coordinates.
    """
    old_dims = tuple(int(v) for v in old_dims)
    new_dims = tuple(int(v) for v in new_dims)
    if len(old_dims) != len(new_dims):
        raise ValueError("node count cannot change across a refresh")
    theta = torch.as_tensor(theta)
    lead = (len(old_dims), max(old_dims))
    if tuple(theta.shape[:2]) != lead or theta.ndim not in (2, 3):
        raise ValueError(
            f"theta has shape {tuple(theta.shape)} but old_dims describe "
            f"{lead} (+ an optional trailing Dy axis) — pass the θ that "
            f"belongs to the OLD packing")
    reset = {int(r) for r in reset}
    out = theta.new_zeros((len(new_dims), max(new_dims))
                          + tuple(theta.shape[2:]))
    for i, (do, dn) in enumerate(zip(old_dims, new_dims)):
        if i in reset:
            continue
        if do > dn:
            raise ValueError(
                f"node {i} shrank from D_j={do} to {dn} but is not in "
                f"reset — its θ is stale against the refreshed basis")
        out[i, :do] = theta[i, :do]
    return out
