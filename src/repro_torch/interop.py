"""Carry state between the JAX reference package and the port as numpy
arrays.

The caller turns the reference's objects into numpy arrays
(`np.asarray` on each field); nothing here imports the reference. Field
names follow the reference's dataclasses, so
``packed_from_arrays(**{f: np.asarray(getattr(ref, f)) ...})`` carries a
reference `PackedProblem` across, and `packed_to_arrays` gives back the
fields to rebuild one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.dekrr import NodeData
from repro_torch.core.rff import FeatureMap
from repro_torch.dist.dekrr_spmd import PackedProblem
from repro_torch.models.model import ModelConfig, Params, param_shapes
from repro_torch.stream.runtime import ServeSnapshot, StalenessBound
from repro_torch.stream.updates import (StreamAux, _ingest_tables,
                                        _reverse_slots)

_ARRAY_FIELDS = ("g", "d", "s", "p", "theta_mask", "nbr_idx", "nbr_mask")
_STREAM_TENSORS = ("binv", "zy", "st", "pt", "theta_mask", "nbr_idx",
                   "nbr_mask", "omega", "bias", "feat_idx", "scale")
_STREAM_HOST = ("u_self", "u_cross", "u_s")
_STREAM_META = ("n_live", "nu", "n_ref", "node_dims", "offsets", "kind")


def feature_map_from_arrays(omega, bias, kind: str, *,
                            device=None) -> FeatureMap:
    """FeatureMap from ω [D, d] and b [D] (None for cos_sin)."""
    device = resolve_device(device)
    return FeatureMap(
        omega=torch.as_tensor(np.array(omega), device=device),
        bias=None if bias is None
        else torch.as_tensor(np.array(bias), device=device),
        kind=kind)


def node_data_from_arrays(x, y, bags=None, *, device=None) -> NodeData:
    device = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.array(a), device=device)
    return NodeData(x=as_t(x), y=as_t(y),
                    bags=None if bags is None else as_t(bags))


def packed_from_arrays(g, d, s, p, theta_mask, nbr_idx, nbr_mask, *,
                       offsets=None, node_dims=None,
                       num_edges_directed=None, device=None) -> PackedProblem:
    """PackedProblem from the reference's array fields and host metadata."""
    device = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.array(a), device=device)
    return PackedProblem(
        g=as_t(g), d=as_t(d), s=as_t(s), p=as_t(p),
        theta_mask=as_t(theta_mask),
        nbr_idx=as_t(np.asarray(nbr_idx, dtype=np.int32)),
        nbr_mask=as_t(nbr_mask),
        offsets=None if offsets is None else tuple(offsets),
        node_dims=None if node_dims is None else tuple(node_dims),
        num_edges_directed=num_edges_directed)


def packed_to_arrays(packed: PackedProblem) -> dict:
    """The inverse of `packed_from_arrays`: numpy arrays plus metadata,
    keyed by the reference's field names."""
    out = {f: to_numpy(getattr(packed, f)) for f in _ARRAY_FIELDS}
    out.update(offsets=packed.offsets, node_dims=packed.node_dims,
               num_edges_directed=packed.num_edges_directed)
    return out


def stream_aux_from_arrays(binv, zy, st, pt, theta_mask, nbr_idx, nbr_mask,
                           omega, bias, feat_idx, scale, u_self, u_cross,
                           u_s, *, n_live, nu, n_ref, node_dims,
                           offsets=None, kind, device=None) -> StreamAux:
    """A stream state from the reference `StreamAux`'s array fields and
    metadata, so one stream can be continued on both sides. The slot
    tables an ingest reads (`ingest_tables`, `rslot`) follow from the
    slot table and the coefficients and are made here."""
    device = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.array(a), device=device)
    nbr_idx = np.asarray(nbr_idx, dtype=np.int64)
    nbr_mask = np.asarray(nbr_mask)
    u_self, u_cross, u_s = (np.array(u, dtype=np.float64)
                            for u in (u_self, u_cross, u_s))
    zy = as_t(zy)
    rslot = _reverse_slots(nbr_idx, nbr_mask)
    return StreamAux(
        binv=as_t(binv), zy=zy, st=as_t(st), pt=as_t(pt),
        theta_mask=as_t(theta_mask),
        nbr_idx=as_t(nbr_idx.astype(np.int32)), nbr_mask=as_t(nbr_mask),
        omega=as_t(omega), bias=as_t(bias),
        feat_idx=as_t(np.asarray(feat_idx, dtype=np.int64)),
        scale=as_t(scale), u_self=u_self, u_cross=u_cross, u_s=u_s,
        ingest_tables=_ingest_tables(nbr_idx, nbr_mask, u_self, u_cross,
                                     rslot, zy.dtype, device),
        rslot=rslot, n_live=int(n_live), nu=float(nu), n_ref=int(n_ref),
        node_dims=tuple(int(v) for v in node_dims),
        offsets=None if offsets is None else tuple(offsets), kind=kind)


def stream_aux_to_arrays(aux: StreamAux) -> dict:
    """The inverse of `stream_aux_from_arrays`: numpy arrays plus
    metadata, keyed by the reference's field names."""
    out = {f: to_numpy(getattr(aux, f)) for f in _STREAM_TENSORS}
    out.update({f: np.array(getattr(aux, f)) for f in _STREAM_HOST})
    out.update({f: getattr(aux, f) for f in _STREAM_META})
    return out


def snapshot_from_arrays(omegas, biases, kinds, thetas, staleness, *,
                         device=None) -> ServeSnapshot:
    """ServeSnapshot from the reference snapshot's arrays: per node ω
    [D_j, d], b [D_j] (None for cos_sin), its kind and θ_j, plus the
    staleness as a `StalenessBound` or the tuple of its fields
    (`dataclasses.astuple` of the reference's)."""
    device = resolve_device(device)
    if not isinstance(staleness, StalenessBound):
        staleness = StalenessBound(*staleness)
    fmaps = tuple(feature_map_from_arrays(o, b, k, device=device)
                  for o, b, k in zip(omegas, biases, kinds, strict=True))
    theta = tuple(torch.as_tensor(np.array(t), device=device)
                  for t in thetas)
    return ServeSnapshot(feature_maps=fmaps, theta=theta,
                         staleness=staleness)


def lm_params_from_arrays(cfg: ModelConfig, arrays: dict, *,
                          device=None) -> Params:
    """The model's parameters from the reference's parameter pytree as
    numpy arrays (``embed``, ``final_norm``, ``lm_head`` unless the
    embeddings are tied, and one ``slot{i}`` dict per slot, stacked over
    groups), in ``cfg.param_dtype``. Raises on a missing, extra or
    misshapen entry. The [in, out] layout is the same on both sides, so
    this is a copy."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)

    def convert(key: str, a, want: tuple) -> torch.Tensor:
        t = torch.as_tensor(np.array(a), device=device).to(cfg.pdt)
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"parameter {key} has shape "
                             f"{tuple(t.shape)}, expected {tuple(want)}")
        return t

    if set(arrays) != set(shapes):
        raise ValueError(f"parameter names {sorted(arrays)} differ from "
                         f"{sorted(shapes)} of {cfg.name}")
    params: Params = {}
    for key, want in shapes.items():
        if isinstance(want, dict):
            if set(arrays[key]) != set(want):
                raise ValueError(f"{key} names {sorted(arrays[key])} "
                                 f"differ from {sorted(want)}")
            params[key] = {n: convert(f"{key}.{n}", arrays[key][n], w)
                           for n, w in want.items()}
        else:
            params[key] = convert(key, arrays[key], want)
    return params


def lm_params_to_arrays(params: Params) -> dict:
    """The inverse of `lm_params_from_arrays`: the same pytree of numpy
    arrays."""
    return {k: ({n: to_numpy(t) for n, t in v.items()}
                if isinstance(v, dict) else to_numpy(v))
            for k, v in params.items()}


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor (θ, a kernel output, …) as a host numpy array."""
    return t.detach().cpu().numpy()

