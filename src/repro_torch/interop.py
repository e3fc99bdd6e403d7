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
from repro_torch.stream.runtime import ServeSnapshot, StalenessBound

_ARRAY_FIELDS = ("g", "d", "s", "p", "theta_mask", "nbr_idx", "nbr_mask")


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


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor (θ, a kernel output, …) as a host numpy array."""
    return t.detach().cpu().numpy()

