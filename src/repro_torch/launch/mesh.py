"""Production meshes: the port's counterpart of `repro.launch.mesh`.

Single pod: (data=16, model=16). Multi-pod: (pod=2, data=16, model=16);
the ``pod`` axis carries data parallelism, and parameters shard FSDP over
(pod, data).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the default
process group: torchrun's (or `repro_torch.dist.ranks.run_ranks`') on
real devices, the ``fake`` group of `repro_torch.launch.dryrun` in the
dry run. Building one needs that group; `make_abstract_mesh` needs
nothing, so `repro_torch.launch.sharding.ShardingRules` can be checked
without any process group, as the reference's tests check theirs on a
jax ``AbstractMesh``.

Hardware constants (roofline, per card) are the H100 SXM5 80GB's, from
its datasheet at 700 W: dense bf16 tensor-core peak, HBM3 bandwidth, and
NVLink 4 at 450 GB/s a direction (18 links). A mesh past one NVLink
domain of 8 cards crosses InfiniBand between hosts, which
`LINK_BANDWIDTH` does not model.
"""
from __future__ import annotations

import dataclasses
import math

# H100 SXM5 80GB (datasheet, 700 W)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense
HBM_BANDWIDTH = 3.35e12         # B/s
LINK_BANDWIDTH = 450e9          # B/s a direction, NVLink 4
NVLINK_DOMAIN = 8               # cards one NVLink switch domain joins


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A device-free mesh: axis names and sizes, no devices and no
    process group. It answers what `ShardingRules` asks a mesh
    (`mesh_axes`)."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def size(self, dim: int | None = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or an `AbstractMesh`, in mesh
    order."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no axis names")
    return {name: int(mesh.size(i)) for i, name in enumerate(names)}


def make_production_mesh(*, multi_pod: bool = False, data: int = 16,
                         model: int = 16, device_type: str | None = None):
    """A (data, model) mesh, or (pod=2, data, model) with ``multi_pod``,
    over the default process group, whose world size must be the mesh's.
    ``device_type`` defaults to ``cuda`` when the group's backend is
    NCCL and ``cpu`` otherwise (gloo, or the dry run's fake group)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, data, model) if multi_pod else (data, model)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        raise RuntimeError(f"make_production_mesh: a {shape} mesh needs the "
                           f"default process group of {math.prod(shape)} "
                           f"ranks; none is initialised")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"make_production_mesh: the {shape} mesh needs "
                         f"{math.prod(shape)} ranks, the process group has "
                         f"{world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_abstract_mesh(shape, axes) -> AbstractMesh:
    """A device-free mesh of ``shape`` named ``axes``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_abstract_mesh: {len(shape)} sizes for "
                         f"{len(axes)} axes")
    return AbstractMesh(shape, axes)


def make_cpu_mesh(num_devices: int | None = None, axis: str = "nodes"):
    """A 1-D mesh over the ranks of the default process group, one node a
    rank, as `repro_torch.dist.ranks.run_ranks` lays them out (the
    decentralized runtime's layout); ``num_devices`` must equal the world
    size when given."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"make_cpu_mesh: {num_devices} devices asked, the "
                         f"process group has {world} ranks")
    return init_device_mesh("cpu", (world,), mesh_dim_names=(axis,))
