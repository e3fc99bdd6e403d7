"""The port's sharding rules, pair configurations and step arguments
against the JAX reference's (`repro.launch.{mesh,sharding,specs}`), on
device-free meshes: field for field and entry for entry, for every
architecture of the registry on the 4×4 smoke grid, the 16×16 pod and
the 2×16×16 multi-pod mesh.

The reference's rules run on a jax ``AbstractMesh`` and the port's on its
`AbstractMesh`, so no device and no process group is needed. Parameter
and cache shapes come from the reference's ``jax.eval_shape`` and the
port's `param_shapes` / `cache_spec` (as meta tensors); the port's
`input_specs` builds its arguments under ``FakeTensorMode`` without
placing them (``placed=False``). A `PartitionSpec` compares as the tuple
of its entries.
"""
import dataclasses
import functools

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_get_arch
from repro.launch import specs as ref_specs
from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
from repro.launch.sharding import ShardingRules as RefRules
from repro.models.model import Model as RefModel
from repro_torch.configs import INPUT_SHAPES, get_arch, list_archs
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_abstract_mesh, mesh_axes
from repro_torch.launch.sharding import (P, ShardingRules, make_shardings,
                                         placements)
from repro_torch.models.model import cache_spec, param_shapes

MESHES = {
    "4x4": ((4, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
POLICIES = ("tp", "dp", "serve")
# decode caches: decode_32k's batch-on-data layout and long_500k's B 1,
# whose sequence takes the data axes
CACHES = ((128, 32768), (1, 524288))


def rules_pair(mesh: str, policy: str = "tp"):
    shape, axes = MESHES[mesh]
    return (RefRules(ref_abstract_mesh(shape, axes), policy),
            ShardingRules(make_abstract_mesh(shape, axes), policy))


@functools.lru_cache(maxsize=None)
def ref_param_shapes(arch):
    return jax.eval_shape(
        lambda: RefModel(ref_get_arch(arch).config).init(
            jax.random.PRNGKey(0)))


def meta(shapes):
    if isinstance(shapes, dict):
        return {k: meta(v) for k, v in shapes.items()}
    return torch.empty(shapes, device="meta")


def meta_cache(cfg, b, s):
    return {slot: {name: torch.empty(shape, dtype=dt, device="meta")
                   for name, (shape, dt) in entries.items()}
            for slot, entries in cache_spec(cfg, b, s).items()}


def assert_same_specs(ref_tree, port_tree, where=""):
    """Every leaf: the same keys and the same spec, entry for entry."""
    if isinstance(port_tree, dict):
        assert sorted(port_tree) == sorted(ref_tree), where
        for key in port_tree:
            assert_same_specs(ref_tree[key], port_tree[key], f"{where}/{key}")
        return
    ref_spec = getattr(ref_tree, "spec", ref_tree)
    assert isinstance(port_tree, P), where
    assert tuple(port_tree) == tuple(ref_spec), \
        f"{where}: port {tuple(port_tree)} reference {tuple(ref_spec)}"


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_sharding_rules_match_reference(arch, mesh, policy):
    ref, port = rules_pair(mesh, policy)
    for attr in ("dp_axes", "fsdp_axes", "tp_axis", "dp_size", "fsdp_size",
                 "tp_size", "policy"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.dp_spec() == ref.dp_spec()
    cfg = get_arch(arch).config
    ref_p = ref.params_specs(ref_param_shapes(arch))
    port_p = port.params_specs(meta(param_shapes(cfg)))
    assert_same_specs(ref_p, port_p, "params")
    assert_same_specs(ref.opt_specs(None, ref_p), port.opt_specs(None, port_p),
                      "opt")
    ref_cfg = ref_get_arch(arch).config
    for b, s in CACHES:
        ref_c = ref.cache_specs(jax.eval_shape(
            lambda: RefModel(ref_cfg).init_cache(b, s)), b)
        assert_same_specs(ref_c, port.cache_specs(meta_cache(cfg, b, s), b),
                          f"cache B {b}")
    for name, shape in INPUT_SHAPES.items():
        batch = {"tokens": torch.empty((shape.global_batch, 8),
                                       device="meta"),
                 "embeds": torch.empty((shape.global_batch, 8, 4),
                                       device="meta"),
                 "pos": torch.empty((), device="meta")}
        ref_batch = {k: jax.ShapeDtypeStruct(tuple(v.shape), "float32")
                     for k, v in batch.items()}
        assert_same_specs(ref.batch_specs(ref_batch, shape.global_batch),
                          port.batch_specs(batch, shape.global_batch), name)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert mesh_axes(mesh) == {"pod": 2, "data": 16, "model": 16}
    assert placements(P(None, ("pod", "data"), "model"), mesh) == (
        Shard(1), Shard(1), Shard(2))
    assert placements(P(), mesh) == (Replicate(),) * 3
    assert placements(P("model", None), mesh) == (Replicate(), Replicate(),
                                                  Shard(0))
    with pytest.raises(ValueError, match="shards dims"):
        placements(P("model", "model"), mesh)
    with pytest.raises(ValueError, match="lacks"):
        placements(P("nodes"), mesh)
    rules = ShardingRules(mesh)
    tree = make_shardings(rules, {"a": P("data"), "b": {"c": P()}})
    assert tree["a"] == (mesh, (Replicate(), Shard(0), Replicate()))
    assert tree["b"]["c"][1] == (Replicate(),) * 3
    with pytest.raises(ValueError, match="unknown policy"):
        ShardingRules(mesh, "fsdp")


# --------------------------------------------------------- pair configs
PAIRS = [(a, s) for a in list_archs() for s in INPUT_SHAPES]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", PAIRS)
def test_variant_config_and_opt_config_match_reference(arch, shape, mesh):
    ref_rules, rules = rules_pair(mesh)
    ref_spec, spec = ref_get_arch(arch), get_arch(arch)
    if ref_spec.shape_plan(shape) == "skip":
        with pytest.raises(ValueError, match="skips"):
            specs.variant_config(spec, shape, rules=rules)
        return
    for r, rr in ((rules, ref_rules), (None, None)):
        want = ref_specs.variant_config(ref_spec, shape, rules=rr)
        got = specs.variant_config(spec, shape, rules=r)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(specs.opt_config_for(got)) == \
        dataclasses.asdict(ref_specs.opt_config_for(want))


def _leaves_with_path(tree, path=()):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves_with_path(tree[key], path + (key,))
    else:
        yield path, tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_match_reference(arch, shape, mesh):
    """The arguments' shapes and dtypes and their specs, leaf for leaf,
    with the reference's policy switches (pure DP for small models in
    training, the serve policy for decode) and its cache lengths. The
    reference's traced position is a port Python int (the last
    position), compared by value range only."""
    ref_rules, rules = rules_pair(mesh)
    ref_spec, spec = ref_get_arch(arch), get_arch(arch)
    if ref_spec.shape_plan(shape) == "skip":
        return
    want = ref_specs.input_specs(ref_spec, shape, ref_rules)
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        got = specs.input_specs(spec, shape, rules, device="cpu",
                                placed=False)
    assert dataclasses.asdict(got["cfg"]) == dataclasses.asdict(want["cfg"])
    assert got["donate_argnums"] == want["donate_argnums"]
    n = len(want["args"])
    assert len(got["args"]) == n
    for i in range(n):
        ref_leaves = dict(_leaves_with_path(want["args"][i]))
        port_leaves = dict(_leaves_with_path(got["args"][i]))
        ref_specs_ = dict(_leaves_with_path(want["in_shardings"][i]))
        port_specs = dict(_leaves_with_path(got["in_specs"][i]))
        if isinstance(got["args"][i], int):          # the decode position
            assert 0 <= got["args"][i] < REF_SHAPES[shape].seq_len
            assert ref_leaves[()].shape == ()
            continue
        assert sorted(port_leaves) == sorted(ref_leaves)
        for key, leaf in ref_leaves.items():
            port = port_leaves[key]
            assert tuple(port.shape) == tuple(leaf.shape), key
            assert str(port.dtype).split(".")[-1] == str(leaf.dtype), key
            assert tuple(port_specs[key]) == tuple(ref_specs_[key].spec), key
