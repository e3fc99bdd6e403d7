"""The port's dry run (`repro_torch.launch.dryrun`) against the
reference's compiled dry run, and its cost model on a step whose counts
are known by hand.

Each side runs in a process of its own (the reference forces 16 host
devices before JAX starts; the port's fake process group is global to
its process), all three at once: the reference compiles its two smoke
pairs (qwen1.5-0.5b × decode_32k, smollm-135m × train_4k) on a 4×4 mesh
of ``AxisType.Auto`` axes (``jax.make_mesh``'s default ``Explicit``
axes refuse the reference's ``with_sharding_constraint`` on JAX 0.9.0;
ROADMAP §3, caveat C) with its own `ShardingRules`, `input_specs` and
`analyze_compiled`; the port traces the same pairs with its CLI.

Bands, from what each side counts:
* ``model_flops``: the same formula on the same configuration, exact.
* ``flops_per_device``: dot FLOPs (2·|result|·|contracted|, on the
  same local shapes) are over 99% of both counts; the elementwise and
  reduction counts differ by how each side splits an op (XLA's HLO
  against eager aten ops): within 3%.
* arguments: the same tensors in the same dtypes and shardings; the
  reference also holds the traced position and step scalars: within
  64 bytes.
* collectives: the port issues the same collectives at the same points
  in the compute dtype (bf16); the reference's CPU compile moves the
  f32 operands and results of its dots. The decode's all-reduces (the
  row-sharded projections and the embedding lookup) and the train
  step's weight all-gathers are therefore half the reference's bytes:
  ratio within [0.45, 0.55]. The train step's gradient reduction: the
  reference all-reduces whole f32 gradients (its CPU pipeline has no
  reduce-scatter pass), the port reduce-scatters bf16 gradients into the
  FSDP shards and all-reduces the shard over ``model``, at most a
  quarter of the reference's bytes (half the width, a quarter of the
  data axis's result).
* peak memory: both hold the same arguments; the temporaries differ in
  kind (XLA's CPU buffer assignment against eager frees, fused against
  unfused ops): within [0.5, 2]×, the band the card's check holds the
  dry run to against a measured peak.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
from conftest import REPO_ROOT, subprocess_env

SMOKE = (("qwen1_5_0_5b", "decode_32k"), ("smollm_135m", "train_4k"))
TIMEOUT = 600

REFERENCE = textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    import jax
    from jax.sharding import AxisType
    from repro.configs import INPUT_SHAPES, get_arch
    from repro.launch.hlo_analysis import analyze_compiled
    from repro.launch.hlo_analysis import model_flops_per_step
    from repro.launch.sharding import ShardingRules
    from repro.launch.specs import input_specs
    from repro.models.model import active_param_count
    mesh = jax.make_mesh((4, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch, shape in %r:
        pair = input_specs(get_arch(arch), shape, ShardingRules(mesh))
        kw = {}
        if pair.get("out_shardings") is not None:
            kw["out_shardings"] = pair["out_shardings"]
        with mesh:
            compiled = jax.jit(
                pair["fn"], in_shardings=pair["in_shardings"],
                donate_argnums=pair["donate_argnums"], **kw,
            ).lower(*pair["args"]).compile()
        cfg = pair["cfg"]
        out[arch + "/" + shape] = dict(
            model_flops=model_flops_per_step(
                cfg, INPUT_SHAPES[shape], active_param_count(cfg)),
            argument_size=compiled.memory_analysis().argument_size_in_bytes,
            **analyze_compiled(compiled).as_dict())
    print(json.dumps(out))
""" % (SMOKE,))

COSTS = textwrap.dedent("""
    import json, torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.cost_analysis import analyze
    from repro_torch.launch.dryrun import init_fake_group
    from repro_torch.launch.mesh import make_production_mesh
    init_fake_group(2)
    mesh = make_production_mesh(data=2, model=1, device_type="cpu")
    rep = [Replicate(), Replicate()]
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(8, 16), mesh, [Shard(1), Replicate()])
        w1 = distribute_tensor(torch.empty(16, 32), mesh, [Shard(0), Replicate()])
        w2 = distribute_tensor(torch.empty(32, 4), mesh, rep)
        def step(x, w1, w2):
            h = (x @ w1).redistribute(mesh, rep)
            return torch.exp(h @ w2)
        _, c = analyze(step, x, w1, w2)
    print(json.dumps(dict(flops=c.flops, trans=c.transcendentals,
                          bytes=c.bytes, coll=c.coll_bytes, ops=c.coll_ops,
                          args=c.argument_bytes, peak=c.peak_memory)))
""")


def _start(args, env):
    return subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=REPO_ROOT)


def _finish(proc):
    out, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, err[-3000:]
    return out


def _port_cli(arch, shape, out_dir):
    return _start([sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", "4x4",
                   "--out", str(out_dir)], subprocess_env())


@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    """The reference's compiles and the port's traces of the two smoke
    pairs, run side by side."""
    out_dir = tmp_path_factory.mktemp("dryrun")
    ref = _start([sys.executable, "-c", REFERENCE], subprocess_env())
    ports = [_port_cli(a, s, out_dir) for a, s in SMOKE]
    for p in ports:
        _finish(p)
    want = json.loads(_finish(ref).strip().splitlines()[-1])
    got = {f"{a}/{s}": json.load(open(out_dir / f"4x4_{a}_{s}.json"))
           for a, s in SMOKE}
    return got, want


# the reference's JSON keys (repro.launch.dryrun), its compile times
# becoming the trace time
REF_KEYS = {
    "arch", "shape", "mesh", "plan", "status", "chips", "params_total",
    "params_active", "model_flops", "hlo_total_flops", "useful_flops_ratio",
    "flops_per_device", "bytes_per_device", "transcendentals_per_device",
    "collective_bytes_per_device", "peak_memory_per_device", "compute_s",
    "memory_s", "collective_s", "dominant", "num_whiles",
    "unknown_trip_counts", "memory_analysis"}


@pytest.mark.parametrize("pair", [f"{a}/{s}" for a, s in SMOKE])
def test_dryrun_matches_the_reference_compile(pair, smoke_runs):
    got, want = smoke_runs[0][pair], smoke_runs[1][pair]
    assert REF_KEYS | {"trace_s", "bytes_model"} <= set(got)
    assert got["status"] == "ok" and got["chips"] == 16
    assert got["bytes_model"] == "unfused"
    assert got["num_whiles"] == got["unknown_trip_counts"] == 0
    assert got["model_flops"] == want["model_flops"]
    assert 0.97 <= got["flops_per_device"] / want["flops_per_device"] <= 1.03
    assert abs(got["memory_analysis"]["argument_size"]
               - want["argument_size"]) <= 64
    assert 0.5 <= (got["peak_memory_per_device"]
                   / want["peak_memory_per_device"]) <= 2.0
    coll, ref_coll = (got["collective_bytes_per_device"],
                      want["collective_bytes_per_device"])
    for kind in ("all-to-all", "collective-permute"):
        assert coll[kind] == ref_coll[kind] == 0
    if pair.endswith("decode_32k"):
        assert coll["all-gather"] == ref_coll["all-gather"] == 0
        assert coll["reduce-scatter"] == ref_coll["reduce-scatter"] == 0
        assert 0.45 <= coll["all-reduce"] / ref_coll["all-reduce"] <= 0.55
    else:
        assert 0.45 <= coll["all-gather"] / ref_coll["all-gather"] <= 0.55
        assert coll["reduce-scatter"] > 0 == ref_coll["reduce-scatter"]
        assert coll["reduce-scatter"] + coll["all-reduce"] \
            <= 0.25 * ref_coll["all-reduce"]
    assert got["dominant"] == want["dominant"] == "memory"


def test_dryrun_skip_recorded(tmp_path):
    _finish(_port_cli("hubert_xlarge", "decode_32k", tmp_path))
    out = json.load(open(tmp_path / "4x4_hubert_xlarge_decode_32k.json"))
    assert out == {"arch": "hubert_xlarge", "shape": "decode_32k",
                   "mesh": "4x4", "plan": "skip", "status": "skip"}


def test_cost_analysis_counts_a_hand_built_step():
    """Two matmuls with an all-reduce between them and an exp, on a
    2-rank fake group: per device x [8, 8] @ w1 [8, 32] (4,096 FLOPs),
    the partial sum all-reduced (1,024 bytes of f32), h [8, 32] @ w2
    [32, 4] (2,048), exp over 32 values (32 FLOPs, 32 transcendentals);
    operand plus result bytes 2,304 + 2,048 + 1,664 + 256; arguments
    256 + 1,024 + 512 bytes."""
    got = json.loads(_finish(_start([sys.executable, "-c", COSTS],
                                    subprocess_env())).strip()
                     .splitlines()[-1])
    assert got["flops"] == 4096 + 2048 + 32
    assert got["trans"] == 32
    assert got["bytes"] == 2304 + 2048 + 1664 + 256
    assert got["coll"] == {"all-gather": 0, "all-reduce": 1024,
                           "reduce-scatter": 0, "all-to-all": 0,
                           "collective-permute": 0}
    assert got["ops"]["all-reduce"] == 1
    assert got["args"] == 256 + 1024 + 512
    assert got["args"] + 1024 + 1024 + 128 + 128 <= got["peak"] \
        <= got["args"] + got["bytes"]


def test_roofline_reads_the_dryrun(tmp_path, capsys):
    from repro_torch.bench import roofline

    runs = tmp_path / "runs"
    runs.mkdir()
    json.dump({"arch": "a", "shape": "s", "mesh": "4x4", "plan": "skip",
               "status": "skip"}, open(runs / "4x4_a_s.json", "w"))
    json.dump({"arch": "b", "shape": "t", "mesh": "4x4", "plan": "run",
               "status": "ok", "compute_s": 1e-3, "memory_s": 2e-3,
               "collective_s": 0.5e-3, "dominant": "memory",
               "peak_memory_per_device": 2 ** 31,
               "useful_flops_ratio": 0.5}, open(runs / "4x4_b_t.json", "w"))
    out_dir = tmp_path / "out"
    lines = roofline.run(str(runs), "4x4", str(out_dir))
    assert lines == [
        "roofline/a/s,0.0,plan=skip(skip)",
        "roofline/b/t,0.0,compute_ms=1.00;memory_ms=2.00;collective_ms=0.50;"
        "dominant=memory;mem_per_dev_GiB=2.00;useful_flops=0.50"]
    assert capsys.readouterr().out.splitlines() == lines
    assert (out_dir / "roofline.csv").read_text().splitlines() == lines
    assert sorted(os.listdir(tmp_path)) == ["out", "runs"]
    assert roofline.run(str(tmp_path / "none"), "4x4")[0].startswith(
        "roofline/missing")
