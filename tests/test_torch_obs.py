"""The port's telemetry (`repro_torch.obs`: dispatch counts, exporters,
the report CLI, provenance) held against the reference's `repro.obs` on
the same inputs: dispatch counts per backend pair, JSONL and Prometheus
text byte for byte from identically filled registries, and the report of
a reference-written JSONL, provenance excepted."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs.__main__ as ref_report
import repro.obs.export as ref_export
import repro.obs.metrics as ref_metrics
import repro.obs.spans as ref_spans
import repro.obs.trace as ref_trace
import repro_torch.obs.__main__ as port_report
import repro_torch.obs.export as port_export
import repro_torch.obs.metrics as port_metrics
import repro_torch.obs.spans as port_spans
import repro_torch.obs.trace as port_trace
from repro.analysis.jaxpr_lint import synthetic_packed as ref_synthetic_packed
from repro.core import AsyncGossipConfig as RefAsyncConfig
from repro.core.acceleration import chebyshev_solve_packed as ref_cheb
from repro.core.async_gossip import activation_masks as ref_masks
from repro.dist import async_solve_batched as ref_async_solve
from repro.dist import solve_batched as ref_solve
from repro.obs.dispatch import dispatch_count as ref_dispatch_count
from repro_torch import interop
from repro_torch.core import AsyncGossipConfig
from repro_torch.core.acceleration import chebyshev_solve_packed
from repro_torch.dist import async_solve_batched, solve_batched
from repro_torch.kernels import ops
from repro_torch.obs import dispatch_count, round_dispatches

ROUNDS = 5
KEY = jax.random.PRNGKey(7)
CENSOR = dict(censor_tau=2e-2, censor_decay=0.9)
PAIRS = [("xla", "torch"), ("pallas", "cuda"), ("pallas_fused", "cuda_fused")]


@pytest.fixture(scope="module")
def packs():
    """The reference lint's synthetic packed problem and its port copy."""
    ref = ref_synthetic_packed()
    port = interop.packed_from_arrays(
        *(np.asarray(getattr(ref, k)) for k in
          ("g", "d", "s", "p", "theta_mask", "nbr_idx", "nbr_mask")),
        offsets=ref.offsets, node_dims=ref.node_dims,
        num_edges_directed=ref.num_edges_directed, device="cpu")
    return ref, port


# --------------------------------------------------------------------------
# Dispatch counts: the port's run-time count == the reference's traced one
# --------------------------------------------------------------------------
@pytest.mark.parametrize("trace", [False, True], ids=["plain", "trace"])
@pytest.mark.parametrize("kind", ["sync", "async", "chebyshev"])
@pytest.mark.parametrize("ref_backend,backend", PAIRS)
def test_dispatch_count_equals_reference(packs, ref_backend, backend, kind,
                                         trace):
    ref, port = packs
    kw = {"return_trace": True} if trace else {}
    if kind == "sync":
        want = ref_dispatch_count(ref_solve, ref, num_iters=ROUNDS,
                                  backend=ref_backend, **kw)
        got = dispatch_count(solve_batched, port, ROUNDS, backend=backend,
                             **kw)
    elif kind == "async":
        want = ref_dispatch_count(
            lambda pk, k: ref_async_solve(
                pk, ROUNDS, k, backend=ref_backend,
                config=RefAsyncConfig(prob=0.5, **CENSOR),
                return_stats=True, **kw), ref, KEY)
        masks = torch.as_tensor(np.array(ref_masks(
            KEY, ROUNDS, ref.num_nodes, prob=0.5)))
        got = dispatch_count(
            async_solve_batched, port, ROUNDS, masks,
            config=AsyncGossipConfig(prob=0.5, **CENSOR), backend=backend,
            return_stats=True, **kw)
    else:
        want = ref_dispatch_count(
            lambda pk: ref_cheb(pk, 0.9, num_iters=ROUNDS,
                                backend=ref_backend, **kw), ref)
        got = dispatch_count(chebyshev_solve_packed, port, 0.9,
                             num_iters=ROUNDS, backend=backend, **kw)
    assert got == want == (round_dispatches(backend, ROUNDS), True)


def test_dispatch_counter_keeps_launches_cuda_only(packs):
    """On the CPU a wrapper dispatches its plain version: DISPATCHES moves,
    LAUNCHES (CUDA launches only) does not."""
    _, port = packs
    launches = ops.launch_counts()
    before = ops.dispatch_counts()
    solve_batched(port, ROUNDS, backend="cuda")
    after = ops.dispatch_counts()
    assert after["dekrr_step"] - before["dekrr_step"] == ROUNDS
    assert ops.launch_counts() == launches
    assert set(ops.DISPATCHES) == set(ops.LAUNCHES)


@pytest.mark.parametrize("backend,chunk,want", [
    ("torch", None, 0), ("cuda", None, 7), ("cuda_fused", None, 1),
    ("cuda_fused", 2, 4), ("cuda_fused", 7, 1), ("cuda_fused", 100, 1)])
def test_round_dispatches_contract(packs, backend, chunk, want):
    _, port = packs
    assert round_dispatches(backend, 7, chunk_rounds=chunk) == want
    got, exact = dispatch_count(solve_batched, port, 7, backend=backend,
                                chunk_rounds=chunk)
    assert (got, exact) == (want, True)


# --------------------------------------------------------------------------
# Exporters: the same registry contents give the same text
# --------------------------------------------------------------------------
def _fill(metrics, spans, trace_mod, export, to_array):
    """One registry of every record kind, on a FakeClock, through the
    package's own API."""
    clock = metrics.FakeClock(100.0)
    reg = metrics.Registry(clock=clock)
    reg.counter("bench.suites_run", help="suites run").inc(3)
    reg.counter("solve.rounds").inc(1.5)
    reg.gauge("queue depth/now").set(7.25)
    hist = reg.histogram("serve.wave_s", help="wave seconds")
    for v in (0.1, 0.25, 0.05, 1.0, 0.3):
        hist.observe(v)
    reg.histogram("empty.hist")
    with spans.recording(reg, clock=clock):
        with spans.span("bench.solve", fast=True):
            clock.advance(0.5)
            with spans.span("pack_problem", nodes=10):
                clock.advance(0.125)
        clock.advance(1.0)
        with spans.span("bench.serve"):
            clock.advance(2.0)
    export.trace_event(reg, "solve/J4", trace_mod.SolveTrace(
        residuals=to_array([0.5, 0.25, 0.125, 0.0625, 1e-3])))
    export.trace_event(reg, "async/p0.5", trace_mod.AsyncSolveTrace(
        residuals=to_array([0.4, 0.2, 0.1]),
        active=to_array([5, 3, 4], int), broadcasts=to_array([5, 2, 4], int),
        deliveries=to_array([20, 8, 16], int),
        bytes=to_array([3200, 1280, 2560], int)), schedule="bernoulli")
    export.latency_event(reg, "serve/open_fp64_f30", metrics.LatencyReport(
        count=300, p50=2.5e-3, p99=9.75e-3, mean=3e-3, max=0.0125,
        qps=2735.5))
    reg.record_event("note", text="free-form", n=3)
    return reg


def _ref_registry():
    return _fill(ref_metrics, ref_spans, ref_trace, ref_export,
                 lambda v, t=float: jnp.asarray(
                     v, dtype=jnp.int32 if t is int else jnp.float64))


def _port_registry():
    return _fill(port_metrics, port_spans, port_trace, port_export,
                 lambda v, t=float: torch.as_tensor(
                     v, dtype=torch.int32 if t is int else torch.float64))


def test_to_jsonl_equals_reference():
    assert port_export.to_jsonl(_port_registry()) \
        == ref_export.to_jsonl(_ref_registry())


def test_to_prometheus_equals_reference():
    text = port_export.to_prometheus(_port_registry())
    assert text == ref_export.to_prometheus(_ref_registry())
    assert '# TYPE queue_depth_now gauge' in text


def test_write_jsonl_and_registry_lines(tmp_path):
    prov = {"git_sha": None, "t_wall": 0.0}
    path = port_export.write_jsonl(_port_registry(), str(tmp_path / "r.jsonl"),
                                   prov)
    ref_path = ref_export.write_jsonl(_ref_registry(),
                                      str(tmp_path / "ref.jsonl"), prov)
    assert open(path).read() == open(ref_path).read()
    lines = port_export.registry_lines(_port_registry(), prov)
    assert lines[0] == {"kind": "provenance", **prov}
    assert {r["kind"] for r in lines} == {"provenance", "counter", "gauge",
                                          "histogram", "span", "event"}


# --------------------------------------------------------------------------
# The report CLI
# --------------------------------------------------------------------------
def _without_provenance(records):
    return [r for r in records if r.get("kind") != "provenance"]


def test_render_report_of_reference_jsonl_equals_reference(tmp_path):
    path = str(tmp_path / "ref.jsonl")
    ref_export.write_jsonl(_ref_registry(), path,
                           ref_export.provenance(interpret=True))
    records = ref_report.load_records(path)
    assert any(r["kind"] == "provenance" for r in records)
    got = port_report.render_report(_without_provenance(records))
    assert got == ref_report.render_report(_without_provenance(records))
    for section in ("convergence", "comm frontier", "span waterfall",
                    "counters / gauges", "latency / percentiles"):
        assert f"== {section} " in got


def test_report_cli_renders_port_provenance(tmp_path, capsys):
    path = str(tmp_path / "port.jsonl")
    prov = port_export.provenance(plain=True, device="cpu",
                                  extra={"fast": True})
    port_export.write_jsonl(_port_registry(), path, prov)
    assert port_report.main([path]) == 0
    out = capsys.readouterr().out
    assert "== provenance" in out and "torch_version" in out
    assert "plain        True" in out and "device_kind  cpu" in out


def test_report_of_empty_file(tmp_path):
    path = tmp_path / "empty.jsonl"
    path.write_text("")
    assert port_report.render_report(port_report.load_records(str(path))) \
        == ref_report.render_report([])


# --------------------------------------------------------------------------
# Provenance
# --------------------------------------------------------------------------
def test_provenance_on_cpu():
    prov = port_export.provenance(plain=True, device="cpu",
                                  extra={"only": "solve"})
    assert prov["torch_version"] == torch.__version__
    assert prov["cuda_version"] == torch.version.cuda
    assert (prov["device_kind"], prov["platform"]) == ("cpu", "cpu")
    assert prov["power_limit"] is None and prov["plain"] is True
    assert prov["only"] == "solve" and prov["t_wall"] > 0
    json.dumps(prov)


def test_stamp_provenance(tmp_path):
    prov = {"git_sha": "abc", "plain": True}
    obj, seq = tmp_path / "obj.json", tmp_path / "seq.json"
    obj.write_text(json.dumps({"cases": [1, 2]}))
    seq.write_text(json.dumps([1, 2]))
    assert port_export.stamp_provenance(str(obj), prov)
    assert port_export.stamp_provenance(str(seq), prov)
    assert not port_export.stamp_provenance(str(tmp_path / "none.json"),
                                            prov)
    assert json.loads(obj.read_text()) == {"cases": [1, 2],
                                           "provenance": prov}
    assert json.loads(seq.read_text()) == {"provenance": prov,
                                           "results": [1, 2]}
