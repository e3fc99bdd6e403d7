"""The port's telemetry (`repro_torch.obs`: dispatch counts, exporters,
the report CLI, provenance, spans) held against the reference's
`repro.obs` on the same inputs: dispatch counts per backend pair, JSONL
byte for byte from identically filled registries, and the report of a
reference-written JSONL, provenance excepted. The port's own span
features (the fit's span tree, ids, the no-op path and the profiler's
clock) are held to what they promise."""
import json
import math
import threading

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


# --------------------------------------------------------------------------
# Spans: the fit's span tree, ids, the off path, the clock
# --------------------------------------------------------------------------
FIT_DIMS = (6, 7, 8, 6, 5)


def _tiny_fit(tol=1e-10, chunk=32):
    """One fit of the timed path on the CPU: energy DDRF a node, the
    batched pack, the fused solve to tol, every node's predictions."""
    from repro_torch.core import (DeKRRConfig, DeKRRSolver, circulant,
                                  select_features)
    from repro_torch.data.synthetic import (make_dataset, partition,
                                            train_test_split_nodes)
    from repro_torch.dist import pack_problem, unpack_theta

    ds = make_dataset("air_quality", seed=0, subsample=200)
    train, test = train_test_split_nodes(
        partition(ds, len(FIT_DIMS), mode="noniid_y", device="cpu"))
    gen = torch.Generator().manual_seed(3)
    fmaps = [select_features(gen, ds.dim, dj, 1.0, nd.x, nd.y)
             for dj, nd in zip(FIT_DIMS, train)]
    n = sum(nd.num_samples for nd in train)
    solver = DeKRRSolver(circulant(len(FIT_DIMS), (1, 2)), fmaps, train,
                         DeKRRConfig(lam=1e-4, c_nei=0.05 * n),
                         build_aux=False, device="cpu")
    packed = pack_problem(solver, gram_backend="cuda", device="cpu")
    theta, rounds = solve_batched(packed, 3000, backend="cuda_fused",
                                  tol=tol, chunk_rounds=chunk,
                                  return_rounds=True)
    th = unpack_theta(packed, theta)
    preds = [solver.predict(th, nd.x, node=j) for j, nd in enumerate(test)]
    return dict(theta=theta, rounds=rounds, preds=preds)


def test_fit_records_the_span_tree():
    """Every span of a fit, in the order they open, with its parent
    resolved by id: DDRF a node, the pack's four steps, the solve's tol
    reads, the predictions."""
    with port_spans.recording() as rec:
        out = _tiny_fit()
    reads = math.ceil(out["rounds"] / 32)
    spans = sorted(rec.spans, key=lambda sp: sp.span_id)
    assert [sp.span_id for sp in spans] == list(range(1, len(spans) + 1))
    by_id = {sp.span_id: sp for sp in spans}
    tree = [(sp.name, by_id[sp.parent_id].name if sp.parent_id else None,
             sp.depth) for sp in spans]
    j = len(FIT_DIMS)
    assert tree == ([("ddrf.select", None, 0)] * j
                    + [("pack_problem", None, 0),
                       ("pack.stage", "pack_problem", 1),
                       ("pack.gram", "pack_problem", 1),
                       ("pack.aux", "pack_problem", 1),
                       ("pack.inverse", "pack.aux", 2),
                       ("solve", None, 0)]
                    + [("solve.tol_read", "solve", 1)] * reads
                    + [("predict", None, 0)] * j)
    for sp in spans:
        if sp.parent_id:
            parent = by_id[sp.parent_id]
            assert sp.parent == parent.name
            assert parent.t_start <= sp.t_start <= sp.t_end <= parent.t_end


@pytest.mark.parametrize("chunk", [1, 7, 32])
def test_fit_span_counts(chunk):
    """A fit's spans carry no attrs but `pack_problem`'s, and its solve
    reads the host once a chunk: as many `solve.tol_read` spans as
    chunks of the rounds `solve_batched` returns."""
    with port_spans.recording() as rec:
        out = _tiny_fit(chunk=chunk)
    got = {}
    for sp in rec.spans:
        got.setdefault(sp.name, []).append(sp.attrs)
    j = len(FIT_DIMS)
    assert got.pop("pack_problem") == [dict(nodes=j, method="batched")]
    assert all(attrs == {} for runs in got.values() for attrs in runs)
    assert len(got["ddrf.select"]) == len(got["predict"]) == j
    reads = math.ceil(out["rounds"] / chunk)
    assert len(got["solve.tol_read"]) == reads


def test_solve_without_tol_reads_nothing():
    with port_spans.recording() as rec:
        out = _tiny_fit(tol=0.0, chunk=1000)
    assert [sp.name for sp in rec.spans if sp.name.startswith("solve")] \
        == ["solve"]
    assert out["rounds"] == 3000


def test_fit_without_recorder_records_nothing_and_keeps_the_bits():
    idle = port_spans.SpanRecorder()
    assert port_spans._installed is None
    plain = _tiny_fit()
    with port_spans.recording() as rec:
        traced = _tiny_fit()
    assert idle.spans == [] and rec.spans
    assert plain["rounds"] == traced["rounds"]
    assert torch.equal(plain["theta"], traced["theta"])
    assert all(torch.equal(a, b)
               for a, b in zip(plain["preds"], traced["preds"]))


def test_span_off_returns_one_shared_object():
    off = port_spans.span("a")
    assert port_spans.span("b", n=3) is off is port_spans.span("a")
    with off:
        with port_spans.span("nested"):
            pass
    with port_spans.recording() as rec:
        on = port_spans.span("a")
        assert on is not off
        with on:
            pass
    assert [sp.name for sp in rec.spans] == ["a"]
    assert port_spans.span("a") is off


def test_span_ids_follow_each_threads_own_stack():
    """Ids count up across threads in the order spans open; a span's
    parent is the innermost open span of its own thread."""
    with port_spans.recording() as rec:
        with port_spans.span("outer", kind="x"):
            with port_spans.span("inner"):
                pass

            def other():
                with port_spans.span("other"):
                    with port_spans.span("other.child"):
                        pass

            worker = threading.Thread(target=other, name="worker")
            worker.start()
            worker.join(timeout=10)
    assert not worker.is_alive()
    got = {sp.name: (sp.span_id, sp.parent_id, sp.depth, sp.thread)
           for sp in rec.spans}
    assert got == {"outer": (1, None, 0, "MainThread"),
                   "inner": (2, 1, 1, "MainThread"),
                   "other": (3, None, 0, "worker"),
                   "other.child": (4, 3, 1, "worker")}
    assert [sp.attrs for sp in rec.spans if sp.name == "outer"] \
        == [dict(kind="x")]


def test_span_is_recorded_when_its_body_raises():
    """A body that raises still closes its span, and the stack unwinds:
    the next span is top-level again."""
    clock = port_metrics.FakeClock(5.0)
    with port_spans.recording(clock=clock) as rec:
        with pytest.raises(ValueError):
            with port_spans.span("outer"):
                with port_spans.span("failing"):
                    clock.advance(0.5)
                    raise ValueError("no")
        with port_spans.span("after"):
            pass
    assert [(sp.name, sp.depth, sp.parent_id, sp.duration)
            for sp in rec.spans] == [("failing", 1, 1, 0.5),
                                     ("outer", 0, None, 0.5),
                                     ("after", 0, None, 0.0)]


def test_span_lies_inside_its_profiler_label():
    """A span opened inside a `record_function` label lies within the
    label's edges on the profiler's timeline (± 50 µs): the two share a
    clock."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with port_spans.recording() as rec:
            for _ in range(20):
                with torch.profiler.record_function("label"):
                    with port_spans.span("inner"):
                        torch.ones(64).sum()
    labels = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name() == "label")
    spans = sorted(rec.spans, key=lambda sp: sp.t_start)
    assert len(labels) == len(spans) == 20
    slack = 50e3
    for (a, b), sp in zip(labels, spans):
        assert a - slack <= sp.t_start * 1e9 <= sp.t_end * 1e9 <= b + slack


def test_trace_clock_is_the_default_clock():
    assert port_spans.SpanRecorder().clock is port_metrics.trace_clock
    with port_spans.recording() as rec:
        assert rec.clock is port_metrics.trace_clock
    now = port_metrics.trace_clock()
    assert abs(now - port_metrics.wall_clock()) < 1.0


def test_fake_clock_injection():
    clock = port_metrics.FakeClock(10.0)
    reg = port_metrics.Registry(clock=clock)
    with port_spans.recording(reg, clock=clock) as rec:
        with port_spans.span("outer"):
            clock.advance(0.5)
            with port_spans.span("inner", n=1):
                clock.advance(0.25)
    assert [(sp.name, sp.t_start, sp.t_end, sp.duration)
            for sp in rec.spans] == [("inner", 10.5, 10.75, 0.25),
                                     ("outer", 10.0, 10.75, 0.75)]
    assert reg.spans == rec.spans
    own = port_spans.SpanRecorder(clock=clock)
    with own.span("direct"):
        clock.advance(1.0)
    assert (own.spans[0].t_start, own.spans[0].t_end) == (10.75, 11.75)


def test_last_recording_is_the_last_scope_to_close():
    with port_spans.recording() as outer:
        with port_spans.recording() as inner:
            with port_spans.span("in"):
                pass
        assert port_spans.last_recording() is inner
        with port_spans.span("out"):
            pass
    assert port_spans.last_recording() is outer
    assert [sp.name for sp in inner.spans] == ["in"]
    assert [sp.name for sp in outer.spans] == ["out"]
    assert port_spans._installed is None


def test_report_collapses_runs_of_repeated_spans():
    """A fit's ten DDRF spans render as one bar with their count and
    summed time; spans of other names or depths keep their own bars."""
    clock = port_metrics.FakeClock()
    reg = port_metrics.Registry(clock=clock)
    with port_spans.recording(reg, clock=clock):
        with port_spans.span("fit"):
            for _ in range(10):
                with port_spans.span("ddrf.select"):
                    clock.advance(0.5)
            with port_spans.span("solve"):
                clock.advance(1.0)
            with port_spans.span("ddrf.select"):
                clock.advance(0.25)
    lines = port_report.render_spans(port_export.registry_lines(reg))
    names = [line[2:30].rstrip() for line in lines[2:]]
    assert names == ["fit", "  ddrf.select ×10", "  solve",
                     "  ddrf.select"]
    assert lines[1] == "  total 6.2500s"
    assert [line.split("|")[-1].strip() for line in lines[2:]] == [
        "6.2500s", "5.0000s", "1.0000s", "0.2500s"]
