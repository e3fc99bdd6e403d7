"""The port's serving tier (`repro_torch.serve`, `repro_torch.stream`) and
its featurize kernel's plain versions, held against the JAX package's
serving tier (`repro.serve`, `repro.stream`, `repro.kernels.ops`).

Snapshots are built as `tests/test_serve_tier.py` builds them (J = 3,
d = 5, 16 frequencies, mixed cos_bias/cos_sin maps) and carried across
by `repro_torch.interop.snapshot_from_arrays`. Tolerances:

  * full-precision answers: rtol 1e-9, atol 1e-12·max|ref| (float64);
  * `rff_features_reference` against the JAX wrapper: the same;
  * bf16 featurize: every entry within the forward-error model bound
    s·((3u + γ_d)(|Ω||x| + |b|) + 3u), u = 2⁻⁸, of the float64 value, and
    at least 99% bit-equal to the JAX wrapper (the f32 sums run in
    another order);
  * the bf16 map of `featurize` (the ``torch`` backend's low-precision
    features) bit-equal to the reference's;
  * low-precision answers: each side within its own attached bound of
    the shared full-precision answer, and the port's answers and
    attached bounds within rtol 1e-5 of the reference's (the f32 GEMV
    sums in another order; the int8 product is exact on both sides).

On CPU tensors the ``cuda`` backend runs the kernel's plain version and
launches nothing (checked after every test). The port's own contracts of
`test_serve_tier.py` follow, on the port alone.
"""
import dataclasses
import functools
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rff import sample_rff as ref_sample_rff
from repro.kernels import ops as rops
from repro.obs import metrics as ref_metrics
from repro.serve import DeKRRServeEngine as RefEngine
from repro.serve import KernelQuery as RefQuery
from repro.stream import ServeSnapshot as RefSnapshot
from repro.stream import StalenessBound as RefStaleness
import repro_torch.core as T
from conftest import cached_fmaps, cached_split
from repro_torch import interop
from repro_torch.core.rff import FeatureMap
from repro_torch.kernels import ops
from repro_torch.kernels.rff_features import (rff_features_lowp_reference,
                                              rff_features_reference)
from repro_torch.obs import metrics, spans
from repro_torch.serve import (AdmissionQueue, DeKRRReplicaServer,
                               DeKRRServeEngine, KernelQuery,
                               LatencyRecorder, pad_bucket)
from repro_torch.stream import (ServeSnapshot, SnapshotRegistry,
                                StalenessBound, StreamingDeKRR)
from test_torch_gpu import assert_close

U_BF16 = 2.0 ** -8
KINDS = ("cos_bias", "cos_bias", "cos_sin")


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.LAUNCHES}, \
        "a wrapper counted a launch for a CPU tensor"


def _ref_snapshot(seed=0, j=3, d=5, freqs=16, dy=None, kinds=KINDS,
                  version=1) -> RefSnapshot:
    """The reference snapshot of `test_serve_tier.py::_snapshot`."""
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    fmaps, thetas = [], []
    for i in range(j):
        key, k = jax.random.split(key)
        fm = ref_sample_rff(k, d, freqs, 1.0, kind=kinds[i % len(kinds)])
        fmaps.append(fm)
        shape = (fm.num_features,) if dy is None else (fm.num_features, dy)
        thetas.append(jnp.asarray(rng.normal(size=shape)))
    return RefSnapshot(feature_maps=tuple(fmaps), theta=tuple(thetas),
                       staleness=RefStaleness(version, 0, 0, 0.0))


def _port(ref: RefSnapshot) -> ServeSnapshot:
    return interop.snapshot_from_arrays(
        [np.asarray(fm.omega) for fm in ref.feature_maps],
        [None if fm.bias is None else np.asarray(fm.bias)
         for fm in ref.feature_maps],
        [fm.kind for fm in ref.feature_maps],
        [np.asarray(t) for t in ref.theta],
        dataclasses.astuple(ref.staleness), device="cpu")


def _snapshot(seed=0, dy=None, **kw) -> ServeSnapshot:
    return _port(_ref_snapshot(seed=seed, dy=dy, **kw))


def _query_specs(seed, n=12, d=5, scale=1.0):
    """(uid, x, node) triples: mixed 1-D points and [d, m] blocks, some
    per-node queries."""
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n):
        width = int(rng.integers(1, 5))
        x = scale * (rng.normal(size=(d, width)) if uid % 3
                     else rng.normal(size=d))
        out.append((uid, x, int(uid % 3) if uid % 4 == 0 else None))
    return out


def _answers(engine, cls, specs):
    queries = engine.run([cls(uid=u, x=x, node=n) for u, x, n in specs])
    return [(np.asarray(q.prediction, dtype=np.float64), q.staleness)
            for q in queries]


@functools.lru_cache(maxsize=None)
def _ref_answers(dy, backend, precision=None, seed=4):
    snap = _ref_snapshot(seed=seed, dy=dy)
    eng = RefEngine(snap, batch_size=5, backend=backend, precision=precision)
    return _answers(eng, RefQuery, _query_specs(seed, scale=2.0))


def _port_answers(dy, backend, precision=None, seed=4):
    snap = _snapshot(seed=seed, dy=dy)
    eng = DeKRRServeEngine(snap, batch_size=5, backend=backend,
                           precision=precision)
    return _answers(eng, KernelQuery, _query_specs(seed, scale=2.0))


# --------------------------------------------------- parity with the reference
@pytest.mark.parametrize("dy", [None, 3])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("ref_backend", ["xla", "pallas"])
def test_full_precision_answers_match_reference(dy, backend, ref_backend):
    want = _ref_answers(dy, ref_backend)
    got = _port_answers(dy, backend)
    assert len(got) == len(want)
    for (g, gs), (w, ws) in zip(got, want):
        assert g.shape == w.shape
        assert_close(g, w)
        assert dataclasses.astuple(gs) == dataclasses.astuple(ws)
        assert gs.precision == 0.0


@pytest.mark.parametrize("shape", [(16, 5, 13), (37, 5, 13), (200, 148, 64)])
def test_rff_features_reference_matches_jax(shape):
    d_feat, dim, n = shape
    rng = np.random.default_rng(d_feat + n)
    omega = rng.normal(size=(d_feat, dim))
    bias = rng.uniform(0, 2 * np.pi, d_feat)
    x = rng.normal(size=(dim, n))
    scale = float(np.sqrt(2.0 / d_feat))
    want = rops.rff_features(jnp.asarray(omega), jnp.asarray(bias),
                             jnp.asarray(x), scale=scale, interpret=True)
    args = [torch.as_tensor(a) for a in (omega, bias, x)]
    assert_close(rff_features_reference(*args, scale=scale),
                 np.asarray(want))
    got = ops.rff_features(*args, scale=scale)      # CPU: the plain version
    assert got.dtype == torch.float64 and got.shape == (d_feat, n)
    assert_close(got, np.asarray(want))


def _lowp_model_bound(omega, bias, x, scale):
    """s·((3u + γ_d)(|Ω||x| + |b|) + 3u) per entry, in float64."""
    dim = omega.shape[1]
    nu = min(dim * U_BF16, 0.5)
    gamma = nu / (1.0 - nu)
    mag = np.abs(omega) @ np.abs(x) + np.abs(bias)[:, None]
    return scale * ((3 * U_BF16 + gamma) * mag + 3 * U_BF16)


@pytest.mark.parametrize("shape", [(37, 5, 13), (200, 148, 64)])
def test_rff_features_lowp_reference_matches_jax(shape):
    d_feat, dim, n = shape
    rng = np.random.default_rng(7 * d_feat + n)
    omega = rng.normal(size=(d_feat, dim))
    bias = rng.uniform(0, 2 * np.pi, d_feat)
    x32 = rng.normal(size=(dim, n)).astype(np.float32)
    scale = float(np.sqrt(2.0 / d_feat))
    want = np.asarray(rops.rff_features_lowp(
        jnp.asarray(omega), jnp.asarray(bias), jnp.asarray(x32),
        scale=scale, interpret=True))
    args = (torch.as_tensor(omega), torch.as_tensor(bias),
            torch.as_tensor(x32))
    got = rff_features_lowp_reference(*args, scale=scale)
    assert got.dtype == torch.float32
    assert torch.equal(ops.rff_features_lowp(*args, scale=scale), got)
    got = got.numpy()
    exact = scale * np.cos(omega @ x32.astype(np.float64) + bias[:, None])
    bound = _lowp_model_bound(omega, bias, x32.astype(np.float64), scale)
    assert (np.abs(got - exact) <= bound).all()
    assert (np.abs(want - exact) <= bound).all()
    assert np.mean(got == want) >= 0.99


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("dy", [None, 3])
@pytest.mark.parametrize("backend,ref_backend",
                         [("torch", "xla"), ("cuda", "pallas")])
def test_lowp_answers_within_both_bounds(precision, dy, backend,
                                         ref_backend):
    """Each side within its own bound of f_hi, and the port's answers
    and bounds equal to the reference's up to the f32 GEMV's order."""
    hi = _port_answers(dy, backend)
    got = _port_answers(dy, backend, precision)
    want = _ref_answers(dy, ref_backend, precision)
    for (h, _), (g, gs), (w, ws) in zip(hi, got, want):
        assert 0.0 < gs.precision and 0.0 < ws.precision
        assert np.max(np.abs(g - h)) <= gs.precision
        assert np.max(np.abs(w - h)) <= ws.precision
        assert np.max(np.abs(g - w)) <= 1e-5 * np.max(np.abs(w))
        assert gs.precision == pytest.approx(ws.precision, rel=1e-5)


@pytest.mark.parametrize("kind", ["cos_bias", "cos_sin"])
def test_bf16_featurize_matches_reference(kind):
    """The ``torch`` backend's low-precision features: bf16 Ω, b and X
    through `featurize`, the scale rounded to bf16 as the reference
    rounds it."""
    from repro.core.rff import FeatureMap as RefMap
    from repro.core.rff import featurize as ref_featurize
    from repro_torch.core.rff import featurize

    fm = ref_sample_rff(jax.random.PRNGKey(3), 5, 16, 1.0, kind=kind)
    x = np.random.default_rng(3).normal(size=(5, 13)).astype(np.float32)
    lo = RefMap(omega=fm.omega.astype(jnp.bfloat16),
                bias=None if fm.bias is None
                else fm.bias.astype(jnp.bfloat16), kind=kind)
    want = np.asarray(ref_featurize(lo, jnp.asarray(x).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    bf16 = torch.bfloat16
    port = FeatureMap(
        omega=torch.as_tensor(np.array(fm.omega)).to(bf16),
        bias=None if fm.bias is None
        else torch.as_tensor(np.array(fm.bias)).to(bf16), kind=kind)
    got = featurize(port, torch.as_tensor(x).to(bf16)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_snapshot_from_arrays_carries_the_reference_snapshot():
    ref = _ref_snapshot(seed=2, dy=2)
    snap = _port(ref)
    assert snap.device == torch.device("cpu")
    assert snap.dtype == torch.float64 and snap.output_width == 2
    assert snap.input_dim == ref.input_dim
    assert dataclasses.astuple(snap.staleness) == \
        dataclasses.astuple(ref.staleness)
    for fm, rfm, t, rt in zip(snap.feature_maps, ref.feature_maps,
                              snap.theta, ref.theta):
        assert fm.kind == rfm.kind
        np.testing.assert_array_equal(fm.omega.numpy(), np.asarray(rfm.omega))
        assert (fm.bias is None) == (rfm.bias is None)
        np.testing.assert_array_equal(t.numpy(), np.asarray(rt))


def test_obs_copies_match_reference():
    """The port's metric copies report what the reference's report on the
    same samples."""
    lat = [(0.0, 1.0), (0.5, 1.0), (1.0, 9.0), (2.0, 2.5)]
    got, want = metrics.LatencyRecorder(), ref_metrics.LatencyRecorder()
    hist, ref_hist = metrics.Histogram("h"), ref_metrics.Histogram("h")
    for t0, t1 in lat:
        got.record(t0, t1)
        want.record(t0, t1)
        hist.observe(t1 - t0)
        ref_hist.observe(t1 - t0)
    assert dataclasses.astuple(got.report()) == \
        dataclasses.astuple(want.report())
    assert hist.summary() == ref_hist.summary()
    assert sorted(metrics.__all__) == sorted(ref_metrics.__all__)


def test_spans_nest_per_thread_and_record_into_a_registry():
    reg = metrics.Registry()
    with spans.recording(reg) as rec:
        with spans.span("outer"):
            with spans.span("serve.wave", slots=3):
                pass

        def other():
            with spans.span("other"):
                pass

        worker = threading.Thread(target=other, name="replica")
        worker.start()
        worker.join(timeout=10)
    assert not worker.is_alive()
    assert [(s.name, s.depth, s.parent, s.thread) for s in rec.spans] == [
        ("serve.wave", 1, "outer", "MainThread"),
        ("outer", 0, None, "MainThread"), ("other", 0, None, "replica")]
    assert rec.spans[0].attrs == {"slots": 3}
    assert reg.spans == rec.spans
    with spans.span("not recorded"):
        pass
    assert len(rec.spans) == 3


# ----------------------------------------------------------- shared admission
def test_pad_bucket():
    assert pad_bucket(0) == 8
    assert pad_bucket(1) == 8
    assert pad_bucket(8) == 8
    assert pad_bucket(9) == 16
    assert pad_bucket(100) == 128
    assert pad_bucket(3, min_bucket=2) == 4
    with pytest.raises(ValueError):
        pad_bucket(-1)


def test_admission_queue_fifo_and_budgets():
    q = AdmissionQueue()
    for uid, width in enumerate([1, 3, 2, 8, 1]):
        q.admit(uid, uid=uid, width=width, now=float(uid))
    assert len(q) == 5 and q.pending_columns == 15
    wave = q.take_wave(2)
    assert [e.uid for e in wave] == [0, 1]
    wave = q.take_wave(8, max_columns=4)
    assert [e.uid for e in wave] == [2]
    wave = q.take_wave(8, max_columns=4)        # wider than the budget
    assert [e.uid for e in wave] == [3] and wave[0].width == 8
    assert [e.uid for e in q.take_wave(8)] == [4]
    assert q.take_wave(8) == []
    with pytest.raises(ValueError):
        q.admit(9, uid=9, width=0, now=0.0)


class StepClock:
    """Deterministic injectable clock: advances a fixed step per call."""

    def __init__(self, step=0.125):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def test_latency_recorder_deterministic_report():
    rec = LatencyRecorder(StepClock())
    for t_arr, t_done in [(0.0, 1.0), (0.5, 1.0), (1.0, 9.0)]:
        rec.record(t_arr, t_done)
    rep = rec.report()
    lat = np.array([1.0, 0.5, 8.0])
    assert rep.count == 3
    assert rep.p50 == pytest.approx(np.percentile(lat, 50))
    assert rep.p99 == pytest.approx(np.percentile(lat, 99))
    assert rep.qps == pytest.approx(3 / 9.0)
    with pytest.raises(ValueError):
        rec.record(2.0, 1.0)
    rec.reset()
    assert rec.report().count == 0


# ------------------------------------------------- registry and validation
def test_snapshot_registry_versions():
    reg = SnapshotRegistry()
    assert reg.version == 0
    with pytest.raises(LookupError):
        reg.latest()
    snap_a, snap_b = _snapshot(0), _snapshot(1)
    assert reg.publish(snap_a) == 1
    assert reg.publish(snap_b) == 2
    ver, snap = reg.latest_versioned()
    assert ver == 2 and snap is snap_b and reg.latest() is snap_b
    with pytest.raises(TypeError):
        reg.publish("not a snapshot")


def _rebuild(snap, theta=None, fmaps=None):
    return ServeSnapshot(feature_maps=fmaps or snap.feature_maps,
                         theta=tuple(theta or snap.theta),
                         staleness=snap.staleness)


def test_snapshot_rejects_mixed_widths():
    snap = _snapshot()
    theta = list(snap.theta)
    theta[1] = theta[1][:, None].repeat(1, 2)           # node 1 → [D, 2]
    with pytest.raises(ValueError, match="widths"):
        _rebuild(snap, theta)
    t2 = [t[:, None].repeat(1, 2) for t in snap.theta]
    t2[2] = t2[2][:, :1]
    with pytest.raises(ValueError, match="widths"):
        _rebuild(snap, t2)


def test_snapshot_rejects_mixed_dtypes():
    snap = _snapshot()
    theta = list(snap.theta)
    theta[2] = theta[2].to(torch.float32)               # lone f32 node
    with pytest.raises(ValueError, match="float32"):
        _rebuild(snap, theta)


def test_snapshot_rejects_feature_count_mismatch():
    snap = _snapshot()
    theta = list(snap.theta)
    theta[0] = theta[0][:-1]
    with pytest.raises(ValueError, match="num_features"):
        _rebuild(snap, theta)


def test_snapshot_rejects_mixed_devices():
    """θ and maps must share one device; the first node off it is named
    (the meta device stands in for a second device on a CPU-only host)."""
    snap = _snapshot()
    theta = list(snap.theta)
    theta[1] = theta[1].to("meta")
    with pytest.raises(ValueError, match="node 1 has θ on meta"):
        _rebuild(snap, theta)
    fmaps = list(snap.feature_maps)
    fmaps[2] = FeatureMap(omega=fmaps[2].omega.to("meta"), bias=None,
                          kind=fmaps[2].kind)
    with pytest.raises(ValueError, match="node 2 has Ω on meta"):
        _rebuild(snap, fmaps=tuple(fmaps))
    with pytest.raises(TypeError, match="torch tensors"):
        _rebuild(snap, [t.numpy() for t in snap.theta])


# ------------------------------------------------------------- answer path
@pytest.mark.parametrize("dy", [None, 3])
def test_predictions_are_owned_copies(dy):
    snap = _snapshot(dy=dy)
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(5, 6))
    queries = [KernelQuery(uid=0, x=xs[:, :3]),
               KernelQuery(uid=1, x=xs[:, 3:]),
               KernelQuery(uid=2, x=xs[:, :3], node=1)]
    DeKRRServeEngine(snap, batch_size=64).run(queries)
    before = [np.array(q.prediction, copy=True) for q in queries]
    np.asarray(queries[0].prediction)[...] = 1e9
    for q, want in zip(queries[1:], before[1:]):
        np.testing.assert_array_equal(np.asarray(q.prediction), want)


def test_malformed_queries_rejected_at_admission_with_uid():
    eng = DeKRRServeEngine(_snapshot())
    with pytest.raises(ValueError, match="query 41.*input dim 4"):
        eng.run([KernelQuery(uid=41, x=np.zeros(4))])
    with pytest.raises(ValueError, match="query 42"):
        eng.run([KernelQuery(uid=42, x=np.zeros((5, 2, 2)))])
    with pytest.raises(ValueError, match="query 43.*node 7"):
        eng.run([KernelQuery(uid=43, x=np.zeros(5), node=7)])
    with pytest.raises(ValueError, match="query 44"):
        eng.run([KernelQuery(uid=44, x=np.zeros((5, 0)))])
    good = KernelQuery(uid=0, x=np.zeros(5))
    with pytest.raises(ValueError, match="query 45"):
        eng.run([good, KernelQuery(uid=45, x=np.zeros(4))])
    assert not good.done


def _replica_queries():
    rng = np.random.default_rng(11)
    out = []
    for uid in range(17):
        width = int(rng.integers(1, 4)) if uid % 3 else 1
        x = rng.normal(size=(5, width)) if uid % 3 else rng.normal(size=5)
        out.append(KernelQuery(uid=uid, x=x,
                               node=1 if uid % 5 == 0 else None))
    return out


@pytest.mark.parametrize("dy", [None, 2])
def test_replica_parity_vs_single_engine(dy):
    snap = _snapshot(seed=3, dy=dy)
    want = DeKRRServeEngine(snap, batch_size=4).run(_replica_queries())
    reg = SnapshotRegistry()
    reg.publish(snap)
    srv = DeKRRReplicaServer(reg, replicas=3, batch_size=4)
    got = srv.run(_replica_queries())
    for qw, qg in zip(want, got):
        assert_close(np.asarray(qg.prediction), np.asarray(qw.prediction))
        assert qg.staleness == qw.staleness and qg.done
    assert srv.report().count == 17 and srv.waves_served >= 5


def test_engine_serves_freshest_registry_snapshot():
    snap_a, snap_b = _snapshot(0), _snapshot(1)
    reg = SnapshotRegistry()
    reg.publish(snap_a)
    eng = DeKRRServeEngine(reg, batch_size=8)
    x = np.zeros(5)
    a = eng.run([KernelQuery(uid=0, x=x)])[0].prediction
    reg.publish(snap_b)
    b = eng.run([KernelQuery(uid=1, x=x)])[0].prediction
    want_b = DeKRRServeEngine(snap_b).run([KernelQuery(uid=2, x=x)])[0]
    assert a != b
    np.testing.assert_allclose(b, want_b.prediction, rtol=1e-12)


def test_publish_atomicity_with_alternating_snapshots():
    """A writer thread alternately publishes two fixed snapshots while two
    replicas answer: every answer matches exactly one of them (identified
    by its staleness), never a torn mix."""
    snaps = {1: _snapshot(seed=5, version=1),
             2: _snapshot(seed=6, version=2)}
    reg = SnapshotRegistry()
    reg.publish(snaps[1])
    stop = threading.Event()

    def writer():
        k = 0
        while not stop.is_set() and k < 400:
            reg.publish(snaps[2 if k % 2 == 0 else 1])
            k += 1
            time.sleep(0.0002)

    srv = DeKRRReplicaServer(reg, replicas=2, batch_size=2)
    rng = np.random.default_rng(23)
    queries = [KernelQuery(uid=i, x=rng.normal(size=5)) for i in range(40)]
    thread = threading.Thread(target=writer)
    thread.start()
    srv.start()
    try:
        for q in queries:
            srv.submit(q)
    finally:
        srv.stop()
        stop.set()
        thread.join(timeout=30)
    assert not thread.is_alive()
    seen = set()
    for q in queries:
        assert q.done
        version = q.staleness.theta_version
        seen.add(version)
        want = DeKRRServeEngine(snaps[version]).run(
            [KernelQuery(uid=q.uid, x=q.x)])[0].prediction
        other = DeKRRServeEngine(snaps[3 - version]).run(
            [KernelQuery(uid=q.uid, x=q.x)])[0].prediction
        np.testing.assert_allclose(q.prediction, want, rtol=1e-12,
                                   err_msg=f"query {q.uid} torn across "
                                           f"snapshots")
        assert q.prediction != other
    assert seen <= {1, 2}


def _stream(j=3, d_feat=8):
    """A live port stream on `test_serve_tier.py`'s small problem (the
    reference's cached split and maps, carried across)."""
    ds, train, _ = cached_split("air_quality", j, subsample=60, seed=0)
    fmaps = cached_fmaps("air_quality", j, (d_feat,) * j, method="energy",
                         subsample=60, seed=0)
    n = sum(t.num_samples for t in train)
    solver = T.DeKRRSolver(
        T.circulant(j, (1,)),
        [interop.feature_map_from_arrays(np.asarray(f.omega),
                                         np.asarray(f.bias), f.kind,
                                         device="cpu") for f in fmaps],
        [interop.node_data_from_arrays(np.asarray(nd.x), np.asarray(nd.y),
                                       device="cpu") for nd in train],
        T.DeKRRConfig(lam=1e-3, c_nei=0.02 * n), build_aux=False,
        device="cpu")
    return StreamingDeKRR(solver), ds


def test_publish_atomicity_under_interleaved_ingest_solve():
    """A solver thread ingests, solves and publishes while replicas
    answer: every answer matches exactly one published snapshot (its
    staleness identifies it; the prediction equals a clean serve of that
    snapshot) — never a torn mix, and no later ingest or solve writes
    into a published snapshot's tensors."""
    rt, ds = _stream()
    rt.solve()
    reg = SnapshotRegistry()
    published = {}

    def publish():
        snap = rt.snapshot()
        kept = tuple(t.clone() for t in snap.theta)
        published[reg.publish(snap)] = (snap, kept)

    publish()
    rng = np.random.default_rng(23)
    stop = threading.Event()

    def solver_loop():
        k = 0
        while not stop.is_set() and k < 6:
            rt.ingest(k % 3, rng.normal(size=(ds.dim, 8)),
                      rng.normal(size=8))
            rt.solve()
            publish()
            k += 1

    srv = DeKRRReplicaServer(reg, replicas=2, batch_size=2)
    writer = threading.Thread(target=solver_loop)
    queries = [KernelQuery(uid=i, x=rng.normal(size=ds.dim))
               for i in range(60)]
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # switch threads often
    try:
        writer.start()
        srv.start()
        for q in queries:
            srv.submit(q)
    finally:
        srv.stop()
        stop.set()
        writer.join(timeout=60)
        sys.setswitchinterval(before)
    assert not writer.is_alive()

    by_staleness = {snap.staleness: snap
                    for snap, _ in published.values()}
    assert len(by_staleness) == len(published)   # distinct versions
    for snap, kept in published.values():
        assert all(torch.equal(t, c) for t, c in zip(snap.theta, kept))
    for q in queries:
        assert q.done
        snap = by_staleness.get(q.staleness)
        assert snap is not None, \
            f"query {q.uid} answered from an unpublished snapshot"
        want = DeKRRServeEngine(snap).run(
            [KernelQuery(uid=q.uid, x=q.x)])[0].prediction
        np.testing.assert_allclose(q.prediction, want, rtol=1e-12,
                                   err_msg=f"query {q.uid} torn across "
                                           f"snapshots")


def test_engine_resnapshots_a_live_stream_every_wave():
    """`DeKRRServeEngine(rt)` takes one snapshot of the live stream per
    wave (plus one to validate the queries), so an ingest and solve
    between runs reach the next wave's answers and staleness."""
    rt, ds = _stream()
    rt.solve()
    calls = []
    take = rt.snapshot

    def counted():
        calls.append(1)
        return take()

    rt.snapshot = counted
    eng = DeKRRServeEngine(rt, batch_size=2)
    xs = np.random.default_rng(4).normal(size=(ds.dim, 5))
    first = eng.run([KernelQuery(uid=i, x=xs[:, i]) for i in range(5)])
    assert len(calls) == 1 + 3               # validation + 3 waves
    assert {q.staleness.theta_version for q in first} == {1}
    rt.ingest(1, xs, np.ones(5))
    stale = eng.run([KernelQuery(uid=9, x=xs[:, 0])])[0]
    assert stale.staleness.ingests_behind == 1
    rt.solve()
    fresh = eng.run([KernelQuery(uid=i, x=xs[:, i]) for i in range(5)])
    want = DeKRRServeEngine(take()).run(
        [KernelQuery(uid=i, x=xs[:, i]) for i in range(5)])
    for got, w, old in zip(fresh, want, first):
        assert got.staleness.theta_version == 2
        np.testing.assert_allclose(got.prediction, w.prediction,
                                   rtol=1e-12)
        assert got.prediction != old.prediction
    assert got.prediction == pytest.approx(
        float(rt.predict(xs[:, 4:5])[0]), rel=1e-12)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("dy", [None, 2])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_lowp_answers_within_attached_bound(precision, dy, backend):
    """Randomized sweep: every low-precision answer (mean and per-node,
    scalar and block queries) is within its attached precision bound,
    and full-precision answers attach precision == 0."""
    for seed in range(3):
        snap = _snapshot(seed=seed, dy=dy)
        specs = _query_specs(100 + seed, scale=2.0)
        hi = _answers(DeKRRServeEngine(snap, batch_size=5, backend=backend),
                      KernelQuery, specs)
        lo = _answers(DeKRRServeEngine(snap, batch_size=5, backend=backend,
                                       precision=precision),
                      KernelQuery, specs)
        for (h, hs), (g, gs) in zip(hi, lo):
            assert hs.precision == 0.0
            assert gs.precision > 0.0
            err = np.max(np.abs(g - h))
            assert err <= gs.precision, (seed, err, gs.precision)
            assert gs.precision < 1e3 * max(1.0, np.max(np.abs(h)))


def test_lowp_answers_are_close_and_bounded_on_replicas():
    snap = _snapshot(seed=7)
    reg = SnapshotRegistry()
    reg.publish(snap)
    rng = np.random.default_rng(8)
    xs = rng.normal(size=(5, 9))
    hi = DeKRRServeEngine(snap).run(
        [KernelQuery(uid=i, x=xs[:, i]) for i in range(9)])
    srv = DeKRRReplicaServer(reg, replicas=2, batch_size=3,
                             precision="bf16")
    lo = srv.run([KernelQuery(uid=i, x=xs[:, i]) for i in range(9)])
    for qh, ql in zip(hi, lo):
        err = abs(float(ql.prediction) - float(qh.prediction))
        assert err <= ql.staleness.precision
        assert err < 0.1


def test_replica_error_is_raised_by_stop():
    """A wave that fails inside a replica fails the run: `stop()`
    re-raises the replica's error."""
    reg = SnapshotRegistry()
    reg.publish(_snapshot())
    srv = DeKRRReplicaServer(reg, replicas=2, batch_size=2)
    srv.submit(KernelQuery(uid=0, x=np.zeros(5)))
    bad = KernelQuery(uid=1, x=np.zeros(5))
    srv.submit(bad)
    bad.x = np.zeros(4)                 # malformed after admission
    srv.start()
    with pytest.raises(ValueError):
        srv.stop()


# ------------------------------------------------------------------ latency
def test_latency_percentiles_deterministic_under_seeded_trace():
    def one_run():
        reg = SnapshotRegistry()
        reg.publish(_snapshot(seed=2))
        srv = DeKRRReplicaServer(reg, replicas=1, batch_size=4,
                                 clock=StepClock())
        rng = np.random.default_rng(17)
        arrivals = np.cumsum(rng.exponential(0.01, size=20))
        queries = [KernelQuery(uid=i, x=rng.normal(size=5))
                   for i in range(20)]
        srv.run(queries, arrivals=arrivals)
        return srv.report()

    rep_a, rep_b = one_run(), one_run()
    assert rep_a == rep_b
    assert rep_a.count == 20
    assert rep_a.p99 >= rep_a.p50 > 0.0


def test_engine_latency_report_populated():
    eng = DeKRRServeEngine(_snapshot(), batch_size=4)
    eng.run([KernelQuery(uid=i, x=np.zeros(5)) for i in range(9)])
    rep = eng.latency.report()
    assert rep.count == 9 and rep.p99 >= rep.p50 > 0.0 and rep.qps > 0.0


def test_engine_rejects_bad_config():
    snap = _snapshot()
    with pytest.raises(ValueError, match="backend"):
        DeKRRServeEngine(snap, backend="pallas")
    with pytest.raises(ValueError, match="precision"):
        DeKRRServeEngine(snap, precision="fp4")
    with pytest.raises(ValueError, match="batch_size"):
        DeKRRServeEngine(snap, batch_size=0)
    with pytest.raises(TypeError, match="SnapshotRegistry"):
        DeKRRReplicaServer(snap)
    with pytest.raises(TypeError, match="ServeSnapshot"):
        DeKRRServeEngine(snap.theta)
    reg = SnapshotRegistry()
    reg.publish(snap)
    with pytest.raises(ValueError, match="replicas"):
        DeKRRReplicaServer(reg, replicas=0)
    with pytest.raises(ValueError, match="backend"):
        DeKRRReplicaServer(reg, backend="xla")


# ------------------------------------------------------------- wrappers
def test_rff_features_wrappers_check_their_operands():
    omega = torch.zeros((4, 3), dtype=torch.float64)
    bias = torch.zeros(4, dtype=torch.float64)
    x = torch.zeros((3, 5), dtype=torch.float64)
    with pytest.raises(ValueError, match="bias"):
        ops.rff_features(omega, bias[:3], x, scale=1.0)
    with pytest.raises(ValueError, match="x has shape"):
        ops.rff_features(omega, bias, x[:2], scale=1.0)
    with pytest.raises(TypeError, match="dtype"):
        ops.rff_features(omega, bias, x.float(), scale=1.0)
    with pytest.raises(ValueError, match="several devices"):
        ops.rff_features(omega, bias, x.to("meta"), scale=1.0)
    with pytest.raises(TypeError, match="floating point"):
        ops.rff_features_lowp(omega, bias, x.to(torch.int32), scale=1.0)
    z = ops.rff_features_lowp(omega, bias, x[:, :0], scale=1.0)
    assert z.shape == (4, 0) and z.dtype == torch.float32


def test_launch_counter_is_thread_safe():
    """Replicas count launches from several threads: no increment may be
    lost (`ops._count` runs under a lock)."""
    ops.reset_launch_counts()
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            ops._count("rff_features") for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert ops.launch_counts()["rff_features"] == 16000
    finally:
        sys.setswitchinterval(before)
        ops.reset_launch_counts()
