"""The port's packed runtime (pack_problem, step_batched, solve_batched)
held against the JAX reference on the same inputs, float64, rtol 1e-9 and
atol 1e-12·max|ref|; the port's own invariants bit for bit; interop round
trips; and the default-to-the-card rule."""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.dist as RDIST
import repro_torch.core as T
from conftest import REPO_ROOT, cached_fmaps, cached_split
from repro_torch import interop
from repro_torch.dist import (comm_bytes_per_round, pack_problem, pack_theta,
                              solve_batched, step_batched, unpack_theta)
from repro_torch.kernels import ops

CPU = "cpu"
BACKENDS = {"torch": "xla", "cuda": "pallas", "cuda_fused": "pallas_fused"}
TOPOLOGIES = {
    "circulant": lambda m: m.circulant(6, (1, 2)),
    "star": lambda m: m.star(6),
    "erdos_renyi": lambda m: m.erdos_renyi(6, 0.5, seed=1),
}
DIMS = (8, 10, 12, 8, 10, 12)


def assert_close(got, want, rtol=1e-9):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * scale)


@functools.lru_cache(maxsize=None)
def solvers(topo="circulant", dy=1, bags=False):
    """(reference solver, port solver) on one cached problem."""
    _, train, _ = cached_split("air_quality", 6, subsample=300)
    fmaps = cached_fmaps("air_quality", 6, DIMS, subsample=300)
    if dy > 1:
        train = [R.NodeData(x=n.x, y=jnp.stack(
            [n.y * (1 - 0.4 * o) + 0.05 * o for o in range(dy)], axis=1))
            for n in train]
    if bags:
        train = [R.NodeData(x=n.x, y=n.y[: (n.num_samples + 1) // 2],
                            bags=jnp.arange(n.num_samples) // 2)
                 for n in train]
    n = sum(nd.num_samples for nd in train)
    cfg = dict(lam=1e-4, c_nei=0.05 * n)
    ref = R.DeKRRSolver(TOPOLOGIES[topo](R), fmaps, train,
                        R.DeKRRConfig(**cfg), build_aux=False)
    port = T.DeKRRSolver(
        TOPOLOGIES[topo](T),
        [interop.feature_map_from_arrays(np.asarray(f.omega),
                                         np.asarray(f.bias), f.kind,
                                         device=CPU) for f in fmaps],
        [interop.node_data_from_arrays(
            np.asarray(nd.x), np.asarray(nd.y),
            None if nd.bags is None else np.asarray(nd.bags), device=CPU)
         for nd in train],
        T.DeKRRConfig(**cfg), build_aux=False, device=CPU)
    return ref, port


@functools.lru_cache(maxsize=None)
def packs(dy=1):
    ref, port = solvers(dy=dy)
    return (RDIST.pack_problem(ref, gram_backend="xla"),
            pack_problem(port, gram_backend="cuda", device=CPU))


# -------------------------------------------------------------------- pack
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("ref_gram,gram", [("xla", "torch"),
                                           ("pallas", "cuda")])
def test_pack_matches_reference(topo, ref_gram, gram):
    ref, port = solvers(topo)
    want = RDIST.pack_problem(ref, gram_backend=ref_gram)
    got = pack_problem(port, gram_backend=gram, device=CPU)
    for f in ("g", "d", "s", "p", "theta_mask", "nbr_mask"):
        assert_close(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.nbr_idx.numpy(),
                                  np.asarray(want.nbr_idx))
    assert (got.offsets, got.node_dims, got.num_edges_directed) == \
        (want.offsets, want.node_dims, want.num_edges_directed)
    assert ops.launch_counts()["rff_gram"] == 0


def test_pack_multi_output_and_aux_method_match():
    ref, port = solvers(dy=3)
    want, got = packs(dy=3)
    assert got.d.shape == (6, 12, 3)
    assert_close(got.d, want.d)
    assert_close(got.g, want.g)
    aux = pack_problem(port, method="aux", gram_backend="torch", device=CPU)
    want_aux = RDIST.pack_problem(ref, method="aux")
    for f in ("g", "d", "s", "p"):
        assert_close(getattr(aux, f), getattr(want_aux, f))


def test_cos_sin_and_single_node_packs_match():
    """cos_sin maps take the torch Gram path even under gram_backend
    "cuda"; a single node has K = 0 slots."""
    _, train, _ = cached_split("air_quality", 3, subsample=300)
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    fmaps = [R.select_features(keys[j], 13, 6 + j, 1.0, train[j].x,
                               train[j].y, candidate_ratio=4,
                               kind="cos_sin") for j in range(3)]
    for topo, nodes in ((R.circulant(3, (1,)), slice(0, 3)),
                        (R.Topology(adjacency=np.zeros((1, 1), bool)),
                         slice(0, 1))):
        ref = R.DeKRRSolver(topo, fmaps[nodes], train[nodes],
                            R.DeKRRConfig(lam=1e-3, c_nei=5.0),
                            build_aux=False)
        port = T.DeKRRSolver(
            T.Topology(adjacency=topo.adjacency,
                       circulant_offsets=topo.circulant_offsets),
            [interop.feature_map_from_arrays(np.asarray(f.omega), None,
                                             f.kind, device=CPU)
             for f in fmaps[nodes]],
            [interop.node_data_from_arrays(np.asarray(nd.x),
                                           np.asarray(nd.y), device=CPU)
             for nd in train[nodes]],
            T.DeKRRConfig(lam=1e-3, c_nei=5.0), build_aux=False,
            device=CPU)
        want = RDIST.pack_problem(ref, gram_backend="xla")
        got = pack_problem(port, device=CPU)
        for f in ("g", "d", "s", "p"):
            assert_close(getattr(got, f), getattr(want, f))
        assert_close(solve_batched(got, 20),
                     RDIST.solve_batched(want, 20, backend="xla"))


def test_bagged_pack_downgrades_loudly():
    _, port = solvers(topo="star", bags=True)
    with pytest.warns(UserWarning, match="downgraded to method='aux'"):
        packed = pack_problem(port, gram_backend="torch", device=CPU)
    ref, _ = solvers(topo="star", bags=True)
    assert_close(packed.g, RDIST.pack_problem(ref, method="aux").g)
    with pytest.raises(ValueError, match="impossible"):
        pack_problem(port, gram_backend="cuda", device=CPU)
    with pytest.raises(ValueError, match="ignores gram_backend"):
        pack_problem(solvers()[1], method="aux", gram_backend="cuda",
                     device=CPU)


@pytest.mark.parametrize("method", ["batched", "aux"])
def test_instrumented_pack_problem_emits_span(method, monkeypatch):
    """Both builds run inside one ``pack_problem`` span with the
    reference's attributes (nodes, method), from before the first stage
    of the build to after its last."""
    from repro.obs import Registry as RefRegistry
    from repro.obs import spans as ref_spans
    from repro_torch.dist import dekrr_spmd
    from repro_torch.obs import metrics, spans

    ref, port = solvers()
    ref_reg = RefRegistry()
    with ref_spans.recording(ref_reg):
        RDIST.pack_problem(ref, method=method)
    want = [(sp.name, sp.attrs) for sp in ref_reg.spans
            if sp.name == "pack_problem"]

    ticks = iter(range(1_000_000))
    clock = lambda: float(next(ticks))
    marks = []

    def marked(fn):
        def inner(*args, **kwargs):
            marks.append(clock())
            out = fn(*args, **kwargs)
            marks.append(clock())
            return out
        return inner

    stages = (("_stage_packed_inputs", "_finish_packed") if method == "batched"
              else ("_pack_problem_from_aux",))
    for name in stages:
        monkeypatch.setattr(dekrr_spmd, name,
                            marked(getattr(dekrr_spmd, name)))
    reg = metrics.Registry()
    with spans.recording(reg, clock=clock):
        pack_problem(port, method=method, device=CPU)
    got = [sp for sp in reg.spans if sp.name == "pack_problem"]
    assert [(sp.name, sp.attrs) for sp in got] == want == [
        ("pack_problem", {"nodes": port.J, "method": method})]
    assert len(marks) == 2 * len(stages)
    assert got[0].t_start < min(marks) and max(marks) < got[0].t_end


def test_entry_points_default_to_the_card():
    _, port = solvers()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pack_problem(port)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.DeKRRSolver(T.circulant(6, (1, 2)), port.feature_maps, port.data)


# ---------------------------------------------------------- step and solve
@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("dy", [1, 3])
def test_step_batched_matches_reference(backend, dy):
    want_p, got_p = packs(dy)
    rng = np.random.default_rng(dy)
    theta = rng.normal(size=tuple(got_p.d.shape)) \
        * got_p.theta_mask.numpy().reshape(6, 12, *([1] * (dy > 1)))
    want = RDIST.step_batched(want_p, jnp.asarray(theta), backend="xla")
    got = step_batched(got_p, torch.as_tensor(theta), backend=backend)
    assert_close(got, want)


@functools.lru_cache(maxsize=None)
def reference_solve(dy, tol, warm, chunk):
    want_p, got_p = packs(dy)
    theta0 = None
    if warm:
        theta0 = jnp.asarray(np.random.default_rng(7).normal(
            size=tuple(got_p.d.shape)) * 0.1)
    out = RDIST.solve_batched(want_p, 200, theta0, backend="xla", tol=tol,
                              chunk_rounds=chunk, return_rounds=True,
                              return_trace=True)
    return theta0, out


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("tol", [0.0, 1e-3])
@pytest.mark.parametrize("dy", [1, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_solve_batched_matches_reference(backend, tol, dy, warm):
    # the tol check's default cadence: every round, every 32 when fused
    chunk = 32 if backend == "cuda_fused" and tol else None
    theta0, (want, want_rounds, want_trace) = reference_solve(dy, tol, warm,
                                                              chunk)
    _, got_p = packs(dy)
    got, rounds, trace = solve_batched(
        got_p, 200, None if theta0 is None else torch.as_tensor(
            np.array(theta0)), backend=backend, tol=tol,
        return_rounds=True, return_trace=True)
    assert rounds == int(want_rounds)
    assert_close(got, want)
    assert_close(trace.residuals, want_trace.residuals)
    if tol:
        assert rounds < 200         # the tol stop fired
    # padded coordinates stay exactly zero
    pad = got_p.theta_mask == 0
    assert (got[pad] == 0).all()
    plain = solve_batched(got_p, 200, backend=backend, tol=tol) \
        if not warm else None
    if plain is not None:
        assert torch.equal(plain, got)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_chunked_solve_is_bit_identical(backend):
    _, packed = packs(1)
    whole, res = solve_batched(packed, 30, backend=backend,
                               return_trace=True)
    for chunk in (1, 7, 64):
        got, got_res = solve_batched(packed, 30, backend=backend,
                                     chunk_rounds=chunk, return_trace=True)
        assert torch.equal(got, whole), chunk
        assert torch.equal(got_res.residuals, res.residuals), chunk


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_trailing_unit_output_axis_is_bit_identical(backend):
    _, packed = packs(1)
    trailing = interop.packed_from_arrays(
        **{**interop.packed_to_arrays(packed),
           "d": interop.to_numpy(packed.d)[..., None]}, device=CPU)
    scalar = solve_batched(packed, 25, backend=backend)
    multi = solve_batched(trailing, 25, backend=backend)
    assert multi.shape == scalar.shape + (1,)
    assert torch.equal(multi[..., 0], scalar)


def test_fused_and_per_round_backends_agree_bit_for_bit_on_cpu():
    _, packed = packs(3)
    assert torch.equal(solve_batched(packed, 20, backend="cuda"),
                       solve_batched(packed, 20, backend="cuda_fused"))


def test_solve_argument_checks():
    _, packed = packs(1)
    with pytest.raises(ValueError, match="backend"):
        solve_batched(packed, 3, backend="pallas")
    with pytest.raises(ValueError, match="tol"):
        solve_batched(packed, 3, tol=-1.0)
    with pytest.raises(ValueError, match="chunk_rounds"):
        solve_batched(packed, 3, chunk_rounds=0)


# ------------------------------------------------------------------ interop
def test_reference_packing_carried_across_solves_the_same():
    want_p, _ = packs(1)
    carried = interop.packed_from_arrays(
        **{f: np.asarray(getattr(want_p, f))
           for f in ("g", "d", "s", "p", "theta_mask", "nbr_idx",
                     "nbr_mask")},
        offsets=want_p.offsets, node_dims=want_p.node_dims,
        num_edges_directed=want_p.num_edges_directed, device=CPU)
    want = RDIST.solve_batched(want_p, 40, backend="pallas_fused")
    assert_close(solve_batched(carried, 40), want)


def test_port_packing_carried_back_solves_the_same():
    _, got_p = packs(1)
    arrays = interop.packed_to_arrays(got_p)
    back = RDIST.PackedProblem(**{
        k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
        for k, v in arrays.items()})
    theta = solve_batched(got_p, 40, backend="cuda")
    assert_close(theta, RDIST.solve_batched(back, 40, backend="xla"))
    ragged = unpack_theta(got_p, theta)
    assert [t.shape[0] for t in ragged] == list(DIMS)
    assert torch.equal(pack_theta(got_p, ragged), theta)
    ref_ragged = RDIST.unpack_theta(back, jnp.asarray(
        interop.to_numpy(theta)))
    for a, b in zip(ragged, ref_ragged):
        np.testing.assert_array_equal(interop.to_numpy(a), np.asarray(b))


def test_pack_theta_rejects_stale_layouts():
    _, packed = packs(1)
    theta = unpack_theta(packed, torch.zeros(6, 12, dtype=torch.float64))
    with pytest.raises(ValueError, match="nodes"):
        pack_theta(packed, theta[:-1])
    with pytest.raises(ValueError, match="stale"):
        pack_theta(packed, [torch.zeros(13, dtype=torch.float64)] * 6)
    with pytest.raises(ValueError, match="output width"):
        pack_theta(packed, [t[:, None] for t in theta])
    with pytest.raises(ValueError, match="different packing"):
        unpack_theta(packed, torch.zeros(6, 11, dtype=torch.float64))


@pytest.mark.parametrize("mode", ["ppermute", "allgather"])
def test_comm_bytes_match_reference(mode):
    want_p, got_p = packs(3)
    for kw in ({}, {"activation_prob": 0.5, "censor_fraction": 0.2},
               {"gossip": "edge"}):
        assert comm_bytes_per_round(got_p, mode, **kw) == \
            RDIST.comm_bytes_per_round(want_p, mode, **kw)


# -------------------------------------------------------------- chip_smoke
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_rehearses_the_main_path_on_cpu(capsys):
    assert _chip_smoke().main(["--cpu-rehearsal"]) == 0
    out = capsys.readouterr().out
    assert '"cpu_rehearsal"' in out and '"ok"' not in out


def test_chip_smoke_fails_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert _chip_smoke().main([]) != 0
    captured = capsys.readouterr()
    assert "CUDA device" in captured.err and captured.out == ""
