"""Each CUDA kernel against its plain PyTorch version on the card.

The kernels have no CPU mode, so every test here is marked ``gpu`` and
skips without a CUDA device. The file imports neither JAX nor the JAX
package, so it also runs where only the port is installed:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: rtol 1e-9 in float64 and 1e-4 in float32, with an atol of
rtol·max|plain| (the sums run in another order on the card).
"""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.analysis.smem import PATH_SHAPES
from repro_torch.dist import AsyncGossipState, async_step_batched
from repro_torch.kernels import ops
from repro_torch.kernels.dekrr_solve import dekrr_solve_reference
from repro_torch.kernels.dekrr_step import (dekrr_step_masked_reference,
                                            dekrr_step_reference)
from repro_torch.kernels.rff_gram import rff_gram_batched_reference

CASES = [
    # (J, K, D, Dy, extra θ-table rows)
    (5, 3, 12, 1, 0),
    (5, 3, 12, 3, 0),
    (4, 2, 9, 1, 3),       # T > J
    (4, 2, 9, 3, 2),       # T > J, Dy = 3
    (3, 0, 7, 1, 0),       # K = 0, the edgeless graph
    (3, 0, 7, 3, 1),
]


def assert_close(got, want, rtol=1e-9):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    scale = np.abs(want).max() if want.size else 0.0
    atol = (1e-12 if rtol <= 1e-9 else rtol) * scale
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def dekrr_case(j_nodes, k_slots, d_feat, dy, extra_rows, seed, *,
               masked=True):
    """numpy operands of one packed round: g, d, s, p, theta, nbr_idx,
    self_idx, nbr_mask (θ table of J + extra_rows rows)."""
    rng = np.random.default_rng(seed)
    t_rows = j_nodes + extra_rows
    scale = 0.5 / d_feat
    tail = () if dy == 1 else (dy,)
    g = rng.normal(size=(j_nodes, d_feat, d_feat)) * scale
    s = rng.normal(size=(j_nodes, d_feat, d_feat)) * scale
    p = rng.normal(size=(j_nodes, k_slots, d_feat, d_feat)) * scale
    d = rng.normal(size=(j_nodes, d_feat) + tail)
    theta = rng.normal(size=(t_rows, d_feat) + tail)
    nbr_idx = rng.integers(0, t_rows, (j_nodes, k_slots)).astype(np.int32)
    self_idx = rng.permutation(t_rows)[:j_nodes].astype(np.int32)
    nbr_mask = (rng.integers(0, 2, (j_nodes, k_slots)) if masked
                else np.ones((j_nodes, k_slots))).astype(np.float64)
    return g, d, s, p, theta, nbr_idx, self_idx, nbr_mask


def async_case(j_nodes, k_slots, d_feat, dy, extra_rows, *, rounds, seed):
    """numpy operands of the async chain: g, d, s, p, theta [T], sent [T],
    buffers [J, K, D], nbr_idx (node ids), nbr_mask, active [R, J] int32,
    thresholds [R] (drawn around the censor deltas of these operands, so
    the censor fires on some node-rounds)."""
    g, d, s, p, _, _, _, nbr_mask = dekrr_case(j_nodes, k_slots, d_feat, dy,
                                               0, seed)
    rng = np.random.default_rng(seed + 100)
    tail = () if dy == 1 else (dy,)
    theta = rng.normal(size=(j_nodes + extra_rows, d_feat) + tail)
    sent = theta + 0.5 * rng.normal(size=theta.shape)
    buffers = rng.normal(size=(j_nodes, k_slots, d_feat) + tail)
    nbr_idx = rng.integers(0, j_nodes, (j_nodes, k_slots)).astype(np.int32)
    active = rng.integers(0, 2, (rounds, j_nodes)).astype(np.int32)
    thresholds = rng.uniform(0.3, 1.5, rounds)
    return (g, d, s, p, theta, sent, buffers, nbr_idx, nbr_mask, active,
            thresholds)


def to_t(arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ops.reset_launch_counts()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-9),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("j,k,dfeat,dy,extra", CASES)
def test_gpu_dekrr_kernels_match_plain(cuda_device, dtype, rtol, j, k,
                                       dfeat, dy, extra):
    args = [a.to(cuda_device) for a in to_t(
        dekrr_case(j, k, dfeat, dy, extra, seed=j * 10 + k + dy))]
    args = [a.to(dtype) if a.is_floating_point() else a for a in args]
    lay = ops._pad_dekrr_operands("t", *args)[2]
    want = ops._unflatten_dy(dekrr_step_reference(*lay, dy=dy), dy,
                             args[1].ndim)
    got = ops.dekrr_step(*args)
    torch.cuda.synchronize()
    assert_close(got, want.cpu(), rtol=rtol)
    got, res = ops.dekrr_solve(*args, num_rounds=7, trace=True)
    want, wres = dekrr_solve_reference(*lay, num_rounds=7, dy=dy, trace=True)
    torch.cuda.synchronize()
    assert_close(got, ops._unflatten_dy(want, dy, args[1].ndim).cpu(),
                 rtol=rtol)
    assert_close(res, wres.cpu(), rtol=rtol)
    assert ops.LAUNCHES["dekrr_step"] == 1
    assert ops.LAUNCHES["dekrr_solve"] == 1


# (B, F, d, N): ragged 16-row blocks; the main path's two calls (own
# blocks, slot blocks); N inside one 32-column tile; F past one group of
# Gram blocks (Z recomputed per group, cluster of 4); Ω streamed through
# shared memory (cluster of 8); F = 561 and 600, past the clusters' shared
# memory in f64 (the wide route; f32 still on a cluster); F = 1,025 and
# 1,100, the wide route in both dtypes
GRAM_SHAPES = [(3, 70, 13, 300), (10, 200, 148, 3180), (40, 200, 148, 3180),
               (2, 200, 148, 21), (2, 330, 21, 700), (1, 512, 148, 300),
               (3, 561, 148, 333), (1, 600, 148, 300), (1, 1025, 30, 200),
               (2, 1100, 21, 100)]


def gram_case(b, f, dim, n, seed):
    """Ω ~ N(0, 1), b ~ U[0, 2π), X ~ U[0, 1), y ~ N(0, 1), the last 7
    columns masked (padding), as `pack_problem` stages them."""
    rng = np.random.default_rng(seed)
    mask = (np.arange(n) < n - 7).astype(float)[None].repeat(b, 0)
    return (rng.normal(size=(b, f, dim)), rng.uniform(0, 2 * np.pi, (b, f)),
            rng.uniform(size=(b, dim, n)), rng.normal(size=(b, n)), mask)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-9),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,f,dim,n", GRAM_SHAPES)
def test_gpu_rff_gram_matches_plain(cuda_device, dtype, rtol, b, f, dim, n):
    """Against the plain version; a second launch gives the same bits and
    G is exactly symmetric."""
    args = [a.to(cuda_device, dtype) for a in to_t(gram_case(b, f, dim, n,
                                                             seed=f + n))]
    got = ops.rff_gram_batched(*args)
    want = rff_gram_batched_reference(*args)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert_close(a, w.cpu(), rtol=rtol)
    assert ops.LAUNCHES["rff_gram"] == 1
    again = ops.rff_gram_batched(*args)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    assert torch.equal(got[0], got[0].transpose(1, 2))
    scale = 0.37
    one = ops.rff_gram(args[0][0], args[1][0], args[2][0], args[3][0],
                       scale=scale)
    plain = rff_gram_batched_reference(*(a[:1] for a in args[:4]),
                                       torch.ones_like(args[4][:1]),
                                       scale=scale)
    for a, w in zip(one, plain):
        assert_close(a, w[0].cpu(), rtol=rtol)
    assert ops.LAUNCHES["rff_gram"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol,b,f,dim,n,cap_panels", [
    (torch.float64, 1e-9, 3, 600, 148, 700, 2),
    (torch.float32, 1e-4, 2, 1100, 21, 300, 1)])
def test_gpu_rff_gram_wide_route_passes_and_chunks(cuda_device, monkeypatch,
                                                   dtype, rtol, b, f, dim, n,
                                                   cap_panels):
    """The wide route with the workspace cap cut to `cap_panels` of one
    problem's 64-column Z panels: passes of fewer problems than B and
    many N chunks, each chunk's sums added in chunk order, still against
    the plain version, G == Gᵀ exactly and the same bits twice."""
    import importlib

    rg = importlib.import_module("repro_torch.kernels.rff_gram")
    item = torch.finfo(dtype).bits // 8
    f_pad = -(-f // rg.GRAM_WIDE_TILE) * rg.GRAM_WIDE_TILE
    monkeypatch.setattr(rg, "GRAM_WORKSPACE_CAP",
                        cap_panels * f_pad * rg.GRAM_WIDE_TILE * item)
    plan = rg.gram_plan(b, f, dim, n, item=item)
    assert isinstance(plan, rg.WideGramPlan)
    assert plan.batch < b and plan.chunks > 1
    args = [a.to(cuda_device, dtype) for a in to_t(gram_case(b, f, dim, n,
                                                             seed=f + n))]
    got = ops.rff_gram_batched(*args)
    want = rff_gram_batched_reference(*args)
    again = ops.rff_gram_batched(*args)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert_close(a, w.cpu(), rtol=rtol)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    assert torch.equal(got[0], got[0].transpose(1, 2))
    assert ops.LAUNCHES["rff_gram"] == 2


# CASES plus the paper's D = 200 (clusters of 7), D above the round
# kernel's 8 blocks × 32 warps of rows (clusters of 8, 33 and 38 rows a
# block), and J = 40 at D = 200: 280 blocks, more clusters than the card
# holds at once, so a chain's clusters loop over nodes
STEP_CASES = CASES + [(3, 2, 200, 1, 0), (3, 2, 150, 3, 2), (2, 0, 257, 1, 1),
                      (2, 1, 300, 3, 0), (40, 4, 200, 1, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("j,k,dfeat,dy,extra", STEP_CASES)
def test_gpu_step_launches_equal_one_solve_launch(cuda_device, j, k, dfeat,
                                                  dy, extra):
    """R = 7 round launches equal one dekrr_solve launch of 7 rounds bit
    for bit (each node's rows spread over a cluster in both, the chain's
    clusters looping over nodes where J is past what the card holds),
    table rows owned by no node kept."""
    from repro_torch.kernels.dekrr_step import dekrr_step_cuda

    args = [a.to(cuda_device) for a in to_t(
        dekrr_case(j, k, dfeat, dy, extra, seed=j * 10 + k + dy))]
    lay = ops._pad_dekrr_operands("t", *args)[2]
    fused = ops.dekrr_solve(*args, num_rounds=7)
    table = lay[4].clone()
    own = lay[6].long()
    for _ in range(7):
        out = torch.empty((j * dy, dfeat), dtype=table.dtype,
                          device=cuda_device)
        dekrr_step_cuda(  # analysis: ignore[R004]
            *lay[:4], table, *lay[5:], out, dy=dy)
        table = table.clone()
        table.view(-1, dy, dfeat)[own] = out.view(j, dy, dfeat)
    torch.cuda.synchronize()
    got = ops._unflatten_dy(table.view(-1, dy, dfeat)[own].reshape(
        j * dy, dfeat), dy, args[1].ndim)
    assert torch.equal(got, fused)
    assert ops.LAUNCHES["dekrr_solve"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-9),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("j,k,dfeat,dy,extra", CASES)
def test_gpu_masked_round_matches_plain(cuda_device, dtype, rtol, j, k,
                                        dfeat, dy, extra):
    args = [a.to(cuda_device) for a in to_t(
        dekrr_case(j, k, dfeat, dy, extra, seed=j * 10 + k + dy))]
    args = [a.to(dtype) if a.is_floating_point() else a for a in args]
    active = (torch.arange(j, device=cuda_device) % 2).to(torch.int32)
    lay = ops._pad_dekrr_operands("t", *args)[2]
    want = ops._unflatten_dy(dekrr_step_masked_reference(*lay, active,
                                                         dy=dy),
                             dy, args[1].ndim)
    got = ops.dekrr_step(*args, active)
    torch.cuda.synchronize()
    assert_close(got, want.cpu(), rtol=rtol)
    ones = torch.ones(j, dtype=torch.int32, device=cuda_device)
    assert torch.equal(ops.dekrr_step(*args, ones), ops.dekrr_step(*args))
    assert ops.LAUNCHES["dekrr_step_masked"] == 2
    assert ops.LAUNCHES["dekrr_step"] == 1


ASYNC_CASES = [c for c in CASES if c[4] == 0] + [
    (4, 2, 9, 3, 2), (3, 2, 200, 1, 0), (2, 1, 257, 3, 0), (2, 2, 300, 1, 0),
    (40, 4, 200, 1, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-9),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("j,k,dfeat,dy,extra", ASYNC_CASES)
@pytest.mark.parametrize("gossip", ["bernoulli", "edge"])
@pytest.mark.parametrize("censored", [False, True])
def test_gpu_async_chain_matches_plain(cuda_device, dtype, rtol, j, k,
                                       dfeat, dy, extra, gossip, censored):
    """The async-chain kernel against its plain version, and (f64, T = J)
    bit for bit against the masked round kernel run round by round with
    the delivery rule."""
    cpu = [a.to(dtype) if a.is_floating_point() else a for a in to_t(
        async_case(j, k, dfeat, dy, extra, rounds=6, seed=j + k + dy))]
    kw = dict(gossip=gossip, censored=censored, trace=True)
    want = ops.dekrr_async_solve(*cpu, **kw)
    got = ops.dekrr_async_solve(*[a.to(cuda_device) for a in cpu], **kw)
    torch.cuda.synchronize()
    for a, w in zip(got[:4], want[:4]):
        assert_close(a, w, rtol=rtol)
    assert torch.equal(got[4].cpu(), want[4])
    assert ops.LAUNCHES["dekrr_async_solve"] == 1
    if dtype != torch.float64 or extra:
        return
    g, d, s, p, theta, sent, bufs, nbr_idx, nbr_mask, active, thr = (
        a.to(cuda_device) for a in cpu)
    packed = interop.packed_from_arrays(
        g=cpu[0].numpy(), d=cpu[1].numpy(), s=cpu[2].numpy(),
        p=cpu[3].numpy(), theta_mask=np.ones((j, dfeat)),
        nbr_idx=cpu[7].numpy(), nbr_mask=cpu[8].numpy(), device=cuda_device)
    state = AsyncGossipState(theta, sent, bufs)
    for r in range(active.shape[0]):
        state, _ = async_step_batched(packed, state, active[r], thr[r],
                                      gossip=gossip, censored=censored,
                                      backend="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got[0], state.theta)
    assert torch.equal(got[1], state.sent)
    assert torch.equal(got[2], state.buffers)
    assert ops.LAUNCHES["dekrr_step_masked"] == active.shape[0]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["dekrr_solve", "dekrr_async_solve",
                                    "dekrr_cheb_solve"])
def test_gpu_chain_refuses_more_clusters_than_the_card_holds(cuda_device,
                                                             kernel):
    """A grid of more clusters than the card holds at once would wait at
    its first grid barrier for clusters that cannot be scheduled: the C
    entry point refuses it with an error code and nothing is written.
    `chain_plan`'s grid then runs the same operands."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.dekrr_solve import (chain_max_clusters,
                                                 chain_plan,
                                                 dekrr_async_solve_reference,
                                                 dekrr_cheb_solve_reference)

    k, dfeat, rounds = 2, 200, 3
    fits = chain_max_clusters(kernel, k, dfeat, 1, torch.float64)
    blocks, rows, _ = chain_plan(1, dfeat, fits)
    j = fits(blocks) + 1
    kw = dict(dtype=torch.float64, device=cuda_device)
    out = torch.full((j, dfeat), float("nan"), **kw)
    if kernel == "dekrr_solve":
        lay = ops._pad_dekrr_operands("t", *[a.to(cuda_device) for a in to_t(
            dekrr_case(j, k, dfeat, 1, 0, seed=5))])[2]
        tensors = lay + (out, None, torch.empty((2, j, dfeat), **kw))
        sizes = (rounds, j, k, dfeat, 1, j)
        want = dekrr_solve_reference(*lay, num_rounds=rounds, dy=1)
    elif kernel == "dekrr_cheb_solve":
        lay = ops._pad_dekrr_operands("t", *[a.to(cuda_device) for a in to_t(
            dekrr_case(j, k, dfeat, 1, 0, seed=5))])[2]
        rng = np.random.default_rng(5)
        raw = lay[:5] + (torch.as_tensor(rng.normal(size=(j, dfeat)),
                                         **kw),) + lay[5:] + (
            torch.as_tensor(rng.uniform(0.5, 1.5, rounds), **kw),
            torch.as_tensor(rng.uniform(0.0, 0.3, rounds), **kw))
        tensors = raw + (out, torch.empty((j, dfeat), **kw), None,
                         torch.empty((2, j, dfeat), **kw))
        sizes = (rounds, j, k, dfeat, 1, j)
        want = dekrr_cheb_solve_reference(*raw, dy=1)[0]
    else:
        g, d, s, p, theta, sent, bufs, nbr_idx, nbr_mask, act, thr = (
            a.to(cuda_device) for a in to_t(
                async_case(j, k, dfeat, 1, 0, rounds=rounds, seed=5)))
        lay = ops._pad_dekrr_operands(
            "t", g, d, s, p, theta, nbr_idx,
            torch.arange(j, dtype=torch.int32, device=cuda_device),
            nbr_mask)[2]
        raw = lay[:5] + (sent, bufs.reshape(j * k, dfeat), lay[5], lay[7],
                         act, thr)
        tensors = raw + (out, torch.empty((j, dfeat), **kw),
                         torch.empty((j * k, dfeat), **kw), None, None,
                         torch.empty((2, j, dfeat), **kw),
                         torch.empty((2 * j,), dtype=torch.int32,
                                     device=cuda_device))
        sizes = (rounds, j, k, dfeat, 1, j, 0, 0)   # not censored, bernoulli
        want = dekrr_async_solve_reference(
            *raw, censored=False, edge_gossip=False, dy=1)[0]
    fn = getattr(_build.library(kernel), f"{kernel}_f64")
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    stream = torch.cuda.current_stream().cuda_stream
    code = fn(*ptrs, *sizes, blocks, rows, j, stream)
    with pytest.raises(RuntimeError, match="failed with CUDA error"):
        _build.check(code, kernel)
    torch.cuda.synchronize()
    assert torch.isnan(out).all()
    _build.check(fn(*ptrs, *sizes, *chain_plan(j, dfeat, fits), stream),
                 kernel)
    torch.cuda.synchronize()
    assert_close(out, want.cpu())


# CASES plus the paper's D = 200 (clusters of 7), D = 257 at Dy = 3
# (clusters of 8), and J = 40 at D = 200, past the clusters the card holds
# at once, so the chain's clusters loop over nodes
CHEB_CASES = CASES + [(3, 2, 200, 1, 0), (2, 1, 257, 3, 0), (40, 4, 200, 1, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-9),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("j,k,dfeat,dy,extra", CHEB_CASES)
def test_gpu_cheb_chain_matches_plain(cuda_device, dtype, rtol, j, k, dfeat,
                                      dy, extra):
    """The Chebyshev-chain kernel against its plain version; chunked
    launches equal one launch bit for bit, and (T = J) so does the scan
    of round launches with the update in torch's elementwise operations,
    the per-round `cuda` backend's `chebyshev_scan`."""
    from repro_torch.core.acceleration import chebyshev_scan

    cpu = [a.to(dtype) if a.is_floating_point() else a for a in to_t(
        dekrr_case(j, k, dfeat, dy, extra, seed=j * 10 + k + dy))]
    rng = np.random.default_rng(j + k)
    delta = torch.as_tensor(rng.normal(size=tuple(cpu[1].shape)),
                            dtype=dtype)
    alphas = torch.as_tensor(rng.uniform(0.5, 1.5, 7), dtype=dtype)
    betas = torch.as_tensor(rng.uniform(0.0, 0.3, 7), dtype=dtype)
    cpu = cpu[:5] + [delta] + cpu[5:] + [alphas, betas]
    want = ops.dekrr_cheb_solve(*cpu, trace=True)
    dev = [a.to(cuda_device) for a in cpu]
    got = ops.dekrr_cheb_solve(*dev, trace=True)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert_close(a, w, rtol=rtol)
    assert ops.LAUNCHES["dekrr_cheb_solve"] == 1
    if extra:                   # a chunk boundary carries only the J rows
        return
    dev[7] = torch.arange(j, dtype=torch.int32, device=cuda_device)
    whole = ops.dekrr_cheb_solve(*dev, trace=True)
    first = ops.dekrr_cheb_solve(*dev[:9], dev[9][:3], dev[10][:3],
                                 trace=True)
    rest = ops.dekrr_cheb_solve(*dev[:4], first[0], first[1], *dev[6:9],
                                dev[9][3:], dev[10][3:], trace=True)
    torch.cuda.synchronize()
    assert torch.equal(rest[0], whole[0]) and torch.equal(rest[1], whole[1])
    assert torch.equal(torch.cat([first[2], rest[2]]), whole[2])
    ident = dev[7]
    scanned = chebyshev_scan(
        lambda th: ops.dekrr_step(*dev[:4], th, dev[6], ident, dev[8]),
        dev[4], dev[9], dev[10], p0=dev[5], record_deltas=True)
    torch.cuda.synchronize()
    assert torch.equal(scanned[0], whole[0])
    assert torch.equal(scanned[1], whole[1])
    assert torch.equal(scanned[3], whole[2].amax(dim=1))


FEATURE_SHAPES = [(200, 148, 8), (200, 148, 64), (200, 148, 512),
                  (37, 5, 13)]


def feature_case(d_feat, dim, n, seed):
    """Ω ~ N(0, 1), b ~ U[0, 2π), X ~ N(0, 1): |ΩX| reaches ~50 at
    d = 148, as on the paper's problems."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(d_feat, dim)), rng.uniform(0, 2 * np.pi, d_feat),
            rng.normal(size=(dim, n)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-9),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("d_feat,dim,n", FEATURE_SHAPES)
def test_gpu_rff_features_matches_plain(cuda_device, dtype, rtol, d_feat,
                                        dim, n):
    from repro_torch.kernels.rff_features import rff_features_reference

    args = [a.to(cuda_device, dtype) for a in to_t(
        feature_case(d_feat, dim, n, seed=n))]
    scale = float(np.sqrt(2.0 / d_feat))
    got = ops.rff_features(*args, scale=scale)
    want = rff_features_reference(*args, scale=scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (d_feat, n)
    assert_close(got, want.cpu(), rtol=rtol)
    assert ops.LAUNCHES["rff_features"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("d_feat,dim,n", FEATURE_SHAPES)
def test_gpu_rff_features_lowp_within_model_bound(cuda_device, d_feat, dim,
                                                  n):
    """bf16: every entry within s·((3u + γ_d)(|Ω||x| + |b|) + 3u) of the
    f64 value, and nearly all entries bit-equal to the plain version (the
    f32 sums run in another order)."""
    from repro_torch.kernels.rff_features import rff_features_lowp_reference

    omega, bias, x = feature_case(d_feat, dim, n, seed=n + 1)
    x32 = torch.as_tensor(x, dtype=torch.float32)
    scale = float(np.sqrt(2.0 / d_feat))
    dev = (torch.as_tensor(omega).to(cuda_device),
           torch.as_tensor(bias).to(cuda_device), x32.to(cuda_device))
    got = ops.rff_features_lowp(*dev, scale=scale)
    plain = rff_features_lowp_reference(*dev, scale=scale)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (d_feat, n)
    x64 = x32.double().numpy()
    exact = scale * np.cos(omega @ x64 + bias[:, None])
    u = 2.0 ** -8
    nu = min(dim * u, 0.5)
    bound = scale * ((3 * u + nu / (1 - nu))
                     * (np.abs(omega) @ np.abs(x64) + np.abs(bias)[:, None])
                     + 3 * u)
    assert (np.abs(got.cpu().numpy() - exact) <= bound).all()
    assert (got == plain).double().mean().item() >= 0.99
    assert ops.LAUNCHES["rff_features_lowp"] == 1
    assert ops.LAUNCHES["rff_features"] == 0


@pytest.mark.gpu
def test_gpu_pack_problem_packs_600_features(cuda_device):
    """pack_problem on the card with 600 features a node (the rff_gram
    kernel's wide route in f64) against the same pack with the torch
    Gram blocks."""
    from repro_torch.core import (DeKRRConfig, DeKRRSolver, circulant,
                                  sample_rff)
    from repro_torch.data.synthetic import (make_dataset, partition,
                                            train_test_split_nodes)
    from repro_torch.dist import pack_problem
    from repro_torch.kernels.rff_gram import WideGramPlan, gram_plan

    ds = make_dataset("wave", seed=0, subsample=2400)
    train, _ = train_test_split_nodes(
        partition(ds, 3, mode="noniid_y", seed=0, device=cuda_device),
        seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    fmaps = [sample_rff(gen, ds.dim, 600, 1.0) for _ in train]
    n = sum(nd.num_samples for nd in train)
    solver = DeKRRSolver(circulant(3, (1,)), fmaps, train,
                         DeKRRConfig(lam=0.1, c_nei=0.05 * n),
                         build_aux=False, device=cuda_device)
    assert isinstance(gram_plan(3, 600, ds.dim, n, item=8), WideGramPlan)
    got = pack_problem(solver, gram_backend="cuda", device=cuda_device)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rff_gram"] == 2     # own blocks, slot blocks
    want = pack_problem(solver, gram_backend="torch", device=cuda_device)
    for f in ("g", "d", "s", "p"):
        assert_close(getattr(got, f), getattr(want, f).cpu())


def feature_batch(d_feats, dim, n, seed):
    """Packed Ω [J, D_max, d] (NaN in the padded rows, which the kernel
    must not let through), b [J, D_max], X [d, N] as numpy, and the
    per-node scales."""
    rng = np.random.default_rng(seed)
    d_max = max(d_feats)
    omega = np.full((len(d_feats), d_max, dim), np.nan)
    bias = np.zeros((len(d_feats), d_max))
    for j, dj in enumerate(d_feats):
        omega[j, :dj] = rng.normal(size=(dj, dim))
        bias[j, :dj] = rng.uniform(0, 2 * np.pi, dj)
    scales = [float(np.sqrt(2.0 / dj)) for dj in d_feats]
    return omega, bias, rng.normal(size=(dim, n)), scales


# (D_j per node, d, N): the serving wave (10 nodes at the 512 bucket) and
# the ragged case in one launch
FEATURE_BATCHES = [((200,) * 10, 148, 512), ((37, 200, 64), 148, 13)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-9),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("d_feats,dim,n", FEATURE_BATCHES)
def test_gpu_rff_features_batched_matches_plain_and_per_node(
        cuda_device, dtype, rtol, d_feats, dim, n):
    """One launch for every node: against the batched plain version,
    padded rows exact zeros, and each node bit-equal to its own launch."""
    from repro_torch.kernels.rff_features import \
        rff_features_batched_reference

    omega, bias, x, scales = feature_batch(d_feats, dim, n, seed=n)
    omega, bias, x = (torch.as_tensor(a).to(cuda_device, dtype)
                      for a in (omega, bias, x))
    got = ops.rff_features_batched(omega, bias, x, scale=scales,
                                   d_feat=d_feats)
    want = rff_features_batched_reference(omega, bias, x, scale=scales,
                                          d_feat=d_feats)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rff_features"] == 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert_close(got, want.cpu(), rtol=rtol)
    for j, (dj, s) in enumerate(zip(d_feats, scales)):
        assert torch.equal(got[j, dj:], torch.zeros_like(got[j, dj:]))
        one = ops.rff_features(omega[j, :dj], bias[j, :dj], x, scale=s)
        assert torch.equal(got[j, :dj], one)
    assert ops.LAUNCHES["rff_features"] == 1 + len(d_feats)


@pytest.mark.gpu
@pytest.mark.parametrize("d_feats,dim,n", FEATURE_BATCHES)
def test_gpu_rff_features_lowp_batched_matches_plain_and_per_node(
        cuda_device, d_feats, dim, n):
    """bf16 in one launch for every node: within the model bound of the
    f64 value, nearly all entries bit-equal to the batched plain version,
    padded rows exact zeros, each node bit-equal to its own launch."""
    from repro_torch.kernels.rff_features import \
        rff_features_bf16_batched_reference

    omega, bias, x, scales = feature_batch(d_feats, dim, n, seed=n + 1)
    x32 = torch.as_tensor(x, dtype=torch.float32)
    dev = (torch.as_tensor(omega).to(cuda_device),
           torch.as_tensor(bias).to(cuda_device), x32.to(cuda_device))
    got = ops.rff_features_lowp_batched(*dev, scale=scales, d_feat=d_feats)
    bf16 = torch.bfloat16
    plain = rff_features_bf16_batched_reference(
        *(t.to(bf16) for t in dev), d_feat=d_feats).float()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rff_features_lowp"] == 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    x64 = x32.double().numpy()
    u = 2.0 ** -8
    nu = min(dim * u, 0.5)
    equal = 0
    for j, (dj, s) in enumerate(zip(d_feats, scales)):
        om, b = omega[j, :dj], bias[j, :dj]
        exact = s * np.cos(om @ x64 + b[:, None])
        bound = s * ((3 * u + nu / (1 - nu))
                     * (np.abs(om) @ np.abs(x64) + np.abs(b)[:, None])
                     + 3 * u)
        mine = got[j, :dj]
        assert (np.abs(mine.cpu().numpy() - exact) <= bound).all()
        equal += (mine == plain[j, :dj] * s).sum().item()
        assert torch.equal(got[j, dj:], torch.zeros_like(got[j, dj:]))
        one = ops.rff_features_lowp(dev[0][j, :dj], dev[1][j, :dj], dev[2],
                                    scale=s)
        assert torch.equal(mine, one)
    assert equal >= 0.99 * sum(d_feats) * n
    assert ops.LAUNCHES["rff_features_lowp"] == 1 + len(d_feats)
    assert ops.LAUNCHES["rff_features"] == 0


@pytest.mark.gpu
def test_gpu_serving_launches_the_kernel_and_refuses_tf32(cuda_device):
    """A CUDA snapshot's waves launch the featurize kernel once per wave
    for all cos_bias nodes (the cos_sin node takes featurize); the
    low-precision path refuses to stage while TF32 matmuls are
    allowed."""
    from repro_torch.core.rff import FeatureMap
    from repro_torch.serve import DeKRRServeEngine, KernelQuery
    from repro_torch.stream import ServeSnapshot, StalenessBound

    rng = np.random.default_rng(0)
    kinds = ("cos_bias", "cos_bias", "cos_sin")
    fmaps, thetas = [], []
    for kind in kinds:
        omega = torch.as_tensor(rng.normal(size=(16, 5)), device=cuda_device)
        bias = None if kind == "cos_sin" else torch.as_tensor(
            rng.uniform(0, 6, 16), device=cuda_device)
        fm = FeatureMap(omega=omega, bias=bias, kind=kind)
        fmaps.append(fm)
        thetas.append(torch.as_tensor(rng.normal(size=fm.num_features),
                                      device=cuda_device))
    snap = ServeSnapshot(tuple(fmaps), tuple(thetas),
                         StalenessBound(1, 0, 0, 0.0))
    queries = [KernelQuery(uid=i, x=rng.normal(size=5)) for i in range(6)]
    eng = DeKRRServeEngine(snap, batch_size=3, backend="cuda")
    got = [q.prediction for q in eng.run(queries)]
    plain = DeKRRServeEngine(snap, batch_size=3, backend="torch").run(
        [KernelQuery(uid=q.uid, x=q.x) for q in queries])
    assert_close(np.array(got), np.array([q.prediction for q in plain]))
    assert ops.LAUNCHES["rff_features"] == 2          # 2 waves, 1 launch each
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            DeKRRServeEngine(snap, precision="bf16").run(
                [KernelQuery(uid=0, x=np.zeros(5))])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


# (B, H, K, dh, S, cur): the cases of tests/test_kernels_decode.py, then
# qwen1.5-0.5b's heads at the serving cache length, smollm-135m's (GQA
# 3:1) and granite-3-8b's (GQA 4:1, dh 128)
DECODE_SHAPES = [
    (2, 8, 8, 64, 256, 200), (2, 8, 2, 64, 512, 512),
    (1, 16, 16, 128, 1024, 37), (4, 4, 1, 80, 300, 123),
    (3, 6, 3, 32, 96, 50),
    (8, 16, 16, 64, 512, 1), (8, 16, 16, 64, 512, 37),
    (8, 16, 16, 64, 512, 512),
    (8, 9, 3, 64, 512, 37), (8, 9, 3, 64, 512, 512),
    (8, 32, 8, 128, 512, 37), (8, 32, 8, 128, 512, 512),
]
# one long request at qwen1.5-0.5b's heads (chunks of 512 positions), cur
# of one position, on a chunk edge, one past it and the whole cache; GQA
# 8:1 (two head blocks) and 3:1 at dh 128 over several chunks
SPLIT_SHAPES = [(1, 16, 16, 64, 4096, cur) for cur in (1, 512, 513, 4096)] + [
    (2, 16, 2, 64, 1100, 1000), (1, 12, 4, 128, 700, 700)]
DECODE_TOL = 2e-5     # the reference kernel's tolerance (sum order)


def decode_case(b, h, kh, dh, s, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=torch.float32, device=device, generator=gen)
    return (torch.randn((b, 1, h, dh), **kw),
            torch.randn((b, s, kh, dh), **kw),
            torch.randn((b, s, kh, dh), **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kh,dh,s,cur", DECODE_SHAPES + SPLIT_SHAPES)
def test_gpu_flash_decode_matches_plain(cuda_device, b, h, kh, dh, s, cur):
    """The kernel against its split plain version (the same chunks,
    combined in chunk order) and the one-pass plain version."""
    from repro_torch.kernels.decode_attention import (
        flash_decode_reference, flash_decode_split_reference)

    q, k, v = decode_case(b, h, kh, dh, s, s + cur, cuda_device)
    got = ops.flash_decode(q, k, v, cur)
    lens = torch.full((b * kh,), cur, dtype=torch.int32, device=cuda_device)
    split = flash_decode_split_reference(q, k, v, lens)
    want = flash_decode_reference(q, k, v, lens)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, split, rtol=DECODE_TOL, atol=DECODE_TOL)
    torch.testing.assert_close(got, want, rtol=DECODE_TOL, atol=DECODE_TOL)
    assert ops.LAUNCHES["flash_decode"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kh,dh,s,cur", [DECODE_SHAPES[7]] + SPLIT_SHAPES)
def test_gpu_flash_decode_gives_the_same_bits_every_call(cuda_device, b, h,
                                                         kh, dh, s, cur):
    """The chunks' partials are merged in chunk order whichever block
    merges them, so two calls give the same bits."""
    q, k, v = decode_case(b, h, kh, dh, s, 11, cuda_device)
    first = ops.flash_decode(q, k, v, cur)
    assert torch.equal(ops.flash_decode(q, k, v, cur), first)


@pytest.mark.gpu
@pytest.mark.parametrize("cur", [513, 4096])
def test_gpu_flash_decode_graph_replay_equals_eager(cuda_device, cur):
    """ops.flash_decode captured in a CUDA graph and replayed three times
    gives the eager call's bits every time: each launch leaves its row
    counters at 0 for the next."""
    q, k, v = decode_case(1, 16, 16, 64, 4096, 13, cuda_device)
    eager = ops.flash_decode(q, k, v, cur)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.flash_decode(q, k, v, cur)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ops.flash_decode(q, k, v, cur)
    for _ in range(3):
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)
    assert torch.equal(ops.flash_decode(q, k, v, cur), eager)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kh,dh,s,cur", [DECODE_SHAPES[i]
                                             for i in (0, 3, 6, 11)])
def test_gpu_flash_decode_ignores_stale_tail(cuda_device, b, h, kh, dh, s,
                                             cur):
    """±999 beyond cur_index changes no bit of the output, and a strided
    view of a larger cache (the model's per-layer slice) gives the same
    bits as the contiguous cache."""
    q, k, v = decode_case(b, h, kh, dh, s, 7, cuda_device)
    out = ops.flash_decode(q, k, v, cur)
    k2, v2 = k.clone(), v.clone()
    k2[:, cur:] = 999.0
    v2[:, cur:] = -999.0
    assert torch.equal(ops.flash_decode(q, k2, v2, cur), out)
    big = torch.zeros((2, b, s + 8, kh, dh), device=cuda_device)
    big[1, :, :s] = k
    bigv = torch.zeros_like(big)
    bigv[1, :, :s] = v
    assert torch.equal(ops.flash_decode(q, big[1, :, :cur + 4],
                                        bigv[1, :, :cur + 4], cur), out)


@pytest.mark.gpu
def test_gpu_flash_decode_refuses_what_the_kernel_does_not_take(
        cuda_device):
    q, k, v = decode_case(1, 4, 2, 32, 16, 0, cuda_device)
    with pytest.raises(ValueError, match="head and dh axes"):
        ops.flash_decode(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                         v, 8)
    q6, k6, v6 = decode_case(1, 4, 2, 6, 16, 0, cuda_device)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.flash_decode(q6, k6, v6, 8)
    with pytest.raises(TypeError):
        ops.flash_decode(q.half(), k.half(), v.half(), 8)
    assert ops.LAUNCHES["flash_decode"] == 0


# bf16: the kernel's f32 sums rounded once to bf16, against the plain
# versions' f32 sums rounded once: one bf16 ulp of the output (2^-7) plus
# the f32 tolerance
BF16_ULP = 2.0 ** -7


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kh,dh,s,cur", [
    c for c in DECODE_SHAPES + SPLIT_SHAPES if c[3] % 8 == 0] + [
    (8, 16, 16, 64, 32768, 32768), (1, 16, 16, 64, 32768, 32768),
    (1, 16, 16, 64, 4096, 1025)])
def test_gpu_flash_decode_bf16_matches_plain(cuda_device, b, h, kh, dh, s,
                                             cur):
    """The bf16 entry (bf16 K/V staged as they are, f32 arithmetic)
    against its split and one-pass plain versions, two calls giving the
    same bits."""
    from repro_torch.kernels.decode_attention import (
        flash_decode_reference, flash_decode_split_reference)

    q, k, v = (t.bfloat16() for t in decode_case(b, h, kh, dh, s, s + cur,
                                                 cuda_device))
    got = ops.flash_decode(q, k, v, cur)
    lens = torch.full((b * kh,), cur, dtype=torch.int32, device=cuda_device)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    for plain in (flash_decode_split_reference, flash_decode_reference):
        want = plain(q, k, v, lens).float()
        err = (got.float() - want).abs()
        bound = BF16_ULP * want.abs() + DECODE_TOL * (1 + want.abs())
        assert bool((err <= bound).all()), (plain.__name__, err.max())
    assert torch.equal(ops.flash_decode(q, k, v, cur), got)
    assert ops.LAUNCHES["flash_decode"] == 2


@pytest.mark.gpu
def test_gpu_flash_decode_bf16_refuses_what_it_cannot_copy(cuda_device):
    """16-byte copies are 8 bf16 values: dh and the caches' batch and
    position strides must be multiples of 8, and nothing is cast."""
    q, k, v = (t.bfloat16() for t in decode_case(1, 4, 2, 36, 16, 0,
                                                 cuda_device))
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_decode(q, k, v, 8)
    q, k, v = (t.bfloat16() for t in decode_case(1, 4, 2, 32, 16, 0,
                                                 cuda_device))
    big = torch.zeros((1, 17, 2, 32), dtype=torch.bfloat16,
                      device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.flash_decode(q, big.view(-1)[4:4 + 16 * 64].view(1, 16, 2, 32),
                         v, 8)
    with pytest.raises(TypeError, match="share one dtype"):
        ops.flash_decode(q, k.float(), v, 8)
    assert ops.LAUNCHES["flash_decode"] == 0


@pytest.mark.gpu
def test_gpu_decode_step_launches_flash_decode_per_layer(cuda_device):
    """A reduced model's decode step on the card launches the kernel once
    per layer, and its logits agree with the plain attention's."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model, init_params

    cfg = get_arch("smollm_135m").config.reduced()
    model = Model(cfg, init_params(
        cfg, torch.Generator(cuda_device).manual_seed(0)))
    toks = torch.randint(0, cfg.vocab_size, (3, 6), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    caches = {b: model.init_cache(3, 16) for b in ("cuda", "torch")}
    for t in range(6):
        out = {}
        for b in caches:
            out[b], caches[b] = model.decode_step(caches[b], toks[:, t:t + 1],
                                                  t, backend=b)
        torch.testing.assert_close(out["cuda"], out["torch"], rtol=1e-4,
                                   atol=1e-4 * out["torch"].abs().max())
    assert ops.LAUNCHES["flash_decode"] == 6 * cfg.num_layers


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6_7b", "deepseek_moe_16b",
                                  "jamba_1_5_large_398b", "qwen1_5_0_5b-swa"])
def test_gpu_mixer_decode_step_captures_into_a_graph(cuda_device, arch):
    """The reduced MoE, Mamba, RWKV-6 and sliding-window models on the
    card: backend cuda == backend torch at 1e-4, one flash_decode launch
    per attn layer a step, and a step captures into a CUDA graph (no host
    sync or host copy on the path) whose replay gives the eager bits."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model, SlotSpec, init_params

    base, _, variant = arch.partition("-")
    cfg = get_arch(base).config.reduced()
    if variant:
        cfg = dataclasses.replace(cfg, slots=(SlotSpec("swa", "dense"),),
                                  sliding_window=8)
    model = Model(cfg, init_params(
        cfg, torch.Generator(cuda_device).manual_seed(0)))
    toks = torch.randint(0, cfg.vocab_size, (4, 12), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    caches = {b: model.init_cache(4, 16) for b in ("cuda", "torch")}
    with torch.inference_mode():
        for t in range(12):
            out = {}
            for b in caches:
                out[b], caches[b] = model.decode_step(
                    caches[b], toks[:, t:t + 1], t, backend=b)
            torch.testing.assert_close(out["cuda"], out["torch"], rtol=1e-4,
                                       atol=1e-4 * out["torch"].abs().max())
        attn = cfg.num_groups * sum(s.mixer == "attn" for s in cfg.slots)
        assert ops.LAUNCHES["flash_decode"] == 12 * attn
        cache = model.init_cache(4, 16)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model.decode_step(cache, toks[:, :1], 0)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed, _ = model.decode_step(cache, toks[:, 1:2], 9)
        before = {s: {n: t.clone() for n, t in c.items()}
                  for s, c in cache.items()}
        eager, _ = model.decode_step(cache, toks[:, 1:2], 9)
        after = {s: {n: t.clone() for n, t in c.items()}
                 for s, c in cache.items()}
        for s, c in cache.items():            # the recurrent states advanced
            for n, t in c.items():
                t.copy_(before[s][n])
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(replayed, eager)
    for s, c in cache.items():
        for n, t in c.items():
            assert torch.equal(t, after[s][n]), (s, n)


# ------------------------------------------------------ the paper's slice
# gram_fn_for_solver at the paper's shapes (F, d, N): Table 2's D̄ on
# houses, twitter and wave at full N (N_j training columns), and F 100
GRAM_FN_SHAPES = [(70, 8, 1032), (130, 77, 4935), (200, 148, 3180),
                  (100, 27, 987)]


@pytest.mark.gpu
@pytest.mark.parametrize("f,dim,n", GRAM_FN_SHAPES)
def test_gpu_gram_fn_for_solver_matches_plain(cuda_device, f, dim, n):
    from repro_torch.kernels.ref import rff_gram_ref
    rng = np.random.default_rng(f + n)
    omega = rng.normal(size=(f, dim))
    bias = rng.uniform(0, 2 * np.pi, f)
    x = rng.uniform(size=(dim, n))
    fm = interop.feature_map_from_arrays(omega, bias, "cos_bias",
                                         device=cuda_device)
    got = ops.gram_fn_for_solver(fm, torch.as_tensor(x, device=cuda_device))
    assert ops.launch_counts()["rff_gram"] == 1
    assert got.dtype == torch.float64
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                    device=cuda_device)
    want, _ = rff_gram_ref(f32(omega), f32(bias), f32(x),
                           torch.zeros(n, dtype=torch.float32,
                                       device=cuda_device),
                           scale=float(np.sqrt(2.0 / f)))
    assert_close(got.float(), want, rtol=1e-4)


def _paper_split(name, subsample, device):
    from repro_torch.paper import common as C
    return C.load_split(name, subsample=subsample, device=device)


@pytest.mark.gpu
def test_gpu_dkla_matches_the_cpu(cuda_device):
    from repro_torch.core import DKLA, DKLAConfig, circulant, sample_rff
    ds, train_c, test_c = _paper_split("houses", 4000, "cpu")
    _, train_g, _ = _paper_split("houses", 4000, cuda_device)
    fm = sample_rff(torch.Generator().manual_seed(3), ds.dim, 70, 1.0)
    cfg = DKLAConfig(num_iters=250)
    cpu = DKLA(circulant(10, (1, 2)), fm, train_c, cfg, device="cpu")
    gpu = DKLA(circulant(10, (1, 2)), fm, train_g, cfg, device=cuda_device)
    th_c, th_g = cpu.solve(), gpu.solve()
    for a, b in zip(th_g, th_c):
        assert_close(a, b)
    x = test_c[2].x
    for node in (None, 4):
        assert_close(gpu.predict(th_g, x.to(cuda_device), node=node),
                     cpu.predict(th_c, x, node=node))


@pytest.mark.gpu
def test_gpu_centralized_krr_matches_the_cpu(cuda_device):
    """rtol 1e-9 beside an atol of 1e-11·max|f|: K + λN I is conditioned
    near 1e6 at this size, so a prediction near zero carries the
    summation order's error absolutely."""
    from repro_torch.core import CentralizedKRR
    from repro_torch.data.synthetic import pooled
    _, train, test = _paper_split("houses", 3000, "cpu")
    tr, te = pooled(train), pooled(test)
    cpu = CentralizedKRR(1.0, 1e-6).fit(tr.x, tr.y).predict(te.x)
    gpu = CentralizedKRR(1.0, 1e-6).fit(
        tr.x.to(cuda_device), tr.y.to(cuda_device)).predict(te.x)
    want = cpu.numpy()
    np.testing.assert_allclose(gpu.cpu().numpy(), want, rtol=1e-9,
                               atol=1e-11 * np.abs(want).max())


@pytest.mark.gpu
def test_gpu_run_dekrr_ddrf_matches_the_cpu(cuda_device):
    from repro_torch.core import sample_rff
    from repro_torch.paper import common as C
    dbar = 70
    ds, tr_c, te_c = _paper_split("houses", 6000, "cpu")
    _, tr_g, te_g = _paper_split("houses", 6000, cuda_device)
    gen = torch.Generator().manual_seed(0)
    pools = [sample_rff(gen, ds.dim, 20 * dbar, C.SIGMA) for _ in range(C.J)]
    cpu = C.run_dekrr_ddrf(ds, tr_c, te_c, dbar, candidates=pools)
    gpu = C.run_dekrr_ddrf(ds, tr_g, te_g, dbar, candidates=pools)
    np.testing.assert_allclose(gpu.rse, cpu.rse, rtol=1e-9)
    assert gpu.c == cpu.c


# ------------------------------------------------------------- streaming
def _stream_pair(device, *, backend="cuda_fused"):
    """The stream bench's runtime (air_quality, J = 10, 600 samples) on
    `device`, from maps drawn once on the CPU."""
    from repro_torch.bench import stream_bench as SB
    from repro_torch.core import select_features
    from repro_torch.paper import common as C
    ds, train, _ = C.load_split("air_quality", subsample=600, device="cpu")
    gen = torch.Generator().manual_seed(0)
    fmaps = [select_features(gen, ds.dim, 12 + 4 * (j % 3), C.SIGMA,
                             nd.x, nd.y, candidate_ratio=5)
             for j, nd in enumerate(train)]
    return SB.stream_runtime(C.TOPOLOGY, [f.to(device) for f in fmaps],
                             [nd.to(device) for nd in train],
                             backend=backend, device=device), ds


def _stream_steps(rt, dim, seed=5):
    rng = np.random.default_rng(seed)
    for node, b in ((0, 8), (3, 32), (7, 5), (0, 128)):
        rt.ingest(node, rng.normal(size=(dim, b)), rng.normal(size=b))


@pytest.mark.gpu
def test_gpu_stream_ingest_matches_the_cpu(cuda_device):
    """One ingest sequence, a refresh and a warm solve on the card equal
    the same on the CPU (rtol 1e-9; the CPU runs the plain versions)."""
    from repro_torch.core import sample_rff
    cpu, ds = _stream_pair("cpu")
    gpu, _ = _stream_pair(cuda_device)
    for rt in (cpu, gpu):
        _stream_steps(rt, ds.dim)
    for f in ("binv", "zy", "st", "pt"):
        assert_close(getattr(gpu.aux, f), getattr(cpu.aux, f))
    pool = sample_rff(torch.Generator().manual_seed(1), ds.dim, 140, 1.0)
    for rt in (cpu, gpu):
        rt.refresh(2, num_features=14, candidates=pool)
    for f in ("binv", "zy", "st", "pt"):
        assert_close(getattr(gpu.aux, f), getattr(cpu.aux, f))
    for rt in (cpu, gpu):
        rt.solve()
    assert_close(gpu.theta, cpu.theta)
    assert ops.LAUNCHES["dekrr_solve"] > 0 and ops.LAUNCHES["rff_gram"] > 0


@pytest.mark.gpu
def test_gpu_stream_warm_solve_fused_equals_per_round(cuda_device):
    """The stream's warm solve on cuda_fused equals the per-round cuda
    backend bit for bit from the same θ0, same tol checks."""
    from repro_torch.dist import solve_batched
    rt, ds = _stream_pair(cuda_device)
    rt.solve()
    _stream_steps(rt, ds.dim, seed=6)
    theta0, cfg = rt.theta, rt.config
    want, rounds = solve_batched(rt.packed, cfg.rounds_per_epoch, theta0,
                                 backend="cuda", tol=cfg.tol,
                                 chunk_rounds=cfg.chunk_rounds,
                                 return_rounds=True)
    rep = rt.solve()
    torch.cuda.synchronize()
    assert rep.rounds_run == rounds
    assert torch.equal(rt.theta, want)


@pytest.mark.gpu
def test_gpu_stream_bench_runs(cuda_device):
    from repro_torch.bench import stream_bench
    res = stream_bench.run(fast=True, device=cuda_device)
    assert res["device"] == torch.cuda.get_device_name(cuda_device)
    assert res["warm_rounds_mean"] < res["cold_rounds_mean"]
    assert res["serve"]["qps"] > 0


# --------------------------------------------------------------------------
# Dispatch counts and the shared-memory budget on the card
# --------------------------------------------------------------------------
def _run_kind(kind, packed, backend, rounds, gen):
    from repro_torch.core import AsyncGossipConfig, activation_masks
    from repro_torch.core.acceleration import chebyshev_solve_packed
    from repro_torch.dist import async_solve_batched, solve_batched
    if kind == "sync":
        return solve_batched(packed, rounds, backend=backend,
                             return_trace=True)
    if kind == "async":
        masks = activation_masks(gen, rounds, packed.num_nodes, prob=0.5)
        return async_solve_batched(
            packed, rounds, masks, backend=backend, return_stats=True,
            config=AsyncGossipConfig(prob=0.5, censor_tau=2e-2,
                                     censor_decay=0.9))
    return chebyshev_solve_packed(packed, 0.9, 0.0, num_iters=rounds,
                                  backend=backend, return_trace=True)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_fused"])
@pytest.mark.parametrize("kind", ["sync", "async", "chebyshev"])
def test_gpu_dispatch_count_equals_launches(cuda_device, kind, backend):
    """On the card each dispatch is one launch: `dispatch_count` equals
    the `LAUNCHES` delta and the contract."""
    from repro_torch.analysis.dispatch import synthetic_packed
    from repro_torch.obs import dispatch_count, round_dispatches
    packed = synthetic_packed(j_nodes=10, d_feat=40, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rounds = 9
    before = sum(ops.launch_counts().values())
    count, exact = dispatch_count(_run_kind, kind, packed, backend, rounds,
                                  gen)
    torch.cuda.synchronize()
    launched = sum(ops.launch_counts().values()) - before
    assert exact and count == launched == round_dispatches(backend, rounds)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,shape", PATH_SHAPES,
                         ids=lambda v: v if isinstance(v, str) else "-".join(
                             f"{k}{x}" for k, x in v.items()))
def test_gpu_smem_estimate_equals_launcher_bytes(cuda_device, kernel, shape):
    """Each kernel's budget estimate at the paths' shapes equals the bytes
    its csrc launcher takes (read from the library's C export)."""
    from repro_torch.analysis import smem
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    kw = dict(shape, sms=sms) if kernel in ("rff_gram", "rff_features",
                                            "serve_wave") else shape
    est = getattr(smem, f"estimate_{kernel}")(**kw)
    assert est.fits
    assert smem.launcher_bytes(kernel, shape, sms=sms) == est.bytes


@pytest.mark.gpu
def test_gpu_over_budget_round_refused_without_launch(cuda_device):
    """K 4, Dy 8, D 640 in f64 needs 245,760 B a block: refused before any
    launch, with no CUDA error left behind."""
    from repro_torch.analysis import SmemBudgetError
    j, k, d, dy = 2, 4, 640, 8
    z = lambda *s: torch.zeros(s, dtype=torch.float64, device=cuda_device)
    nbr = torch.tensor([[1] * k, [0] * k], dtype=torch.int32,
                       device=cuda_device)
    own = torch.arange(j, dtype=torch.int32, device=cuda_device)
    mask = torch.ones((j, k), dtype=torch.int32, device=cuda_device)
    with pytest.raises(SmemBudgetError, match="245760"):
        ops.dekrr_step(z(j, d, d), z(j, d, dy), z(j, d, d), z(j, k, d, d),
                       z(j, d, dy), nbr, own, mask)
    with pytest.raises(SmemBudgetError, match="245760"):
        ops.dekrr_solve(z(j, d, d), z(j, d, dy), z(j, d, d), z(j, k, d, d),
                        z(j, d, dy), nbr, own, mask, num_rounds=3)
    torch.cuda.synchronize()
    assert sum(ops.launch_counts().values()) == 0


# ---------------------------------------------------------------- the SPMD
# solvers: one node per rank, all ranks on the one card, exchanging θ over
# gloo through host buffers (NCCL refuses two ranks on one device).
def _spmd_cases(rounds, masks):
    from repro_torch.core import AsyncGossipConfig

    config = AsyncGossipConfig(prob=0.5, censor_tau=2e-2, censor_decay=0.9)
    cases = []
    for mode in ("ppermute", "allgather"):
        cases.append(dict(solver="sync", mode=mode, backend="cuda",
                          num_iters=rounds))
        cases.append(dict(solver="async", mode=mode, backend="cuda",
                          num_iters=rounds,
                          kw=dict(masks=masks, config=config)))
    return cases, config


@pytest.mark.gpu
def test_gpu_spmd_four_ranks_equal_batched_cuda(cuda_device):
    """Sync and async SPMD `cuda` on 4 ranks == the batched `cuda` solves
    bit for bit: the round kernel's node body does not depend on J."""
    from repro_torch.analysis.dispatch import synthetic_packed
    from repro_torch.core import activation_masks
    from repro_torch.dist import async_solve_batched, solve_batched
    from repro_torch.dist.ranks import run_ranks
    from repro_torch.dist.spmd_cases import solve_cases

    rounds = 30
    packed = synthetic_packed(j_nodes=4, d_feat=64)
    masks = activation_masks(torch.Generator().manual_seed(1), rounds, 4,
                             prob=0.5)
    cases, config = _spmd_cases(rounds, masks)
    per_rank = run_ranks(solve_cases, 4, backend="gloo",
                         device=str(cuda_device) + ":0", timeout=300.0,
                         args=(packed, cases, None))
    on_card = synthetic_packed(j_nodes=4, d_feat=64, device="cuda")
    want = solve_batched(on_card, rounds, backend="cuda").cpu()
    want_a = async_solve_batched(on_card, rounds, masks, config=config,
                                 backend="cuda").cpu()
    for rank in per_rank:
        for case, res in zip(cases, rank):
            ref = want if case["solver"] == "sync" else want_a
            assert torch.equal(res["out"], ref), case
            kernel = "dekrr_step" if case["solver"] == "sync" \
                else "dekrr_step_masked"
            assert res["launches"][kernel] == res["dispatches"] == rounds


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_gpu_dekrr_step_one_node_table_matches_plain(cuda_device, masked):
    """The SPMD shape: J = 1 over a [1 + K, D] table (K 4, D 200, f64)."""
    args = [a.to(cuda_device) for a in to_t(
        dekrr_case(1, 4, 200, 1, 4, seed=23, masked=False))]
    args[5] = torch.arange(1, 5, dtype=torch.int32,
                           device=cuda_device)[None]
    args[6] = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    active = torch.ones((1,), dtype=torch.int32, device=cuda_device) \
        if masked else None
    lay = ops._pad_dekrr_operands("t", *args)[2]
    want = dekrr_step_masked_reference(*lay, active, dy=1) if masked \
        else dekrr_step_reference(*lay, dy=1)
    got = ops.dekrr_step(*args, active)
    torch.cuda.synchronize()
    assert_close(got, want.cpu())
    assert ops.LAUNCHES["dekrr_step_masked" if masked else "dekrr_step"] == 1


@pytest.mark.gpu
def test_gpu_ten_ranks_first_use_builds_each_library_once(
        cuda_device, tmp_path, monkeypatch):
    """Ten ranks reach the round kernel at once with an empty build
    directory: nvcc runs once for it and every rank loads the library."""
    import os
    import shutil
    import stat

    from repro_torch.analysis.dispatch import synthetic_packed
    from repro_torch.dist.ranks import run_ranks
    from repro_torch.dist.spmd_cases import solve_cases

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    log = tmp_path / "nvcc.log"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    wrapper = bindir / "nvcc"
    wrapper.write_text(f'#!/bin/sh\necho "$@" >> {log}\nexec {nvcc} "$@"\n')
    wrapper.chmod(wrapper.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("REPRO_TORCH_BUILD_ROOT", str(tmp_path / "build"))
    packed = synthetic_packed(j_nodes=10, d_feat=16)
    packed.offsets = None                      # allgather over any layout
    case = dict(solver="sync", mode="allgather", backend="cuda",
                num_iters=3)
    per_rank = run_ranks(solve_cases, 10, backend="gloo",
                         device=str(cuda_device) + ":0", timeout=600.0,
                         args=(packed, [case], None))
    calls = log.read_text().splitlines()
    assert len(calls) == 1 and calls[0].endswith("dekrr_step.cu")
    libs = list((tmp_path / "build").glob("*/dekrr_step.so"))
    assert len(libs) == 1
    assert list((tmp_path / "build").glob("*/*.tmp")) == []
    for rank in per_rank:
        assert rank[0]["launches"]["dekrr_step"] == 3
        assert torch.equal(rank[0]["out"], per_rank[0][0]["out"])


# ------------------------------------------------------------- training
TRAIN_ARCHS = ["qwen1_5_0_5b", "deepseek_moe_16b"]


def _train_case(arch, device):
    """A reduced model's seeded weights (drawn on the CPU), a seeded
    batch and AdamW, on `device`."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import init_params
    from repro_torch.train.optim import AdamWConfig, tree_map

    cfg = get_arch(arch).config.reduced()
    weights = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 48)),
                                device=device)
             for k in ("tokens", "targets")}
    params = tree_map(lambda t: t.to(device, copy=True), weights)
    return cfg, params, batch, AdamWConfig(total_steps=10, warmup_steps=2)


def _tree_items(tree, prefix=""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _tree_items(tree[key], f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", tree[key]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_gpu_train_step_matches_the_cpu(cuda_device, arch):
    """One reduced train step on the card against the same step on the
    CPU, at tests/test_torch_train.py's tolerances: loss rtol 1e-6, each
    gradient leaf within 1e-4 of its max|g|, grad_norm rtol 1e-5, and
    the parameters within AdamW's first-step bound 2·lr (all but 0.1%
    within 1e-6)."""
    from repro_torch.models.model import Model
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.step import (TrainState, loss_and_grads,
                                        make_train_step)

    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        cfg, params, batch, opt = _train_case(arch, dev)
        loss, metrics, grads = loss_and_grads(Model(cfg, params), params,
                                              batch)
        state = TrainState(params, adamw_init(opt, params),
                           torch.zeros((), dtype=torch.int32, device=dev))
        state, m = make_train_step(cfg, opt)(state, batch)
        runs[dev.type] = dict(loss=loss.cpu(), metrics=metrics, m=m,
                              grads=dict(_tree_items(grads)),
                              params=dict(_tree_items(state.params)))
    got, want = runs["cuda"], runs["cpu"]
    assert_close(got["loss"], want["loss"], rtol=1e-6)
    assert_close(got["m"]["grad_norm"], want["m"]["grad_norm"], rtol=1e-5)
    assert set(got["metrics"]) == set(want["metrics"])
    for p, w in want["grads"].items():
        g = got["grads"][p].cpu()
        assert (g - w).abs().max() <= 1e-4 * w.abs().max(), p
    bound = 2 * float(want["m"]["lr"]) * (1 + 1e-3)
    tight = total = 0
    for p, w in want["params"].items():
        err = (got["params"][p].cpu() - w).abs()
        assert err.max() <= bound, p
        tight += int((err <= 1e-6).sum())
        total += err.numel()
    assert tight >= 0.999 * total


@pytest.mark.gpu
def test_gpu_train_checkpoint_round_trips_on_the_card(cuda_device, tmp_path):
    """A train state on the card (bf16 moments after one step) saved and
    loaded back on the card and on the CPU: every tensor bit-equal."""
    from repro_torch.models.model import Model
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import TrainState, make_train_step

    cfg, params, batch, _ = _train_case("deepseek_moe_16b", cuda_device)
    opt = AdamWConfig(total_steps=10, warmup_steps=2,
                      moment_dtype="bfloat16")
    state = TrainState(params, adamw_init(opt, params),
                       torch.zeros((), dtype=torch.int32,
                                   device=cuda_device))
    state, _ = make_train_step(cfg, opt)(state, batch)
    tree = {"params": state.params, "opt": state.opt}
    path = save_checkpoint(str(tmp_path / "ck"), tree, step=1)
    want = dict(_tree_items(tree))
    for dev in (cuda_device, torch.device("cpu")):
        got, step = load_checkpoint(path, device=dev)
        assert step == 1
        got = dict(_tree_items(got))
        assert set(got) == set(want)
        for p, w in want.items():
            assert got[p].device.type == dev.type and got[p].dtype == w.dtype
            assert torch.equal(got[p].cpu(), w.cpu()), p
    assert Model(cfg, state.params).device.type == "cuda"


@pytest.mark.gpu
def test_gpu_train_steps_repeat_bit_for_bit_in_deterministic_mode(
        cuda_device):
    """Under torch.use_deterministic_algorithms(True) (in a fresh
    process: cuBLAS's workspace setting must precede its first call), two
    train steps from the same state give the same loss and parameters,
    bit for bit, on the dense and the MoE model."""
    import os
    import subprocess
    import sys

    code = """
import torch
from repro_torch.configs import get_arch
from repro_torch.models.model import init_params
from repro_torch.train.optim import AdamWConfig, adamw_init, tree_leaves, tree_map
from repro_torch.train.step import TrainState, make_train_step
torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
for arch in ("qwen1_5_0_5b", "deepseek_moe_16b"):
    cfg = get_arch(arch).config.reduced()
    w = init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator("cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 48), device="cuda",
                              generator=g) for k in ("tokens", "targets")}
    opt = AdamWConfig(total_steps=10, warmup_steps=2)
    out = []
    for _ in range(2):
        p = tree_map(lambda t: t.to("cuda", copy=True), w)
        s = TrainState(p, adamw_init(opt, p),
                       torch.zeros((), dtype=torch.int32, device="cuda"))
        for _ in range(2):
            s, m = make_train_step(cfg, opt)(s, batch)
        out.append((m["loss"], tree_leaves(s.params)))
    assert torch.equal(out[0][0], out[1][0]), arch
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1])), arch
print("deterministic: ok")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "deterministic: ok" in out.stdout


# --------------------------------------------------------------------------
# The accel and kernel benches and the examples on the card
# --------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("case", [(100, 8, 10000), (200, 148, 30000),
                                  (512, 96, 30000)],
                         ids=lambda c: "D{}_d{}_N{}".format(*c))
def test_gpu_kernel_bench_case_matches_plain(cuda_device, case):
    """`ops.rff_gram` at each `kernel_bench.CASES` shape (f32, B 1): one
    launch a call, within rtol 1e-4 of its plain version, and two calls
    give the same bits."""
    import math

    from repro_torch.bench import kernel_bench
    from repro_torch.kernels.ref import rff_gram_ref
    assert case in kernel_bench.CASES
    om, bi, x, y = kernel_bench.operands(*case, cuda_device)
    scale = math.sqrt(2.0 / case[0])
    first = ops.rff_gram(om, bi, x, y, scale=scale)
    assert ops.launch_counts()["rff_gram"] == 1
    second = ops.rff_gram(om, bi, x, y, scale=scale)
    assert ops.launch_counts()["rff_gram"] == 2
    want = rff_gram_ref(om, bi, x, y, scale=scale)
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, b)
        assert_close(a, w, rtol=1e-4)


@pytest.mark.gpu
def test_gpu_accel_dispatch_counts_equal_launches(cuda_device):
    from repro_torch.bench import accel_bench
    got = accel_bench.dispatch_counts(10, cuda_device)
    torch.cuda.synchronize()
    assert got == {"torch": dict.fromkeys(got["torch"], 0),
                   "cuda": dict.fromkeys(got["cuda"], 10),
                   "cuda_fused": dict.fromkeys(got["cuda_fused"], 1)}
    launched = ops.launch_counts()
    assert launched["dekrr_cheb_solve"] == launched["dekrr_async_solve"] == 1
    assert launched["dekrr_step"] + launched["dekrr_step_masked"] == 20


@pytest.mark.gpu
def test_gpu_quickstart_matches_the_cpu(cuda_device):
    """The quickstart's four numbers on the card equal the CPU's at rtol
    1e-9 from one set of CPU draws."""
    from repro_torch.examples import quickstart
    fmaps, dkla_fmap = quickstart.draw_maps("cpu")
    want = quickstart.run("cpu", fmaps=fmaps, dkla_fmap=dkla_fmap)
    got = quickstart.run(cuda_device, fmaps=fmaps, dkla_fmap=dkla_fmap)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-9, err_msg=key)


@pytest.mark.gpu
def test_gpu_readout_features_match_the_cpu(cuda_device, monkeypatch):
    """The readout's pooled features on the card within 1e-5·max| | of
    the CPU's (f32 backbone, TF32 off), from the same weights and
    tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.examples import decentralized_readout as DR
    from repro_torch.models.model import Model, init_params
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_arch("smollm_135m").config.reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (128, 32),
                           generator=torch.Generator().manual_seed(1))
    want = DR.pooled_features(Model(cfg, params), tokens)
    card = {k: ({n: t.to(cuda_device) for n, t in v.items()}
                if isinstance(v, dict) else v.to(cuda_device))
            for k, v in params.items()}
    got = DR.pooled_features(Model(cfg, card), tokens.to(cuda_device))
    assert_close(got.cpu(), want, rtol=1e-5)
