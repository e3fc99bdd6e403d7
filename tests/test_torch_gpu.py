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

from repro_torch.kernels import ops
from repro_torch.kernels.dekrr_solve import dekrr_solve_reference
from repro_torch.kernels.dekrr_step import dekrr_step_reference
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-9),
                                        (torch.float32, 1e-4)])
def test_gpu_rff_gram_matches_plain(cuda_device, dtype, rtol):
    rng = np.random.default_rng(1)
    b, f, dim, n = 3, 70, 13, 300        # ragged 64-wide tiles
    arrays = (rng.normal(size=(b, f, dim)), rng.uniform(0, 6, (b, f)),
              rng.uniform(size=(b, dim, n)), rng.normal(size=(b, n)),
              (np.arange(n) < n - 9).astype(float)[None].repeat(b, 0))
    args = [a.to(cuda_device, dtype) for a in to_t(arrays)]
    got = ops.rff_gram_batched(*args)
    want = rff_gram_batched_reference(*args)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert_close(a, w.cpu(), rtol=rtol)
    assert ops.LAUNCHES["rff_gram"] == 1
