"""The three kernels' plain versions and the port's wrappers, held against
the JAX package's wrappers (Pallas interpret mode) and references on the
same numpy inputs, float64, rtol 1e-9 and atol 1e-12·max|ref|.

On CPU tensors the wrappers must reach the plain versions and launch
nothing. The kernels themselves are compared with their plain versions
on the card by `tests/test_torch_gpu.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels.dekrr_solve import \
    dekrr_solve_reference as ref_solve_reference
from repro.kernels.dekrr_step import dekrr_step_reference as ref_step_reference
from repro.kernels.ref import rff_gram_ref as ref_rff_gram_ref
from repro_torch.kernels import ops
from repro_torch.kernels.dekrr_solve import dekrr_solve_reference
from repro_torch.kernels.dekrr_step import dekrr_step_reference
from repro_torch.kernels.ref import rff_gram_ref
from repro_torch.kernels.rff_gram import rff_gram_batched_reference
from test_torch_gpu import CASES, assert_close, dekrr_case, to_t


def to_j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)




@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.LAUNCHES}, \
        "a wrapper counted a launch for a CPU tensor"


# ------------------------------------------------------------- dekrr_step
@pytest.mark.parametrize("j,k,dfeat,dy,extra", CASES)
def test_dekrr_step_matches_reference(j, k, dfeat, dy, extra):
    args = dekrr_case(j, k, dfeat, dy, extra, seed=j * 10 + k + dy)
    want = rops.dekrr_step(*to_j(args), interpret=True)
    got = ops.dekrr_step(*to_t(args))
    assert got.shape == want.shape
    assert_close(got, want)
    # the plain version against the JAX plain version, raw contract
    if k:
        lay = ops._pad_dekrr_operands("t", *to_t(args))[2]
        raw = ref_step_reference(*to_j([a.numpy() for a in lay]), dy=dy)
        assert_close(dekrr_step_reference(*lay, dy=dy), raw)


@pytest.mark.parametrize("j,k,dfeat,dy,extra", CASES[1:4] + CASES[5:])
@pytest.mark.parametrize("rounds", [1, 7])
@pytest.mark.parametrize("trace", [False, True])
def test_dekrr_solve_matches_reference(j, k, dfeat, dy, extra, rounds,
                                       trace):
    args = dekrr_case(j, k, dfeat, dy, extra, seed=j * 10 + k + dy)
    want = rops.dekrr_solve(*to_j(args), num_rounds=rounds, trace=trace,
                            interpret=True)
    got = ops.dekrr_solve(*to_t(args), num_rounds=rounds, trace=trace)
    if trace:
        assert_close(got[1], want[1])
        got, want = got[0], want[0]
    assert_close(got, want)
    if k and rounds == 7 and not trace:
        lay = ops._pad_dekrr_operands("t", *to_t(args))[2]
        raw = ref_solve_reference(*to_j([a.numpy() for a in lay]),
                                  num_rounds=rounds, dy=dy)
        assert_close(dekrr_solve_reference(*lay, num_rounds=rounds, dy=dy),
                     raw)


def test_dekrr_solve_zero_rounds_returns_self_rows():
    args = to_t(dekrr_case(4, 2, 6, 1, 2, seed=3))
    out, res = ops.dekrr_solve(*args, num_rounds=0, trace=True)
    assert torch.equal(out, args[4][args[6].long()])
    assert res.shape == (0, 4)


def test_padded_coordinates_stay_exactly_zero():
    g, d, s, p, theta, nbr_idx, self_idx, nbr_mask = dekrr_case(
        4, 2, 10, 3, 0, seed=9)
    live = 7
    for m in (g, s):
        m[:, live:, :] = 0.0
        m[:, :, live:] = 0.0
    p[:, :, live:, :] = 0.0
    d[:, live:] = 0.0
    theta[:, live:] = 0.0
    args = to_t((g, d, s, p, theta, nbr_idx, self_idx, nbr_mask))
    for out in (ops.dekrr_step(*args),
                ops.dekrr_solve(*args, num_rounds=5)):
        assert (out[:, live:] == 0).all()


def test_solve_equals_repeated_steps_bit_for_bit():
    g, d, s, p, theta, nbr_idx, _, nbr_mask = dekrr_case(5, 3, 11, 2, 0, 4)
    args = to_t((g, d, s, p, theta, nbr_idx, np.arange(5, dtype=np.int32),
                 nbr_mask))
    seq = args[4]
    for _ in range(6):
        seq = ops.dekrr_step(*args[:4], seq, *args[5:])
    assert torch.equal(ops.dekrr_solve(*args, num_rounds=6), seq)


def test_wrappers_reject_bad_tables_and_operands():
    args = list(to_t(dekrr_case(4, 2, 6, 1, 0, seed=5, masked=False)))
    bad = list(args)
    bad[5] = args[5].clone()
    bad[5][0, 0] = 4                      # live slot past the table
    with pytest.raises(ValueError, match="nbr_idx"):
        ops.dekrr_step(*bad)
    masked = list(bad)
    masked[7] = args[7].clone()
    masked[7][0, 0] = 0.0                 # the same index on a masked slot
    ops.dekrr_step(*masked)
    dup = list(args)
    dup[6] = torch.zeros(4, dtype=torch.int32)
    ops.dekrr_step(*dup)                  # one round may share a row
    with pytest.raises(ValueError, match="distinct"):
        ops.dekrr_solve(*dup, num_rounds=2)
    with pytest.raises(TypeError, match="dtype"):
        ops.dekrr_step(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        ops.dekrr_step(args[0][:, :5], *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        ops.dekrr_step(args[0].transpose(1, 2), *args[1:])


# ---------------------------------------------------------------- rff_gram
@pytest.mark.parametrize("b,f,dim,n", [(3, 10, 5, 40), (2, 17, 13, 130)])
def test_rff_gram_batched_matches_reference(b, f, dim, n):
    rng = np.random.default_rng(f + n)
    omega = rng.normal(size=(b, f, dim))
    bias = rng.uniform(0, 2 * np.pi, (b, f))
    x = rng.uniform(size=(b, dim, n))
    y = rng.normal(size=(b, n))
    mask = np.ones((b, n))
    mask[:, n - 5:] = 0.0
    want = rops.rff_gram_batched(*to_j((omega, bias, x, y, mask)),
                                 interpret=True)
    got = ops.rff_gram_batched(*to_t((omega, bias, x, y, mask)))
    for a, w in zip(got, want):
        assert_close(a, w)
    for a, w in zip(rff_gram_batched_reference(*to_t((omega, bias, x, y,
                                                       mask))), want):
        assert_close(a, w)


def test_rff_gram_batched_float32_at_one_problem():
    """B 1 in float32, as `gram_fn_for_solver` calls it (the kernel's f32
    route on the card): the wrapper's plain version and the plain version
    itself against the reference's kernel in interpret mode on the same
    float32 inputs, rtol 2e-4, the `gram_fn` path's tolerance."""
    b, f, dim, n = 1, 33, 13, 130
    rng = np.random.default_rng(f + n)
    mask = np.ones((b, n))
    mask[:, n - 7:] = 0.0
    arrays = tuple(a.astype(np.float32) for a in (
        rng.normal(size=(b, f, dim)), rng.uniform(0, 2 * np.pi, (b, f)),
        rng.uniform(size=(b, dim, n)), rng.normal(size=(b, n)), mask))
    want = rops.rff_gram_batched(*to_j(arrays), interpret=True)
    assert want[0].dtype == jnp.float32
    got = ops.rff_gram_batched(*to_t(arrays))
    assert got[0].dtype == torch.float32
    for a, w in zip(got, want):
        assert_close(a, w, rtol=2e-4)
    for a, w in zip(rff_gram_batched_reference(*to_t(arrays)), want):
        assert_close(a, w, rtol=2e-4)


def test_rff_gram_single_matches_reference():
    rng = np.random.default_rng(2)
    omega, bias = rng.normal(size=(12, 6)), rng.uniform(0, 6, 12)
    x, y = rng.uniform(size=(6, 90)), rng.normal(size=90)
    want = ref_rff_gram_ref(*to_j((omega, bias, x, y)), scale=0.4)
    got = ops.rff_gram(*to_t((omega, bias, x, y)), scale=0.4)
    for a, w in zip(got, want):
        assert_close(a, w)
    for a, w in zip(rff_gram_ref(*to_t((omega, bias, x, y)), scale=0.4),
                    want):
        assert_close(a, w)


def test_rff_gram_rejects_mixed_operands():
    rng = np.random.default_rng(0)
    args = to_t((rng.normal(size=(2, 4, 3)), rng.normal(size=(2, 4)),
                 rng.normal(size=(2, 3, 8)), rng.normal(size=(2, 8)),
                 np.ones((2, 8))))
    with pytest.raises(TypeError, match="dtype"):
        ops.rff_gram_batched(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        ops.rff_gram_batched(args[0], args[1][:, :3], *args[2:])
