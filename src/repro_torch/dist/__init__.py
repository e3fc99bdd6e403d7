"""Packed runtime of the port: `pack_problem`, `step_batched` and
`solve_batched` with the backend switch ``torch | cuda | cuda_fused``
(the batched matmul round, the `dekrr_step` round kernel, and the
`dekrr_solve` multi-round kernel)."""
from repro_torch.dist.dekrr_spmd import (PackedProblem,
                                         comm_bytes_per_round, pack_problem,
                                         pack_theta, solve_batched,
                                         step_batched, unpack_theta)

__all__ = ["PackedProblem", "comm_bytes_per_round", "pack_problem",
           "pack_theta", "solve_batched", "step_batched", "unpack_theta"]
