"""Packed runtime of the port: `pack_problem`, `step_batched` and
`solve_batched` with the backend switch ``torch | cuda | cuda_fused``
(the batched matmul round, the `dekrr_step` round kernel, and the
`dekrr_solve` multi-round kernel), and the asynchronous-gossip solver on
the same layout (`async_step_batched`, `async_solve_batched`: the masked
round kernel and the async-chain kernel)."""
from repro_torch.dist.async_gossip import (AsyncGossipState,
                                           AsyncGossipStats, AsyncRoundInfo,
                                           async_solve_batched,
                                           async_step_batched,
                                           init_async_state)
from repro_torch.dist.dekrr_spmd import (PackedProblem,
                                         comm_bytes_per_round, pack_problem,
                                         pack_theta, solve_batched,
                                         step_batched, unpack_theta)

__all__ = ["AsyncGossipState", "AsyncGossipStats", "AsyncRoundInfo",
           "PackedProblem", "async_solve_batched", "async_step_batched",
           "comm_bytes_per_round", "init_async_state", "pack_problem",
           "pack_theta", "solve_batched", "step_batched", "unpack_theta"]
