"""Static checks of the port, each guarding a hazard of the card.

The port's counterpart of the reference's `repro.analysis`:

``smem`` — the Hopper budget: each kernel's dynamic shared memory a
  block (its ``csrc`` launcher's formula), its cluster size and its grid,
  checked by the `repro_torch.kernels.ops` wrappers before any staging or
  launch, on the CPU as on the card, so an over-budget shape raises
  `SmemBudgetError` naming the formula and the limit instead of an opaque
  CUDA error after the problem was packed (rule V001). Also hosts
  `check_index_table`, the bounds check of an index table a kernel
  gathers through.

``dispatch`` (in the CLI) — runs each solver entry point on a small CPU
  problem and holds its kernel dispatches
  (`repro_torch.obs.dispatch.dispatch_count`) to the documented contract
  {torch: 0, cuda: R, cuda_fused: ⌈R / chunk_rounds⌉}, reported under the
  reference's rule J002.

``conventions`` — AST linter for the house contracts of the port
  (R001, R004 as raw ``*_cuda(`` kernel calls, R005, R006).

Not ported, because PyTorch has no traced program to inspect: the
reference's jaxpr rules J001 (no host callback in a loop body), J003
(ppermute bijections), J004 (no downcast of a loop carry), J005
(replicated collective control) and V002 (budgets from BlockSpecs), the
conventions R002 (no host sync on a tracer under jit) and R003 (x64 for
tight tolerances), and `dist/dekrr_spmd.py::pack_trace_count` (a JAX
retrace counter).

Run all passes with ``python -m repro_torch.analysis``.
"""
from repro_torch.analysis.report import (Finding, render_json,  # noqa: F401
                                         render_report)
from repro_torch.analysis.smem import (SMEM_LIMITS,  # noqa: F401
                                       SMEM_OPTIN_PER_BLOCK, SmemBudgetError,
                                       SmemEstimate, check_index_table,
                                       estimate_dekrr_async_solve,
                                       estimate_dekrr_cheb_solve,
                                       estimate_dekrr_solve,
                                       estimate_dekrr_step,
                                       estimate_flash_decode,
                                       estimate_rff_features,
                                       estimate_rff_gram,
                                       estimate_serve_wave)

__all__ = [
    "Finding", "render_json", "render_report",
    "SMEM_LIMITS", "SMEM_OPTIN_PER_BLOCK", "SmemBudgetError",
    "SmemEstimate", "check_index_table",
    "estimate_dekrr_step", "estimate_dekrr_solve",
    "estimate_dekrr_async_solve", "estimate_dekrr_cheb_solve",
    "estimate_rff_gram", "estimate_rff_features", "estimate_serve_wave",
    "estimate_flash_decode",
]
