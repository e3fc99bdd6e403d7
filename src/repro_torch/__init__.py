"""PyTorch/CUDA port of the DeKRR-DDRF system.

Mirrors the JAX package's layout (`core`, `data`, `dist`, `kernels`,
`obs`) so each module's counterpart is found by name. The hot path runs
through hand-written CUDA kernels for Hopper (`repro_torch.kernels`);
on CPU tensors every kernel wrapper runs the kernel's plain PyTorch
version instead.

Entry points put their tensors on the CUDA device unless the caller
passes ``device="cpu"``; without a card they raise.
"""
