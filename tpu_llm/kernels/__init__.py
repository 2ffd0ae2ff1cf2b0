"""GPU kernels and the one module that chooses between them and plain XLA.

- ``select``: every kernel-or-plain decision, made from the platform, the
  shapes, the dtypes and the quant kind;
- ``qmatmul``: fused dequant-matmul for Q4_0/Q8_0 weights (Pallas, Triton
  route);
- ``attention``: decode, paged-decode and prefill attention through
  library kernels (JAX's Pallas GPU ops and cuDNN).

Every kernel takes ``interpret=True`` so the CPU tests run it; nothing
outside the tests asks for interpret mode.
"""
