"""tpu_llm — a quantized LLM inference framework in JAX, run on GPUs.

Brand-new JAX/XLA/Pallas implementation of the capability set of
``rbitr/llm.f90`` (surveyed in SURVEY.md): GGUF loading of f32/f16/Q4_0
llama-family checkpoints, the autoregressive decode loop (RMSNorm,
interleaved RoPE, GQA attention with KV cache, SwiGLU FFN,
greedy/temperature sampling, score-merge BPE tokenizer), the Mamba
selective-state-space path, plus accelerator-idiomatic scaling: fused
dequant-matmul Pallas kernels, tensor/data-parallel sharding over a
``jax.sharding.Mesh``, and batched prefill.

This is NOT a port of the Fortran — the architecture is functional JAX
(pure decode steps over parameter/cache pytrees, ``lax.scan`` over
layers, pjit over meshes), with file-format and numeric parity pinned
against the reference by tests.
"""

__version__ = "0.1.0"

from tpu_llm.config import LlamaConfig, MambaConfig  # noqa: F401
