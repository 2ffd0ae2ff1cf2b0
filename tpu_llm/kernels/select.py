"""Kernel selection: the one place that decides, per call, whether a hot
operation runs a GPU kernel or the plain XLA path.

Every decision is made from what the call can see: the platform, the
shapes, the dtypes and the quant kind. There are no switches. On the GPU a
kernel that is selected and then fails to compile fails the program; no
path falls back to another.

Kernels run only on bf16 operands. float32 runs (``--dtype f32``) stay on
the plain path, whose products ask for ``Precision.HIGHEST``.

``kernels_disabled()`` is the scoped exception for programs whose bodies
XLA partitions itself (GSPMD mesh serving): a Pallas call is not
partitioned by GSPMD, so those traces keep to plain ops. It only matters
while a jit trace runs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Row counts up to which the fused dequant-matmul beats dequantize + GEMM
# on the H100: it wins at 1, 8 and 32 rows and loses at 512 (PERF.md,
# kernel-against-plain table).
QMATMUL_MAX_ROWS = 32
# Prompt length from which cuDNN flash prefill beats the plain einsum on
# the H100. At 512 tokens the runs disagree (0.81x to 1.48x); from 1024 up
# every run measured it faster (PERF.md, kernel-against-plain table).
PREFILL_MIN_T = 1024

_disabled = 0


class kernels_disabled:
    """Context manager: traces inside it select no kernel."""

    def __enter__(self):
        global _disabled
        _disabled += 1
        return self

    def __exit__(self, *exc):
        global _disabled
        _disabled -= 1
        return False


def platform() -> str:
    return jax.default_backend()


def _on_gpu() -> bool:
    return _disabled == 0 and platform() == "gpu"


def qmatmul(x_dtype, rows: int, w) -> bool:
    """Fused Q4_0/Q8_0 dequant-matmul (kernels.qmatmul) for ``w``.
    Other quant kinds take the plain dequantize + matmul path."""
    from tpu_llm.kernels.qmatmul import supported

    return (_on_gpu() and x_dtype == jnp.bfloat16 and w.q.ndim == 2
            and rows <= QMATMUL_MAX_ROWS
            and supported(w.kind, w.shape[-2], w.shape[-1]))


def decode_attention(q, k_cache) -> bool:
    """Library flash-decode kernel for one query token per row against a
    dense bf16 cache."""
    from tpu_llm.kernels.attention import decode_plan
    from tpu_llm.ops.kv_cache import QuantKV

    if not _on_gpu() or isinstance(k_cache, QuantKV):
        return False
    B, T, H, D = q.shape
    return (T == 1 and q.dtype == jnp.bfloat16
            and k_cache.dtype == jnp.bfloat16 and D in (64, 128)
            and decode_plan(k_cache.shape[1]) is not None)


def prefill_attention(q, k_cache, offset) -> bool:
    """cuDNN flash prefill: causal, from cache position 0 (``offset`` a
    concrete 0, as the engines' prefill passes it), bf16 queries over a
    bf16 or int8 cache (an int8 cache is dequantized once per call), long
    enough for the fused kernel to beat the plain einsum."""
    from tpu_llm.ops.kv_cache import QuantKV

    if not _on_gpu():
        return False
    if isinstance(offset, jax.core.Tracer) or jnp.ndim(offset) != 0 \
            or int(offset) != 0:
        return False
    B, T, H, D = q.shape
    return (T >= PREFILL_MIN_T and q.dtype == jnp.bfloat16
            and (isinstance(k_cache, QuantKV)
                 or k_cache.dtype == jnp.bfloat16)
            and D in (64, 128) and k_cache.shape[1] >= T)


def paged_decode_attention(q, kv) -> bool:
    """Library paged-decode kernel: one query token per row, bf16 or int8
    pools."""
    from tpu_llm.kernels.attention import paged_plan

    if not _on_gpu():
        return False
    B, T, H, D = q.shape
    return (T == 1 and q.dtype == jnp.bfloat16 and D in (64, 128)
            and (kv.quantized or kv.k_pool.dtype == jnp.bfloat16)
            and paged_plan(kv.block_table.shape[1], kv.block_size)
            is not None)
