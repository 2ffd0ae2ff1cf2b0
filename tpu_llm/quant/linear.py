"""Linear-layer dispatch: dense jnp arrays or packed QTensors.

``matmul(x, w)`` is the single projection primitive the models call.
QTensors go to the fused GPU dequant-matmul where ``kernels.select``
picks it, and otherwise to XLA: dequantize, then one dot with f32
accumulation.

Precision: float32 activations ask for ``Precision.HIGHEST`` so that
``--dtype f32`` is a true float32 product on GPUs, whose default for f32
dots is TF32 (about three decimal digits). bf16 activations take the
default, which is one bf16 pass with f32 accumulation.
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp

from tpu_llm.kernels import select
from tpu_llm.quant.qtensor import QTensor, dequantize

Weight = Union[jax.Array, QTensor]


def _dot(x, w):
    precision = (jax.lax.Precision.HIGHEST
                 if jnp.result_type(x, w) == jnp.float32 else None)
    return jnp.matmul(x, w, precision=precision,
                      preferred_element_type=jnp.float32)


def matmul(x: jax.Array, w: Weight, out_dtype=None) -> jax.Array:
    """x: (..., K) @ w: (K, N) -> (..., N), accumulating in f32.

    ``out_dtype`` defaults to x.dtype; pass jnp.float32 to keep the f32
    accumulator un-rounded (e.g. the classifier's logits)."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QTensor):
        rows = 1
        for d in x.shape[:-1]:
            rows *= d
        if select.qmatmul(x.dtype, rows, w):
            from tpu_llm.kernels.qmatmul import qmatmul

            return qmatmul(x, w.q, w.scales).astype(out_dtype)
        wd = dequantize(w, dtype=jnp.float32 if x.dtype == jnp.float32 else jnp.bfloat16)
        return _dot(x, wd).astype(out_dtype)
    return _dot(x, w).astype(out_dtype)
