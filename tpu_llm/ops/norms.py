"""Normalization ops.

Numerics pinned to the reference:
- RMSNorm (``llama2.f90:450-457``, dup ``ssm/mamba.f90:489-496``):
  ``x * w / sqrt(mean(x*x) + eps)`` — eps added to the MEAN-SQUARE inside the
  sqrt (not to the rms). eps default 1e-5.
- LayerNorm with bias for the phi-2 architecture (not in the master snapshot;
  dev/phi2 capability, SURVEY.md §7 step 8).

Norms are computed in float32 regardless of storage dtype and cast back;
XLA fuses them with their neighbouring elementwise ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rmsnorm(x: jax.Array, w, eps: float = 1e-5) -> jax.Array:
    """RMS-normalize the last axis of ``x`` and scale by ``w``.

    ``w=None`` skips the weight multiply: the layer's norm weight was
    folded into the next projection's weights
    (``quant.convert_params.fold_norms_requant``)."""
    xf = x.astype(jnp.float32)
    ms = jnp.mean(xf * xf, axis=-1, keepdims=True)
    out = xf * jax.lax.rsqrt(ms + eps)
    if w is not None:
        out = out * w.astype(jnp.float32)
    return out.astype(x.dtype)


def layernorm(x: jax.Array, w: jax.Array, b: jax.Array, eps: float = 1e-5) -> jax.Array:
    """LayerNorm over the last axis with scale and bias (phi-2 blocks)."""
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mu), axis=-1, keepdims=True)
    out = (xf - mu) * jax.lax.rsqrt(var + eps)
    out = out * w.astype(jnp.float32) + b.astype(jnp.float32)
    return out.astype(x.dtype)
