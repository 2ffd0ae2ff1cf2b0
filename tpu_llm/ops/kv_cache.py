"""Quantized (int8) KV cache.

The reference allocates the full-context KV cache as dense f32
(``llama2.f90:311-313``) — at TinyLlama shapes that is 1.4 MB/layer/stream,
but batched long-context serving multiplies it by batch x context x layers,
and decode attention re-reads the WHOLE cache every token. Storing K/V as
int8 with one f32 scale per (token, kv-head) vector halves-to-quarters the
cache's HBM footprint and read traffic vs bf16/f32 at <0.5% attention-score
error (each 64-dim head vector quantized to its own absmax/127 step).

Factorization: attention never dequantizes the cache. The score dot
contracts q (bf16) against the int8 K plane directly (the int8->bf16
widening fuses into the operand read) and the per-(token, head) scale
is applied to the (..., S) score matrix afterwards — S multiplies per head
instead of S x D. Same trick on the value side: the scale folds into the
attention weights before the AV contraction.

``QuantKV`` is a pytree, so it flows through jit/scan/donation like the
dense cache; ``update_kv_cache``/``gqa_attention`` in tpu_llm.ops.attention
dispatch on its type.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class QuantKV:
    """int8 KV plane: ``q`` (..., S, H, D) int8, ``s`` (..., S, H) f32."""

    q: jax.Array
    s: jax.Array

    def tree_flatten(self):
        return (self.q, self.s), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        q, s = children
        return cls(q=q, s=s)

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):  # storage dtype, for cache-policy introspection
        return self.q.dtype

    @classmethod
    def zeros(cls, shape, *_ignored, flat: bool = False) -> "QuantKV":
        """``flat=True`` stores the logical (B, S, Hkv, D) plane as
        (B, S, Hkv*D) int8 with kv-head-major scales (B, Hkv, S): one
        contiguous row per token, updated in place."""
        if flat:
            *lead, s_len, hkv, d = shape
            return cls(
                q=jnp.zeros((*lead, s_len, hkv * d), jnp.int8),
                # scales kv-head-major: updates write a (B, Hkv, T) slab
                # at lane offset pos (in-place), and the attention read
                # needs (B, Hkv, S) anyway — no per-step transpose
                s=jnp.zeros((*lead, hkv, s_len), jnp.float32),
            )
        return cls(
            q=jnp.zeros(shape, jnp.int8),
            s=jnp.zeros(shape[:-1], jnp.float32),
        )


def quantize_kv(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(..., D) f32/bf16 -> (int8 values, f32 scale over the last axis)."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1)
    s = amax / 127.0
    inv = jnp.where(s > 0, 1.0 / jnp.where(s > 0, s, 1.0), 0.0)
    q = jnp.clip(jnp.round(xf * inv[..., None]), -127, 127).astype(jnp.int8)
    return q, s


def dequantize_kv(kv: QuantKV, dtype=jnp.float32, head_dim: int | None = None
                  ) -> jax.Array:
    """Materialize the float cache. 4D layout -> (B, S, Hkv, D); flat
    layout (q (B, S, Hkv*D), s (B, Hkv, S)) -> same 4D shape —
    ``head_dim`` is required for flat planes to split Hkv*D."""
    if kv.q.ndim == kv.s.ndim:  # flat layout
        if head_dim is None:
            raise ValueError("flat QuantKV needs head_dim to dequantize")
        *lead, S, HkvD = kv.q.shape
        hkv = HkvD // head_dim
        q4 = kv.q.reshape(*lead, S, hkv, head_dim).astype(jnp.float32)
        s = jnp.swapaxes(kv.s, -1, -2)          # (..., S, Hkv)
        return (q4 * s[..., None]).astype(dtype)
    return (kv.q.astype(jnp.float32) * kv.s[..., None]).astype(dtype)
