"""Attention kernels for the GPU, all of them library kernels.

- ``decode_attention``: the split-K flash-decode kernel body of JAX's
  ``jax.experimental.pallas.ops.gpu.decode_attention`` (Triton route),
  launched over the repository's flat (B, S, Hkv*D) cache planes so that
  no per-step transpose of the cache is needed. Each row reads only the
  cache up to its own position.
- ``paged_decode_attention``: the kernel body of
  ``jax.experimental.pallas.ops.gpu.paged_attention`` (Triton route) over
  the flat (n_blocks, block_size, Hkv*D) pools, with per-(token, kv-head)
  scale pools for int8 caches. Pages are read through the block table; the
  logical cache is never materialised.
- ``prefill_attention``: cuDNN's fused flash attention through
  ``jax.nn.dot_product_attention(implementation="cudnn")`` for causal
  prefill that starts at cache position 0. An int8 cache is dequantized
  to bf16 over the prompt's slots once per call.

The split-K partial results are combined in XLA, exactly as the library
wrappers do it.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

_BLOCK_H = 16          # query-head rows per program (pl.dot's minimum)


def _combine(o, l, m):
    """Merge split-K flash partials: o (S, ..., D) f32, l/m (S, ...)."""
    m_next = jax.lax.optimization_barrier(m.max(axis=0))
    corr = jnp.exp(m - m_next[None])
    l_next = (l * corr).sum(axis=0)
    o = (o * corr[..., None]).sum(axis=0)
    return o / (l_next[..., None] + jnp.finfo(jnp.float32).eps)


def decode_plan(S: int):
    """(k_splits, block_k) for a cache of S slots, or None if S does not
    tile. About one split per 256 slots keeps the grid wide at batch 1
    while the kernel skips every split past a row's position; each split
    is a whole number of ``block_k`` blocks."""
    block_k = 64
    if S % block_k:
        return None
    n_blocks = S // block_k
    target = min(64, max(1, S // 256))
    k_splits = max(d for d in range(1, target + 1) if n_blocks % d == 0)
    return k_splits, block_k


@functools.partial(jax.jit, static_argnames=("interpret",))
def decode_attention(q, k_cache, v_cache, positions, *, interpret=False):
    """q (B, 1, H, D) against bf16 caches (B, S, Hkv*D) or (B, S, Hkv, D);
    slot s of row b is visible iff s <= positions[b]. Returns (B, 1, H, D).
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu
    from jax.experimental.pallas.ops.gpu import decode_attention as lib

    B, _, H, D = q.shape
    S = k_cache.shape[1]
    k_cache = k_cache.reshape(B, S, -1)
    v_cache = v_cache.reshape(B, S, -1)
    Hkv = k_cache.shape[-1] // D
    G = H // Hkv
    k_splits, block_k = decode_plan(S)
    split = S // k_splits
    lengths = jnp.broadcast_to(positions.reshape(-1).astype(jnp.int32) + 1,
                               (B,))
    kernel = functools.partial(
        lib.attn_forward_kernel, sm_scale=1.0 / math.sqrt(D),
        block_k=min(block_k, split), block_h=_BLOCK_H, num_heads=G)
    head_splits = -(-G // _BLOCK_H)

    def one_row(q, k, v, length):         # (Hkv, G, D), (S, Hkv*D), ()
        return pl.pallas_call(
            kernel,
            grid=(head_splits, k_splits, Hkv),
            in_specs=[
                pl.BlockSpec((None, _BLOCK_H, D), lambda i, j, h: (h, i, 0)),
                pl.BlockSpec((split, D), lambda i, j, h: (j, h)),
                pl.BlockSpec((split, D), lambda i, j, h: (j, h)),
                None,
                pl.BlockSpec((), lambda i, j, h: ()),
            ],
            out_specs=[
                pl.BlockSpec((None, None, _BLOCK_H, D),
                             lambda i, j, h: (j, h, i, 0)),
                pl.BlockSpec((None, None, _BLOCK_H),
                             lambda i, j, h: (j, h, i)),
                pl.BlockSpec((None, None, _BLOCK_H),
                             lambda i, j, h: (j, h, i)),
            ],
            out_shape=[
                jax.ShapeDtypeStruct((k_splits, Hkv, G, D), jnp.float32),
                jax.ShapeDtypeStruct((k_splits, Hkv, G), jnp.float32),
                jax.ShapeDtypeStruct((k_splits, Hkv, G), jnp.float32),
            ],
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
            interpret=interpret,
            name="decode_attention",
        )(q, k, v, None, length)

    o, l, m = jax.vmap(one_row)(q.reshape(B, Hkv, G, D), k_cache, v_cache,
                                lengths)
    out = jax.vmap(_combine)(o, l, m)                     # (B, Hkv, G, D)
    return out.reshape(B, 1, H, D).astype(q.dtype)


def paged_plan(max_blocks: int, block_size: int):
    """(k_splits, pages_per_compute_block) for a block table of
    ``max_blocks`` columns, or None if the pages do not tile."""
    pow2 = lambda n: n > 0 and n & (n - 1) == 0  # noqa: E731
    if not pow2(block_size):
        return None
    k_splits = max(d for d in range(1, 17) if max_blocks % d == 0)
    per_split = max_blocks // k_splits
    ppcb = max(p for p in (1, 2, 4, 8) if per_split % p == 0)
    if ppcb * block_size < 16:
        return None
    return k_splits, ppcb


@functools.partial(jax.jit, static_argnames=("interpret",))
def paged_decode_attention(q, k_pool, v_pool, block_table, positions,
                           k_scale=None, v_scale=None, *, interpret=False):
    """q (B, 1, H, D) against paged pools (n_blocks, block_size, Hkv*D)
    (bf16, or int8 with (Hkv, n_blocks, block_size) f32 scale pools).
    Slot s of row b is visible iff s <= positions[b]. Returns
    (B, 1, H, D)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu
    from jax.experimental.pallas.ops.gpu import paged_attention as lib

    B, _, H, D = q.shape
    N, bs, HkvD = k_pool.shape
    Hkv = HkvD // D
    G = H // Hkv
    MB = block_table.shape[1]
    k_splits, ppcb = paged_plan(MB, bs)
    per_split = MB // k_splits
    Gp = -(-G // _BLOCK_H) * _BLOCK_H
    lengths = jnp.broadcast_to(positions.reshape(-1).astype(jnp.int32) + 1,
                               (B,))
    kernel = functools.partial(
        lib.paged_attention_kernel, num_heads=G,
        pages_per_compute_block=ppcb, mask_value=lib.DEFAULT_MASK_VALUE,
        attn_logits_soft_cap=None)
    pages = pl.BlockSpec((N, bs, D), lambda h, i, k: (0, 0, h))
    scales = (None if k_scale is None else
              pl.BlockSpec((None, N, bs), lambda h, i, k: (h, 0, 0)))
    # the kernel scales q.k by 1/sqrt(D) nowhere: fold it into q
    qs = (q.astype(jnp.float32) / math.sqrt(D)).astype(q.dtype)
    qs = jnp.pad(qs.reshape(B, Hkv, G, D), ((0, 0), (0, 0), (0, Gp - G),
                                             (0, 0)))

    def one_row(q, table, length):
        return pl.pallas_call(
            kernel,
            grid=(Hkv, Gp // _BLOCK_H, k_splits),
            in_specs=[
                pl.BlockSpec((None, _BLOCK_H, D), lambda h, i, k: (h, i, 0)),
                pages, scales, pages, scales,
                pl.BlockSpec((None, per_split), lambda h, i, k: (k, 0)),
                pl.BlockSpec((1,), lambda h, i, k: (0,)),
            ],
            out_specs=[
                pl.BlockSpec((None, None, _BLOCK_H, D),
                             lambda h, i, k: (k, h, i, 0)),
                pl.BlockSpec((None, None, _BLOCK_H),
                             lambda h, i, k: (k, h, i)),
                pl.BlockSpec((None, None, _BLOCK_H),
                             lambda h, i, k: (k, h, i)),
            ],
            out_shape=[
                jax.ShapeDtypeStruct((k_splits, Hkv, Gp, D), jnp.float32),
                jax.ShapeDtypeStruct((k_splits, Hkv, Gp), jnp.float32),
                jax.ShapeDtypeStruct((k_splits, Hkv, Gp), jnp.float32),
            ],
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
            interpret=interpret,
            name="paged_decode_attention",
        )(q, k_pool, k_scale, v_pool, v_scale,
          table.reshape(k_splits, per_split), length[None])

    o, l, m = jax.vmap(one_row)(qs, block_table, lengths)
    out = jax.vmap(_combine)(o, l, m)[:, :, :G]           # (B, Hkv, G, D)
    return out.reshape(B, 1, H, D).astype(q.dtype)


def _prompt_slots(cache, T: int, D: int):
    """Cache slots [0, T) as a bf16 (B, T, Hkv, D) array. An int8 cache
    (``QuantKV``, flat or 4D) is dequantized over those slots only: the
    bf16 copy is 2x the int8 bytes, paid once for the whole prompt,
    where the einsum path would materialise (B, T, H, S) f32 scores."""
    from tpu_llm.ops.kv_cache import QuantKV, dequantize_kv

    if isinstance(cache, QuantKV):
        flat = cache.q.ndim == cache.s.ndim   # s (B, Hkv, S), else (B, S, Hkv)
        s = cache.s[..., :T] if flat else cache.s[:, :T]
        return dequantize_kv(QuantKV(q=cache.q[:, :T], s=s), jnp.bfloat16,
                             head_dim=D)
    B, S = cache.shape[:2]
    return cache.reshape(B, S, -1, D)[:, :T]


def prefill_attention(q, k_cache, v_cache, *, implementation="cudnn"):
    """Causal attention of q (B, T, H, D) over cache slots [0, T) —
    prefill from position 0 — through cuDNN's fused flash attention.
    Caches are bf16 (B, S, Hkv*D) or (B, S, Hkv, D), or int8 ``QuantKV``
    planes, with S >= T. ``implementation="xla"`` is the same call on
    XLA's own attention, for the CPU tests (cuDNN has no CPU
    implementation)."""
    T, D = q.shape[1], q.shape[3]
    k = _prompt_slots(k_cache, T, D)
    v = _prompt_slots(v_cache, T, D)
    return jax.nn.dot_product_attention(q, k, v, is_causal=True,
                                        implementation=implementation)
