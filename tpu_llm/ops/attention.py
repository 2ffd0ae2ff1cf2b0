"""GQA attention against a preallocated KV cache.

The reference computes attention one token at a time with scalar loops over
heads and cached positions (``llama2.f90:574-598``), with a softmax that
truncates to positions 1..pos (``llama2.f90:468-478``). Note the reference's
literal kv-head slice is buggy (empty for most heads — SURVEY.md §2 #13);
we implement the *intended* GQA: query head h reads kv head h // kv_groups.

Plain path: a single batched einsum formulation that serves both
prefill (T > 1, causal) and decode (T = 1) so XLA maps the contractions to
matmuls and fuses mask+softmax. (GPU kernels for decode and long prefill
live in tpu_llm.kernels and are chosen by tpu_llm.kernels.select.) KV cache is a static-shape array updated
with dynamic_update_slice; masking by position replaces the reference's
truncation (numerically identical through softmax).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_NEG_INF = -0.7 * float(jnp.finfo(jnp.float32).max)


def _einsum(spec, a, b, **kw):
    """einsum that keeps float32 contractions at float32: GPUs run f32
    dots in TF32 unless HIGHEST is asked for."""
    f32 = jnp.result_type(a, b) == jnp.float32
    return jnp.einsum(spec, a, b, precision=jax.lax.Precision.HIGHEST
                      if f32 else None, **kw)


def update_kv_cache(
    k_cache,             # (B, S, Hkv, D) or flat (B, S, Hkv*D) array or QuantKV
    v_cache,
    k_new: jax.Array,    # (B, T, Hkv, D)
    v_new: jax.Array,
    offset: jax.Array,   # scalar int, or (B,) per-slot write positions
):
    from tpu_llm.ops.kv_cache import QuantKV, quantize_kv

    if isinstance(k_cache, QuantKV):
        assert k_new.ndim == 4, f"k_new must be (B, T, Hkv, D), got {k_new.shape}"
        B, T, Hkv, D = k_new.shape
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        if k_cache.q.ndim == 3:  # flat plane + (B, Hkv, S) scales
            kq = kq.reshape(B, T, Hkv * D)
            vq = vq.reshape(B, T, Hkv * D)
            kq_c, vq_c = update_kv_cache(k_cache.q, v_cache.q, kq, vq, offset)
            ks_c, vs_c = _update_scales_flat(
                k_cache.s, v_cache.s, ks.transpose(0, 2, 1),
                vs.transpose(0, 2, 1), offset)
            return QuantKV(kq_c, ks_c), QuantKV(vq_c, vs_c)
        kq_c, vq_c = update_kv_cache(k_cache.q, v_cache.q, kq, vq, offset)
        ks_c, vs_c = _update_scales(k_cache.s, v_cache.s, ks, vs, offset)
        return QuantKV(kq_c, ks_c), QuantKV(vq_c, vs_c)
    if k_cache.ndim == 3 and k_new.ndim == 4:
        # flat storage (see QuantKV.zeros / llama.init_cache): one
        # contiguous row per token, written in place
        B, T, Hkv, D = k_new.shape
        k_new = k_new.reshape(B, T, Hkv * D)
        v_new = v_new.reshape(B, T, Hkv * D)
    offset = offset.astype(jnp.int32)
    if offset.ndim == 0:
        zero = jnp.zeros((), dtype=jnp.int32)
        idx = (zero, offset) + (zero,) * (k_cache.ndim - 2)
        k_cache = jax.lax.dynamic_update_slice(k_cache, k_new.astype(k_cache.dtype), idx)
        v_cache = jax.lax.dynamic_update_slice(v_cache, v_new.astype(v_cache.dtype), idx)
        return k_cache, v_cache

    # per-slot offsets (continuous batching): vmap the row update
    def row(kc, vc, kn, vn, off):
        zero = jnp.zeros((), dtype=jnp.int32)
        idx = (off,) + (zero,) * (kc.ndim - 1)
        kc = jax.lax.dynamic_update_slice(kc, kn.astype(kc.dtype), idx)
        vc = jax.lax.dynamic_update_slice(vc, vn.astype(vc.dtype), idx)
        return kc, vc

    return jax.vmap(row)(k_cache, v_cache, k_new, v_new, offset)


def _update_scales_flat(ks_c, vs_c, ks, vs, offset):
    """Write (B, Hkv, T) scale slabs into (B, Hkv, S) planes at lane
    offset ``offset`` (in place)."""
    offset = offset.astype(jnp.int32)
    if offset.ndim == 0:
        zero = jnp.zeros((), dtype=jnp.int32)
        idx = (zero, zero, offset)
        return (
            jax.lax.dynamic_update_slice(ks_c, ks.astype(ks_c.dtype), idx),
            jax.lax.dynamic_update_slice(vs_c, vs.astype(vs_c.dtype), idx),
        )

    def row(sc, sn, off):
        zero = jnp.zeros((), dtype=jnp.int32)
        return jax.lax.dynamic_update_slice(sc, sn.astype(sc.dtype), (zero, off))

    return (
        jax.vmap(row)(ks_c, ks, offset),
        jax.vmap(row)(vs_c, vs, offset),
    )


def _update_scales(ks_c, vs_c, ks, vs, offset):
    """Write (B, T, Hkv) scale rows into (B, S, Hkv) scale planes."""
    offset = offset.astype(jnp.int32)
    if offset.ndim == 0:
        zero = jnp.zeros((), dtype=jnp.int32)
        idx = (zero, offset, zero)
        return (
            jax.lax.dynamic_update_slice(ks_c, ks.astype(ks_c.dtype), idx),
            jax.lax.dynamic_update_slice(vs_c, vs.astype(vs_c.dtype), idx),
        )

    def row(sc, sn, off):
        zero = jnp.zeros((), dtype=jnp.int32)
        return jax.lax.dynamic_update_slice(
            sc, sn.astype(sc.dtype), (off, zero))

    return (
        jax.vmap(row)(ks_c, ks, offset),
        jax.vmap(row)(vs_c, vs, offset),
    )


def gqa_attention(
    q: jax.Array,          # (B, T, H, D)
    k_cache,               # (B, S, Hkv, D) array or QuantKV
    v_cache,
    q_positions: jax.Array,  # (T,) or (B, T) 0-based absolute positions of q rows
    kv_lengths: jax.Array | None = None,  # (B,) valid cache length per row; None -> causal only
) -> jax.Array:
    """Scaled dot-product GQA attention. Returns (B, T, H, D).

    Visibility rule: cache slot s is attended iff s <= q_position (causal)
    and s < kv_length (ragged batch support). Matches the reference's
    softmax-truncation at pos (llama2.f90:586) for the dense single-stream
    case.

    int8 caches (QuantKV) are contracted WITHOUT dequantizing: the per-
    (token, head) scales factor out of both dots — applied to the (..., S)
    score matrix after the QK contraction, and folded into the attention
    weights before the AV contraction (S multiplies per head, not S x D).
    """
    from tpu_llm.ops.kv_cache import QuantKV

    T, D = q.shape[1], q.shape[3]
    if isinstance(k_cache, QuantKV):
        if k_cache.q.ndim == 3:
            if T > 1:
                # prefill: the block-diag flat contraction costs Hkv x
                # the MACs and materializes an Hkv x wider AV tensor —
                # one reshape to the 4D layout per prefill call is
                # cheaper (decode T=1 keeps the flat path)
                k_cache, v_cache = (_quantkv_to_4d(k_cache, D),
                                    _quantkv_to_4d(v_cache, D))
            else:
                return _gqa_attention_int8_flat(
                    q, k_cache, v_cache, q_positions, kv_lengths)
        return _gqa_attention_int8(q, k_cache, v_cache, q_positions, kv_lengths)
    if k_cache.ndim == 3:
        if T > 1:
            B, S, HkvD = k_cache.shape
            k_cache = k_cache.reshape(B, S, HkvD // D, D)
            v_cache = v_cache.reshape(B, S, HkvD // D, D)
        else:
            return _gqa_attention_flat(
                q, k_cache, v_cache, q_positions, kv_lengths)
    B, T, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = 1.0 / jnp.sqrt(jnp.float32(D))

    # bf16 q + bf16 cache contract directly with f32 accumulation
    # (preferred_element_type) — casting the FULL cache to f32 first
    # materializes 2x the cache bytes per layer per token, which at decode
    # shapes is pure memory traffic. f32 inputs keep the exact f32 path.
    bf16_inputs = (
        q.dtype == jnp.bfloat16
        and k_cache.dtype == jnp.bfloat16
        and v_cache.dtype == jnp.bfloat16
    )
    qg = q.reshape(B, T, Hkv, G, D)
    if not bf16_inputs:
        qg = qg.astype(jnp.float32)
        k_cache = k_cache.astype(jnp.float32)
        v_cache = v_cache.astype(jnp.float32)

    # scores: (B, T, Hkv, G, S), f32 accumulation either way
    scores = _einsum(
        "bthgd,bshd->bthgs", qg, k_cache, preferred_element_type=jnp.float32
    ) * scale

    scores = _causal_mask(scores, q_positions, S, kv_lengths)

    att = jax.nn.softmax(scores, axis=-1)
    if bf16_inputs:
        att = att.astype(jnp.bfloat16)
    out = _einsum(
        "bthgs,bshd->bthgd", att, v_cache, preferred_element_type=jnp.float32
    )
    return out.reshape(B, T, H, D).astype(q.dtype)


def _quantkv_to_4d(kv, head_dim: int):
    """Flat QuantKV (q (B,S,Hkv*D), s (B,Hkv,S)) -> 4D layout view."""
    from tpu_llm.ops.kv_cache import QuantKV

    B, S, HkvD = kv.q.shape
    hkv = HkvD // head_dim
    return QuantKV(
        q=kv.q.reshape(B, S, hkv, head_dim),
        s=jnp.swapaxes(kv.s, 1, 2),
    )


def _block_diag_q(q, Hkv: int, dtype):
    """(B, T, H, D) -> (B, T, H, Hkv*D) with row h zero outside kv head
    h // G's D columns: one full-width contraction against a FLAT cache
    plane replaces the per-group einsum (same math — the zero columns
    contribute exact zeros)."""
    B, T, H, D = q.shape
    G = H // Hkv
    col_head = jnp.arange(Hkv * D, dtype=jnp.int32) // D        # (Hkv*D,)
    row_head = jnp.arange(H, dtype=jnp.int32) // G              # (H,)
    diag = row_head[:, None] == col_head[None, :]               # (H, Hkv*D)
    q_tiled = jnp.concatenate([q.astype(dtype)] * Hkv, axis=-1)
    return jnp.where(diag[None, None], q_tiled, jnp.zeros((), dtype))


def _pick_own_block(full, Hkv: int, G: int):
    """(B, T, H, Hkv*D) AV output -> (B, T, H, D): row h keeps kv head
    h // G's D-column block (small array; reshape+einsum selection)."""
    B, T, H, HkvD = full.shape
    D = HkvD // Hkv
    sel = (jnp.arange(H, dtype=jnp.int32)[:, None] // G
           == jnp.arange(Hkv, dtype=jnp.int32)[None, :])
    return _einsum(
        "bthkd,hk->bthd", full.reshape(B, T, H, Hkv, D),
        sel.astype(full.dtype), preferred_element_type=jnp.float32,
    )


def _gqa_attention_flat(q, k_cache, v_cache, q_positions, kv_lengths):
    """Dense attention against FLAT (B, S, Hkv*D) cache planes.

    The contraction runs over the full Hkv*D axis with a block-diagonal
    q (exact — zero columns add zeros), trading Hkv x more MACs
    (trivial at decode shapes) for a cache layout whose updates are
    in-place (see update_kv_cache)."""
    B, T, H, D = q.shape
    S, HkvD = k_cache.shape[1], k_cache.shape[2]
    Hkv = HkvD // D
    G = H // Hkv
    scale = 1.0 / jnp.sqrt(jnp.float32(D))

    bf16_inputs = (
        q.dtype == jnp.bfloat16
        and k_cache.dtype == jnp.bfloat16
        and v_cache.dtype == jnp.bfloat16
    )
    cdt = jnp.bfloat16 if bf16_inputs else jnp.float32
    if not bf16_inputs:
        k_cache = k_cache.astype(jnp.float32)
        v_cache = v_cache.astype(jnp.float32)
    qbd = _block_diag_q(q, Hkv, cdt)

    scores = _einsum(
        "bthc,bsc->bths", qbd, k_cache, preferred_element_type=jnp.float32
    ) * scale                                             # (B, T, H, S)

    scores = _causal_mask(scores, q_positions, S, kv_lengths)

    att = jax.nn.softmax(scores, axis=-1)
    full = _einsum(
        "bths,bsc->bthc", att.astype(cdt), v_cache,
        preferred_element_type=jnp.float32,
    )                                                     # (B, T, H, Hkv*D)
    return _pick_own_block(full, Hkv, G).astype(q.dtype)


def _gqa_attention_int8_flat(q, k_cache, v_cache, q_positions, kv_lengths):
    """int8 attention against flat QuantKV planes (q (B,S,Hkv*D) int8,
    kv-head-major scales s (B,Hkv,S) f32 — see QuantKV.zeros(flat=True)):
    block-diag contraction as _gqa_attention_flat, with
    the per-(token, head) K scale applied to the score matrix and the V
    scale folded into the attention weights."""
    B, T, H, D = q.shape
    S, HkvD = k_cache.q.shape[1], k_cache.q.shape[2]
    Hkv = HkvD // D
    G = H // Hkv
    scale = 1.0 / jnp.sqrt(jnp.float32(D))

    cdt = jnp.bfloat16 if q.dtype == jnp.bfloat16 else jnp.float32
    qbd = _block_diag_q(q, Hkv, cdt)
    scores = _einsum(
        "bthc,bsc->bths", qbd, k_cache.q.astype(cdt),
        preferred_element_type=jnp.float32,
    )
    # scales are stored kv-head-major (B, Hkv, S): repeat each kv head G
    # times for the per-query-head (B, H, S) factor — no transpose
    def head_scales(s3):
        return jnp.repeat(s3, G, axis=1)                     # (B, H, S)

    scores = scores * (head_scales(k_cache.s) * scale)[:, None]

    scores = _causal_mask(scores, q_positions, S, kv_lengths)

    att = jax.nn.softmax(scores, axis=-1)
    att = att * head_scales(v_cache.s)[:, None]
    full = _einsum(
        "bths,bsc->bthc", att.astype(cdt), v_cache.q.astype(cdt),
        preferred_element_type=jnp.float32,
    )
    return _pick_own_block(full, Hkv, G).astype(q.dtype)


def _causal_mask(scores, q_positions, S, kv_lengths):
    """Mask ``scores`` (B, T, <head axes...>, S) to slots s <= q_position
    (and s < kv_length per row). Head-axis count inferred from ndim."""
    if q_positions.ndim == 1:
        q_positions = q_positions[None, :]
    s_idx = jnp.arange(S, dtype=jnp.int32)
    mask = s_idx[None, None, :] <= q_positions[:, :, None]  # (B, T, S)
    if kv_lengths is not None:
        mask = mask & (s_idx[None, None, :] < kv_lengths[:, None, None])
    expand = (slice(None), slice(None)) + (None,) * (scores.ndim - 3)
    return jnp.where(mask[expand + (slice(None),)], scores, _NEG_INF)


def _gqa_attention_int8(q, k_cache, v_cache, q_positions, kv_lengths):
    B, T, H, D = q.shape
    S, Hkv = k_cache.q.shape[1], k_cache.q.shape[2]
    G = H // Hkv
    scale = 1.0 / jnp.sqrt(jnp.float32(D))

    cdt = jnp.bfloat16 if q.dtype == jnp.bfloat16 else jnp.float32
    qg = q.reshape(B, T, Hkv, G, D).astype(cdt)
    # QK in the compute dtype (int8->cdt widening fuses into the operand
    # read); per-(s, h) K scale applied to the score MATRIX, not the cache
    scores = _einsum(
        "bthgd,bshd->bthgs", qg, k_cache.q.astype(cdt),
        preferred_element_type=jnp.float32,
    )
    scores = scores * (k_cache.s * scale)[:, None, :, None, :].transpose(
        0, 1, 4, 3, 2)  # (B, S, Hkv) -> (B, 1, Hkv, 1, S)

    scores = _causal_mask(scores, q_positions, S, kv_lengths)
    att = jax.nn.softmax(scores, axis=-1)
    # fold the V scale into the attention weights before the AV dot
    att = att * v_cache.s[:, None, :, None, :].transpose(0, 1, 4, 3, 2)
    out = _einsum(
        "bthgs,bshd->bthgd", att.astype(cdt), v_cache.q.astype(cdt),
        preferred_element_type=jnp.float32,
    )
    return out.reshape(B, T, H, D).astype(q.dtype)
