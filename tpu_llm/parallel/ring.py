"""Ring attention — context parallelism (CP) over a sequence-sharded KV cache.

The reference holds the whole KV cache as one dense local array and scans
it per head (``llama2.f90:311-313, 578-594``), hard-capping context at one
memory's worth. Here the cache is sharded along the SEQUENCE axis of a
device mesh; each device keeps a fixed KV shard and the shards rotate
around the ring with ``jax.lax.ppermute`` while every device accumulates
attention for its resident queries blockwise (flash-style running max /
denominator, so the full score matrix never materializes). Per-device KV
stays O(S / n_devices) — the SURVEY §2.3 CP row.

Causality is enforced by ABSOLUTE positions carried with each rotating KV
block (kv_pos <= q_pos), so the math is identical to the dense masked
softmax in ``tpu_llm.ops.attention.gqa_attention``.

Known inefficiency, by design for now: every device computes all
ring steps even when a KV block is entirely in its causal future
(fully masked). Striped/zig-zag sequence placement balances that load;
documented here as the follow-up optimization.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_NEG_INF = -0.7 * float(jnp.finfo(jnp.float32).max)


def ring_gqa_attention(
    q: jax.Array,        # (B, Tq, H, D)   local queries
    k: jax.Array,        # (B, Sl, Hkv, D) local KV shard (rotates)
    v: jax.Array,        # (B, Sl, Hkv, D)
    q_pos: jax.Array,    # (Tq,) absolute positions of local q rows
    kv_pos: jax.Array,   # (Sl,) absolute positions of the local KV slots
    axis_name: str,
) -> jax.Array:
    """Blockwise-softmax GQA attention with the KV shard ring-rotated over
    ``axis_name``. Must run inside shard_map over that axis. Returns the
    local attention output (B, Tq, H, D)."""
    n = jax.lax.psum(1, axis_name)
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / jnp.sqrt(jnp.float32(D))

    qf = q.astype(jnp.float32).reshape(B, Tq, Hkv, G, D)
    m = jnp.full((B, Tq, Hkv, G), _NEG_INF, jnp.float32)   # running max
    l = jnp.zeros((B, Tq, Hkv, G), jnp.float32)            # running denom
    acc = jnp.zeros((B, Tq, Hkv, G, D), jnp.float32)

    perm = [(j, (j + 1) % n) for j in range(n)]

    def body(_, carry):
        m, l, acc, k, v, kv_pos = carry
        kf = k.astype(jnp.float32)
        vf = v.astype(jnp.float32)
        scores = jnp.einsum("bthgd,bshd->bthgs", qf, kf) * scale
        mask = kv_pos[None, :] <= q_pos[:, None]            # (Tq, Sl)
        scores = jnp.where(mask[None, :, None, None, :], scores, _NEG_INF)

        m_new = jnp.maximum(m, jnp.max(scores, axis=-1))
        p = jnp.exp(scores - m_new[..., None])
        alpha = jnp.exp(m - m_new)
        l = l * alpha + jnp.sum(p, axis=-1)
        acc = acc * alpha[..., None] + jnp.einsum("bthgs,bshd->bthgd", p, vf)

        k = jax.lax.ppermute(k, axis_name, perm)
        v = jax.lax.ppermute(v, axis_name, perm)
        kv_pos = jax.lax.ppermute(kv_pos, axis_name, perm)
        return m_new, l, acc, k, v, kv_pos

    m, l, acc, *_ = jax.lax.fori_loop(0, n, body, (m, l, acc, k, v, kv_pos))
    out = acc / jnp.maximum(l, 1e-30)[..., None]
    return out.reshape(B, Tq, H, D).astype(q.dtype)


def prefill_context_parallel(
    params,
    cfg,
    tokens: jax.Array,     # (B, T) — T divisible by the seq-axis size
    cache,                 # llama KV cache (L, B, S, Hkv, D) with S == T
    mesh: Mesh,
    data_axis: str = "data",
    seq_axis: str = "model",
) -> Tuple[jax.Array, dict]:
    """Context-parallel llama prefill: tokens and the KV cache sharded along
    sequence over ``seq_axis``; attention runs as ring attention. Returns
    (hidden (B, T, E), sequence-sharded cache), numerically identical to the
    single-device ``llama.forward`` prefill.

    Weights are replicated over ``seq_axis`` (CP composes with DP over
    ``data_axis``; combine with TP by nesting meshes later)."""
    from jax import shard_map

    from tpu_llm.models import llama as M

    n_seq = mesh.shape[seq_axis]
    B, T = tokens.shape
    if T % n_seq:
        raise ValueError(f"T={T} not divisible by seq axis {n_seq}")
    if cache["k"].shape[2] != T:
        raise ValueError("CP prefill expects cache S == T (prefill region)")

    tok_spec = P(data_axis, seq_axis)
    cache_spec = P(None, data_axis, seq_axis, None, None)
    out_spec = P(data_axis, seq_axis, None)

    def local_fn(params, tokens, cache):
        r = jax.lax.axis_index(seq_axis)
        Tl = tokens.shape[1]
        first = r * Tl                                   # abs pos of local row 0
        local_pos = first + jnp.arange(Tl, dtype=jnp.int32)

        def attn_fn(q, kc, vc, positions, offset):
            return ring_gqa_attention(q, kc, vc, local_pos, local_pos, seq_axis)

        hidden, cache = M.forward(
            params, cfg, tokens, cache, jnp.int32(first),
            attn_fn=attn_fn, kv_offset=jnp.int32(0),
        )
        return hidden, cache

    fn = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), tok_spec, {"k": cache_spec, "v": cache_spec}),
        out_specs=(out_spec, {"k": cache_spec, "v": cache_spec}),
        check_vma=False,
    )
    return fn(params, tokens, cache)


# -- sequence-sharded DECODE --------------------------------------------------

def cp_decode_attention(
    q: jax.Array,        # (B, 1, H, D) — replicated query
    k: jax.Array,        # (B, Sl, Hkv, D) resident local KV shard
    v: jax.Array,
    kv_pos: jax.Array,   # (Sl,) absolute positions of the local slots
    pos: jax.Array,      # scalar: the query's absolute position
    axis_name: str,
) -> jax.Array:
    """Distributed-softmax decode attention over a sequence-sharded cache.

    Unlike prefill, decode needs no ring: each device scores the query
    against its RESIDENT shard and the partial softmax states combine with
    two collectives (pmax of the score max, psum of numerator/denominator)
    — the split-K factorization of flash decoding
    (kernels/attention.py), lifted across devices. KV shards never move;
    per-device cache stays O(S / n_devices), removing the reference's
    single-memory context cap (llama2.f90:311-313)."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / jnp.sqrt(jnp.float32(D))

    qf = q.astype(jnp.float32).reshape(B, T, Hkv, G, D)
    scores = jnp.einsum("bthgd,bshd->bthgs", qf, k.astype(jnp.float32)) * scale
    mask = kv_pos <= pos                                   # (Sl,)
    scores = jnp.where(mask[None, None, None, None, :], scores, _NEG_INF)

    m = jax.lax.pmax(jnp.max(scores, axis=-1), axis_name)  # global max
    p = jnp.exp(scores - m[..., None])                     # masked -> exp(-inf)=0
    l = jax.lax.psum(jnp.sum(p, axis=-1), axis_name)
    acc = jax.lax.psum(
        jnp.einsum("bthgs,bshd->bthgd", p, v.astype(jnp.float32)), axis_name)
    out = acc / jnp.maximum(l, 1e-30)[..., None]
    return out.reshape(B, T, H, D).astype(q.dtype)


def decode_step_context_parallel(
    params,
    cfg,
    token: jax.Array,      # (B,) int32
    cache,                 # stacked llama cache (L, B, S, Hkv, D), S seq-sharded
    pos: jax.Array,        # scalar int32 absolute position
    mesh: Mesh,
    data_axis: str = "data",
    seq_axis: str = "model",
):
    """One decode step over a sequence-sharded KV cache. Returns
    (logits (B, V) f32, cache) — numerically matching the dense
    single-device decode step.

    Slot placement is contiguous: device r owns absolute positions
    [r*Sl, (r+1)*Sl). The new K/V row is written only by the owning
    device (masked select at the local offset); attention is the
    all-reduce softmax combine of ``cp_decode_attention``."""
    from jax import shard_map

    from tpu_llm.models import llama as M

    cache_spec = P(None, data_axis, seq_axis, None, None)
    tok_spec = P(data_axis)

    def local_fn(params, token, cache, pos):
        r = jax.lax.axis_index(seq_axis)
        Sl = cache["k"].shape[2]
        first = r * Sl
        kv_pos = first + jnp.arange(Sl, dtype=jnp.int32)

        def update_fn(kc, vc, k_new, v_new, offset):
            # ownership-masked write: only the device whose shard holds
            # ``offset`` commits the new row; others write back the old
            local_off = jnp.clip(offset - first, 0, Sl - 1)
            own = (offset >= first) & (offset < first + Sl)

            def masked(c, new):
                old = jax.lax.dynamic_slice_in_dim(c, local_off, 1, axis=1)
                row = jnp.where(own, new.astype(c.dtype), old)
                return jax.lax.dynamic_update_slice_in_dim(
                    c, row, local_off, axis=1)

            return masked(kc, k_new), masked(vc, v_new)

        def attn_fn(q, kc, vc, positions, offset):
            return cp_decode_attention(q, kc, vc, kv_pos, pos, seq_axis)

        hidden, cache = M.forward(
            params, cfg, token[:, None], cache, pos,
            attn_fn=attn_fn, update_fn=update_fn,
        )
        logits = M.lm_head(params, cfg, hidden)[:, 0, :]
        return logits, cache

    fn = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), tok_spec, {"k": cache_spec, "v": cache_spec}, P()),
        out_specs=(P(data_axis, None), {"k": cache_spec, "v": cache_spec}),
        check_vma=False,
    )
    return fn(params, token, cache, pos)
