"""Paged (blocked) KV cache.

The dense cache preallocates (B, max_seq, Hkv*D) per layer — every slot
pays for the longest context it might ever reach, which is exactly the
reference's hard cap generalized to a batch (``llama2.f90:311-313``). A
paged cache allocates fixed-size BLOCKS from a shared pool and maps each
sequence to its blocks through an int32 block table, so HBM scales with
tokens actually resident, sequences can grow past any per-slot
preallocation, and blocks can be shared (prefix caching) or migrated.

Layout:
- pool: (n_blocks, block_size, Hkv*D) per layer — a single-token write
  touches one contiguous (Hkv*D,) row in place.
- int8 pools carry scale pools (Hkv, n_blocks, block_size) f32: one scale
  per (token, kv-head) vector, head-major, the layout the GPU paged-decode
  kernel reads per kv head.
- block_table: (B, max_blocks) int32 into the pool; lengths: (B,) valid
  token counts. Device-side ops are pure gathers/scatters on static
  shapes; block ALLOCATION is host-side scheduling (``BlockAllocator``),
  exactly like slot scheduling in the batching engine.

Attention path: one-token decode on the GPU runs the library paged-decode
kernel (``tpu_llm.kernels.attention``), which reads pages through the
block table. Everywhere else the sequence's blocks are gathered to a
contiguous (B, max_blocks*block_size, Hkv*D) view and the standard masked
GQA attention runs with ``kv_lengths`` — table entries beyond a
sequence's length point at freed/garbage blocks, so the length mask (not
just causality) is load-bearing there.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from tpu_llm.ops.attention import gqa_attention


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PagedKV:
    """One layer's paged KV state (a pytree; flows through jit/scan).

    int8 pools (``k_scale``/``v_scale`` not None) store one f32 scale
    per (token, kv-head) vector in (Hkv, n_blocks, block_size) pools.
    Attention applies the scales to the score matrix, never
    dequantizing the plane — the same factorization as the flat dense
    QuantKV."""

    k_pool: jax.Array       # (n_blocks, block_size, Hkv*D)
    v_pool: jax.Array
    block_table: jax.Array  # (B, max_blocks) int32 pool indices
    lengths: jax.Array      # (B,) int32 valid token count per sequence
    k_scale: Optional[jax.Array] = None   # (Hkv, n_blocks, bs) f32
    v_scale: Optional[jax.Array] = None

    def tree_flatten(self):
        return (self.k_pool, self.v_pool, self.block_table, self.lengths,
                self.k_scale, self.v_scale), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def block_size(self) -> int:
        return self.k_pool.shape[1]

    @property
    def max_tokens(self) -> int:
        return self.block_table.shape[1] * self.block_size

    @classmethod
    def zeros(cls, n_blocks: int, block_size: int, batch: int,
              max_blocks: int, kv_dim: int, dtype=jnp.bfloat16,
              n_kv_heads: Optional[int] = None) -> "PagedKV":
        quant = dtype == "int8" or dtype == jnp.int8
        if quant:
            assert n_kv_heads, "int8 pools need n_kv_heads for scale planes"
        mk = lambda: jnp.zeros((n_blocks, block_size, kv_dim),
                               jnp.int8 if quant else dtype)
        sc = (lambda: jnp.zeros((n_kv_heads, n_blocks, block_size),
                                jnp.float32)) if quant else (lambda: None)
        return cls(
            k_pool=mk(), v_pool=mk(),
            block_table=jnp.zeros((batch, max_blocks), jnp.int32),
            lengths=jnp.zeros((batch,), jnp.int32),
            k_scale=sc(), v_scale=sc(),
        )


def paged_update(
    kv: PagedKV,
    k_new: jax.Array,     # (B, 1, Hkv, D) — decode-shaped single token
    v_new: jax.Array,
    positions: jax.Array,  # (B,) absolute write position per sequence
) -> PagedKV:
    """Write one token per sequence into its mapped block. Positions may
    differ per row (continuous batching). Updates ``lengths`` to
    max(lengths, position+1)."""
    B = k_new.shape[0]
    return paged_update_tokens(kv, k_new.reshape(B, 1, -1, k_new.shape[-1]),
                               v_new.reshape(B, 1, -1, v_new.shape[-1]),
                               positions)


def paged_update_tokens(
    kv: PagedKV,
    k_new: jax.Array,      # (B, T, Hkv, D)
    v_new: jax.Array,
    pos0: jax.Array,       # scalar or (B,) — absolute position of token 0
) -> PagedKV:
    """Write T consecutive tokens per sequence starting at ``pos0``
    (prefill / chunked prefill). Generalizes ``paged_update``: the write
    indices are (B, T) advanced-index pairs into the pool — one scatter,
    no per-token loop. Positions whose block-table entry is the null
    block (0) land in the trash block: padded prefill tails write
    garbage there by design, and causal masking keeps every position
    > q_pos invisible until a real block is mapped and rewritten."""
    B, T = k_new.shape[0], k_new.shape[1]
    bs = kv.block_size
    kvd = kv.k_pool.shape[-1]
    pos0 = jnp.asarray(pos0, jnp.int32)
    if pos0.ndim == 0:
        pos0 = jnp.full((B,), pos0, jnp.int32)
    positions = pos0[:, None] + jnp.arange(T, dtype=jnp.int32)[None, :]  # (B, T)
    MB = kv.block_table.shape[1]
    block_idx = positions // bs
    block_ids = jnp.take_along_axis(
        kv.block_table, jnp.clip(block_idx, 0, MB - 1), axis=1)  # (B, T)
    # positions past the table go to the NULL block, never the clipped
    # last column — a fully-mapped table would otherwise let padded
    # prefill tails scatter garbage over real rows (and the scatter's
    # duplicate indices make the winner nondeterministic)
    block_ids = jnp.where(block_idx < MB, block_ids, 0)
    offs = positions % bs
    lengths = jnp.maximum(kv.lengths, positions[:, -1] + 1)

    if kv.quantized:
        from tpu_llm.ops.kv_cache import quantize_kv

        kq, ks = quantize_kv(k_new)          # (B,T,Hkv,D) int8, (B,T,Hkv)
        vq, vs = quantize_kv(v_new)
        heads = jnp.arange(k_new.shape[2], dtype=jnp.int32)
        at = (heads, block_ids[..., None], offs[..., None])   # (B, T, Hkv)
        return PagedKV(
            kv.k_pool.at[block_ids, offs].set(kq.reshape(B, T, kvd)),
            kv.v_pool.at[block_ids, offs].set(vq.reshape(B, T, kvd)),
            kv.block_table, lengths,
            kv.k_scale.at[at].set(ks),
            kv.v_scale.at[at].set(vs),
        )

    kf = k_new.reshape(B, T, kvd).astype(kv.k_pool.dtype)
    vf = v_new.reshape(B, T, kvd).astype(kv.v_pool.dtype)
    k_pool = kv.k_pool.at[block_ids, offs].set(kf)
    v_pool = kv.v_pool.at[block_ids, offs].set(vf)
    return PagedKV(k_pool, v_pool, kv.block_table, lengths)


def paged_gather(kv: PagedKV):
    """Materialize each sequence's logical KV view:
    (B, max_blocks*block_size, Hkv*D) — for int8 pools, a flat-layout
    QuantKV pair (scales gathered to kv-head-major (B, Hkv, MB*bs)).
    Entries past ``lengths`` are whatever the mapped (possibly garbage)
    blocks hold — callers MUST mask with ``lengths``."""
    k = jnp.take(kv.k_pool, kv.block_table, axis=0)   # (B, MB, bs, kvd)
    v = jnp.take(kv.v_pool, kv.block_table, axis=0)
    B, MB, bs, kvd = k.shape
    k, v = k.reshape(B, MB * bs, kvd), v.reshape(B, MB * bs, kvd)
    if not kv.quantized:
        return k, v
    from tpu_llm.ops.kv_cache import QuantKV

    def scales(pool):                                  # (Hkv, N, bs)
        s = jnp.take(pool, kv.block_table, axis=1)     # (Hkv, B, MB, bs)
        return s.transpose(1, 0, 2, 3).reshape(B, -1, MB * bs)

    return (QuantKV(q=k, s=scales(kv.k_scale)),
            QuantKV(q=v, s=scales(kv.v_scale)))


def paged_gqa_attention(
    q: jax.Array,          # (B, T, H, D)
    kv: PagedKV,
    q_positions: jax.Array,  # (T,) or (B, T) absolute positions of the queries
    offset=None,            # scalar when all rows share a position (prefill)
) -> jax.Array:
    """Attention over the paged cache.

    One-token decode on the GPU runs the library paged-decode kernel
    (``kernels.select`` decides): pages are read through the block table,
    O(pos) bytes per row, no materialized gather. Otherwise the blocks are
    gathered to the flat logical view and the standard masked GQA
    attention runs; ``kv_lengths`` keeps garbage blocks invisible, and
    long prefill from position 0 takes cuDNN flash attention."""
    from tpu_llm.kernels import attention as gpu_attention
    from tpu_llm.kernels import select

    B, T, H, D = q.shape
    if select.paged_decode_attention(q, kv):
        pos = jnp.broadcast_to(q_positions.reshape(-1), (B,))
        return gpu_attention.paged_decode_attention(
            q, kv.k_pool, kv.v_pool, kv.block_table, pos,
            kv.k_scale, kv.v_scale)

    k, v = paged_gather(kv)
    # causal masking makes the lengths mask redundant for prefill from
    # position 0: every attended slot <= q_pos was written by this call
    if offset is not None and select.prefill_attention(q, k, offset):
        return gpu_attention.prefill_attention(q, k, v)
    if kv.quantized:
        # flat QuantKV pair — gqa_attention's int8 paths contract the
        # int8 plane directly with scales on the score matrix
        return gqa_attention(q, k, v, q_positions, kv_lengths=kv.lengths)
    S, kvd = k.shape[1], k.shape[2]
    k = k.reshape(B, S, kvd // D, D)
    v = v.reshape(B, S, kvd // D, D)
    return gqa_attention(q, k, v, q_positions, kv_lengths=kv.lengths)


class BlockAllocator:
    """Host-side refcounted free-list allocator over the shared pool
    (serving-side scheduling, like slot admission in the batching
    engine). Block 0 is reserved as the null block every table entry
    starts pointing at. Blocks are shared by reference count (prefix
    caching maps one physical block into many sequences' tables);
    ``release``/``decref`` frees a block only when its last reference
    drops."""

    def __init__(self, n_blocks: int):
        self.free: List[int] = list(range(n_blocks - 1, 0, -1))
        self.refs: Dict[int, int] = {}
        # blocks promised to admitted requests' future decode growth
        # (admission reserves worst-case prompt+max_new so growth can
        # never fail mid-decode — a paged request is all-or-nothing)
        self.n_reserved = 0
        # called with the shortfall when alloc() runs dry; returns how
        # many blocks it could liberate (PrefixCache.evict hooks here)
        self.reclaim: Optional[Callable[[int], int]] = None

    @property
    def n_free(self) -> int:
        return len(self.free)

    def _ensure(self, n: int) -> None:
        """Make n UNRESERVED free blocks available (reclaiming cached
        blocks if needed) or raise."""
        short = n - (len(self.free) - self.n_reserved)
        if short > 0 and self.reclaim is not None:
            self.reclaim(short)
        if n > len(self.free) - self.n_reserved:
            raise MemoryError(
                f"paged KV pool exhausted ({n} needed, "
                f"{len(self.free)} free - {self.n_reserved} reserved)")

    def alloc(self, n: int = 1, *, reserved: bool = False) -> List[int]:
        """Allocate n blocks. ``reserved=True`` draws down an existing
        reservation (decode growth); otherwise only unreserved free
        blocks are eligible."""
        if reserved:
            assert n <= self.n_reserved <= len(self.free), "reservation bug"
            self.n_reserved -= n
        else:
            self._ensure(n)
        out = [self.free.pop() for _ in range(n)]
        for b in out:
            self.refs[b] = 1
        return out

    def reserve(self, n: int) -> None:
        self._ensure(n)
        self.n_reserved += n

    def unreserve(self, n: int) -> None:
        assert n <= self.n_reserved
        self.n_reserved -= n

    def incref(self, block: int) -> None:
        self.refs[block] += 1

    def decref(self, block: int) -> None:
        if block == 0:
            return
        self.refs[block] -= 1
        if self.refs[block] == 0:
            del self.refs[block]
            self.free.append(block)

    def release(self, blocks) -> None:
        for b in blocks:
            self.decref(int(b))


class PrefixCache:
    """Prompt prefix cache over full KV blocks (vLLM-style automatic
    prefix caching, generalizing the reference's single-stream prompt
    processing — llama2.f90:382-385 recomputes every prompt token every
    run; here a repeated prefix costs zero prefill compute or HBM).

    A block's identity is the hash CHAIN of all token ids from sequence
    start through that block (RoPE bakes absolute positions into K, so
    content-only hashing would alias). Registered blocks hold one cache
    reference so they survive their owner's completion; when the pool
    runs dry the allocator reclaims least-recently-matched entries whose
    only remaining reference is the cache's."""

    def __init__(self, allocator: BlockAllocator):
        self.alloc = allocator
        self._map: "OrderedDict[bytes, int]" = OrderedDict()   # digest -> block
        self._rev: Dict[int, bytes] = {}
        allocator.reclaim = self.evict
        # observability: admission-time reuse (hits = blocks served from
        # cache; queries = full blocks eligible for matching)
        self.hits = 0
        self.queries = 0
        self.evictions = 0

    @staticmethod
    def digests(tokens: List[int], block_size: int) -> List[bytes]:
        """Chained digest per FULL block of ``tokens``."""
        out, h = [], hashlib.sha1()
        for start in range(0, (len(tokens) // block_size) * block_size,
                           block_size):
            h.update(b"".join(
                int(t).to_bytes(4, "little", signed=True)
                for t in tokens[start : start + block_size]))
            out.append(h.digest())
        return out

    def match(self, tokens: List[int], block_size: int,
              digests: Optional[List[bytes]] = None) -> List[int]:
        """Longest cached prefix: block ids for leading full blocks whose
        chained digests hit. Increfs every returned block (caller owns
        the references). Capped at len(tokens)-1 tokens so admission
        always has >= 1 tail token to forward (the first sampled token
        needs the last prompt token's logits)."""
        hits: List[int] = []
        max_blocks = (len(tokens) - 1) // block_size
        self.queries += max_blocks
        if digests is None:
            digests = self.digests(tokens, block_size)
        for d in digests[:max_blocks]:
            bid = self._map.get(d)
            if bid is None:
                break
            self.alloc.incref(bid)
            self._map.move_to_end(d)          # LRU touch
            hits.append(bid)
        self.hits += len(hits)
        return hits

    def insert(self, tokens: List[int], block_size: int,
               blocks: List[int],
               digests: Optional[List[bytes]] = None) -> None:
        """Register ``blocks`` (the sequence's mapped blocks, in order)
        under the prompt's chained digests. Already-registered digests
        are skipped; newly registered blocks gain one cache reference."""
        if digests is None:
            digests = self.digests(tokens, block_size)
        for d, bid in zip(digests, blocks):
            if d in self._map or bid in self._rev or bid == 0:
                continue
            self.alloc.incref(bid)
            self._map[d] = bid
            self._rev[bid] = d

    def evict(self, n: int) -> int:
        """Drop up to ``n`` least-recently-matched entries whose only
        live reference is the cache's own (refcount 1 — no sequence is
        mapped to them). Returns the number actually freed."""
        victims = [d for d, bid in self._map.items()
                   if self.alloc.refs.get(bid) == 1][:n]
        for d in victims:
            bid = self._map.pop(d)
            del self._rev[bid]
            self.alloc.decref(bid)
        self.evictions += len(victims)
        return len(victims)
