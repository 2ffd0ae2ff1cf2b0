"""Paged KV cache (tpu_llm.ops.paged_kv): update/gather round trips,
decode-attention parity with the dense cache, garbage-block isolation via
kv_lengths (its load-bearing caller), and the host-side allocator."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_llm.ops.attention import gqa_attention, update_kv_cache
from tpu_llm.ops.paged_kv import (
    BlockAllocator, PagedKV, paged_gather, paged_gqa_attention, paged_update,
)


def build(B=2, n_blocks=16, bs=4, max_blocks=4, Hkv=2, D=8, dtype=jnp.float32):
    kv = PagedKV.zeros(n_blocks, bs, B, max_blocks, Hkv * D, dtype)
    # map each row to its own distinct blocks (like an allocator would)
    table = np.zeros((B, max_blocks), np.int32)
    alloc = BlockAllocator(n_blocks)
    for b in range(B):
        table[b] = alloc.alloc(max_blocks)
    return PagedKV(kv.k_pool, kv.v_pool, jnp.asarray(table), kv.lengths), alloc


def test_update_gather_roundtrip():
    rng = np.random.default_rng(0)
    kv, _ = build()
    Hkv, D = 2, 8
    writes = {}
    for pos in [0, 1, 3, 4, 5, 11]:       # crosses block boundaries
        k = jnp.asarray(rng.standard_normal((2, 1, Hkv, D)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((2, 1, Hkv, D)), jnp.float32)
        kv = paged_update(kv, k, v, jnp.full((2,), pos, jnp.int32))
        writes[pos] = (np.asarray(k), np.asarray(v))
    kflat, vflat = paged_gather(kv)
    kflat = np.asarray(kflat).reshape(2, -1, Hkv, D)
    for pos, (k, v) in writes.items():
        np.testing.assert_allclose(kflat[:, pos], k[:, 0], rtol=1e-6)
    assert np.asarray(kv.lengths).tolist() == [12, 12]


def test_per_row_positions():
    rng = np.random.default_rng(1)
    kv, _ = build()
    k = jnp.asarray(rng.standard_normal((2, 1, 2, 8)), jnp.float32)
    kv = paged_update(kv, k, k, jnp.asarray([2, 9], jnp.int32))
    kflat, _ = paged_gather(kv)
    kflat = np.asarray(kflat).reshape(2, -1, 2, 8)
    np.testing.assert_allclose(kflat[0, 2], np.asarray(k)[0, 0], rtol=1e-6)
    np.testing.assert_allclose(kflat[1, 9], np.asarray(k)[1, 0], rtol=1e-6)
    assert np.asarray(kv.lengths).tolist() == [3, 10]


def test_paged_attention_matches_dense():
    """Fill both a dense and a paged cache with the same tokens; decode
    attention must agree."""
    rng = np.random.default_rng(2)
    B, Hkv, D, H = 2, 2, 8, 4
    S = 16
    kv, _ = build(B=B, Hkv=Hkv, D=D)
    dense_k = jnp.zeros((B, S, Hkv, D))
    dense_v = jnp.zeros((B, S, Hkv, D))
    n_ctx = 7
    for pos in range(n_ctx):
        k = jnp.asarray(rng.standard_normal((B, 1, Hkv, D)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((B, 1, Hkv, D)), jnp.float32)
        kv = paged_update(kv, k, v, jnp.full((B,), pos, jnp.int32))
        dense_k, dense_v = update_kv_cache(dense_k, dense_v, k, v,
                                           jnp.int32(pos))

    q = jnp.asarray(rng.standard_normal((B, 1, H, D)), jnp.float32)
    q_pos = jnp.full((B, 1), n_ctx - 1, jnp.int32)
    ref = gqa_attention(q, dense_k, dense_v, q_pos)
    got = paged_gqa_attention(q, kv, q_pos)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_garbage_blocks_masked_by_lengths():
    """Poison the pool beyond each sequence's length: attention must not
    change (kv_lengths isolation — causality alone would NOT mask a
    stale block mapped at a position <= q_pos after table reuse)."""
    rng = np.random.default_rng(3)
    B, Hkv, D, H = 2, 2, 8, 4
    kv, _ = build(B=B, Hkv=Hkv, D=D)
    for pos in range(5):
        k = jnp.asarray(rng.standard_normal((B, 1, Hkv, D)), jnp.float32)
        kv = paged_update(kv, k, k, jnp.full((B,), pos, jnp.int32))
    q = jnp.asarray(rng.standard_normal((B, 1, H, D)), jnp.float32)
    # q claims a position far past the valid extent: only lengths protect
    q_pos = jnp.full((B, 1), 15, jnp.int32)
    base = np.asarray(paged_gqa_attention(q, kv, q_pos))

    # valid region: block 0 fully (bs=4) + block 1 offset 0 (lengths=5).
    # poison everything beyond: block 1 offsets 1.., blocks 2..3 entirely.
    table = np.asarray(kv.block_table)
    tail_blocks = jnp.asarray(table[:, 2:].ravel())
    mid_blocks = jnp.asarray(table[:, 1])
    k_pool = kv.k_pool.at[tail_blocks].add(1e3)
    k_pool = k_pool.at[mid_blocks, 1:].add(1e3)
    v_pool = kv.v_pool.at[tail_blocks].add(1e3)
    v_pool = v_pool.at[mid_blocks, 1:].add(1e3)
    poisoned = PagedKV(k_pool=k_pool, v_pool=v_pool,
                       block_table=kv.block_table, lengths=kv.lengths)
    got = np.asarray(paged_gqa_attention(q, poisoned, q_pos))
    np.testing.assert_allclose(got, base, rtol=1e-5, atol=1e-5)


def test_allocator_free_list():
    a = BlockAllocator(8)
    assert a.n_free == 7                  # block 0 reserved
    blocks = a.alloc(3)
    assert len(set(blocks)) == 3 and 0 not in blocks
    a.release(blocks)
    assert a.n_free == 7
    with pytest.raises(MemoryError):
        a.alloc(8)


def _paged_kernel(q, kv, pos):
    """The GPU paged-decode kernel (kernels.attention), interpret mode."""
    from tpu_llm.kernels.attention import paged_decode_attention

    return paged_decode_attention(q, kv.k_pool, kv.v_pool, kv.block_table,
                                  pos, kv.k_scale, kv.v_scale,
                                  interpret=True)


@pytest.mark.parametrize("positions", [[0, 5], [7, 31], [16, 3], [63, 48]])
def test_paged_flash_decode_matches_gather(positions):
    """Paged decode kernel (interpret mode) == gather + masked einsum
    attention, per-row positions, partially-filled blocks."""
    from tpu_llm.ops.attention import gqa_attention
    from tpu_llm.ops.paged_kv import PagedKV, paged_gather

    B, H, Hkv, D, bs, MB = 2, 8, 2, 64, 16, 4
    N = 1 + B * MB
    rng = np.random.default_rng(sum(positions))
    k_pool = jnp.asarray(rng.standard_normal((N, bs, Hkv * D)), jnp.bfloat16)
    v_pool = jnp.asarray(rng.standard_normal((N, bs, Hkv * D)), jnp.bfloat16)
    # each row gets its own distinct (shuffled) blocks
    ids = rng.permutation(np.arange(1, N)).reshape(B, MB).astype(np.int32)
    table = jnp.asarray(ids)
    pos = jnp.asarray(positions, jnp.int32)
    q = jnp.asarray(rng.standard_normal((B, 1, H, D)), jnp.bfloat16)

    kv = PagedKV(k_pool, v_pool, table, pos + 1)
    kg, vg = paged_gather(kv)
    S = kg.shape[1]
    f32 = lambda a: a.astype(jnp.float32)  # noqa: E731
    expected = gqa_attention(
        f32(q), f32(kg).reshape(B, S, Hkv, D), f32(vg).reshape(B, S, Hkv, D),
        pos[:, None], kv_lengths=pos + 1)

    got = _paged_kernel(q, kv, pos)
    # bf16 probabilities in the p.v product: ~2^-8 relative
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(expected), rtol=2e-2, atol=2e-2)


def test_paged_flash_decode_skips_unmapped_blocks():
    """Blocks past pos are never read: poison them (including table
    entries pointing at the null block) — output unchanged."""
    from tpu_llm.ops.paged_kv import PagedKV

    B, H, Hkv, D, bs, MB = 1, 4, 2, 64, 16, 4
    rng = np.random.default_rng(0)
    k_pool = jnp.asarray(rng.standard_normal((6, bs, Hkv * D)), jnp.bfloat16)
    v_pool = jnp.asarray(rng.standard_normal((6, bs, Hkv * D)), jnp.bfloat16)
    table = jnp.asarray([[1, 2, 0, 0]], jnp.int32)   # only 2 mapped blocks
    pos = jnp.asarray([bs + 11], jnp.int32)          # inside block 1
    q = jnp.asarray(rng.standard_normal((B, 1, H, D)), jnp.bfloat16)

    base = _paged_kernel(q, PagedKV(k_pool, v_pool, table, pos + 1), pos)
    # poison the null block and every unmapped pool block
    poison = jnp.asarray([0, 3, 4, 5])
    got = _paged_kernel(q, PagedKV(k_pool.at[poison].add(1e3),
                                   v_pool.at[poison].add(1e3), table,
                                   pos + 1), pos)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(base))


def _int8_paged(rng, B, Hkv, D, bs, MB, upto):
    """An int8 PagedKV written token by token through paged_update_tokens
    up to position ``upto`` for every row."""
    from tpu_llm.ops.paged_kv import PagedKV, paged_update_tokens

    N = 1 + B * MB
    kv = PagedKV.zeros(n_blocks=N, block_size=bs, batch=B, max_blocks=MB,
                       kv_dim=Hkv * D, dtype="int8", n_kv_heads=Hkv)
    ids = rng.permutation(np.arange(1, N)).reshape(B, MB).astype(np.int32)
    kv = PagedKV(kv.k_pool, kv.v_pool, jnp.asarray(ids), kv.lengths,
                 kv.k_scale, kv.v_scale)
    for p in range(upto + 1):
        k = jnp.asarray(rng.standard_normal((B, 1, Hkv, D)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((B, 1, Hkv, D)), jnp.float32)
        kv = paged_update_tokens(kv, k, v, jnp.full((B,), p, jnp.int32))
    return kv


@pytest.mark.parametrize("positions", [[0, 40], [70, 95]])
def test_paged_flash_decode_q_matches_gather(positions):
    """int8-pool paged decode kernel (interpret) == gather + int8 einsum
    attention (same score-matrix scale factorization)."""
    from tpu_llm.ops.paged_kv import PagedKV, paged_gqa_attention

    B, H, Hkv, D, bs, MB = 2, 8, 2, 64, 32, 4
    rng = np.random.default_rng(positions[0])
    kv = _int8_paged(rng, B, Hkv, D, bs, MB, max(positions))
    pos = jnp.asarray(positions, jnp.int32)
    kv = PagedKV(kv.k_pool, kv.v_pool, kv.block_table, pos + 1,
                 kv.k_scale, kv.v_scale)
    q = jnp.asarray(rng.standard_normal((B, 1, H, D)), jnp.bfloat16)

    expected = paged_gqa_attention(q.astype(jnp.float32), kv,
                                   pos[:, None])   # CPU gather path
    got = _paged_kernel(q, kv, pos)
    # bf16 q in the q.k product vs the gather path's f32
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(expected), rtol=2e-2, atol=2e-2)


def test_out_of_table_writes_go_to_null_block():
    """Writes past the block table land in the null block, NOT the
    clipped last column (review r2: a fully-mapped table would let padded
    prefill tails scatter garbage over real rows)."""
    from tpu_llm.ops.paged_kv import PagedKV, paged_update_tokens

    B, Hkv, D, bs, MB = 1, 2, 4, 2, 2
    kvd = Hkv * D
    kv = PagedKV.zeros(n_blocks=4, block_size=bs, batch=B, max_blocks=MB,
                       kv_dim=kvd, dtype=jnp.float32)
    table = jnp.asarray([[1, 2]], jnp.int32)       # fully mapped
    kv = PagedKV(kv.k_pool, kv.v_pool, table, kv.lengths)
    # write real rows 0..3 (fills both blocks)
    rng = np.random.default_rng(0)
    k = jnp.asarray(rng.standard_normal((B, 4, Hkv, D)), jnp.float32)
    kv = paged_update_tokens(kv, k, k, jnp.asarray([0], jnp.int32))
    snap = np.asarray(kv.k_pool).copy()
    # padded write at positions 2..5: 4..5 are PAST the table
    pad = jnp.full((B, 4, Hkv, D), 99.0, jnp.float32)
    kv2 = paged_update_tokens(kv, pad, pad, jnp.asarray([2], jnp.int32))
    # real blocks: rows 2..3 legitimately overwritten, nothing else
    np.testing.assert_allclose(np.asarray(kv2.k_pool)[1], snap[1])  # block 1 untouched
    np.testing.assert_allclose(np.asarray(kv2.k_pool)[2], 99.0)     # rows 2..3
    assert (np.asarray(kv2.k_pool)[3] == 0).all()   # unmapped block untouched


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("contiguous", [True, False])
def test_paged_decode_kernel_block_placement(contiguous, quantized):
    """The kernel reads pages through the block table only: the same
    logical cache placed in consecutive blocks or in shuffled ones gives
    the same output, bf16 and int8 pools alike."""
    from tpu_llm.ops.paged_kv import PagedKV

    B, H, Hkv, D, bs, MB = 2, 8, 2, 64, 32, 4
    N = 1 + B * MB
    rng = np.random.default_rng(11 + contiguous + 2 * quantized)
    if quantized:
        kv = _int8_paged(rng, B, Hkv, D, bs, MB, bs * MB - 1)
    else:
        mk = lambda: jnp.asarray(  # noqa: E731
            rng.standard_normal((N, bs, Hkv * D)), jnp.bfloat16)
        ids = rng.permutation(np.arange(1, N)).reshape(B, MB)
        kv = PagedKV(mk(), mk(), jnp.asarray(ids, jnp.int32),
                     jnp.zeros((B,), jnp.int32))
    pos = jnp.asarray([bs * MB - 2, bs * 2 + 3], jnp.int32)
    q = jnp.asarray(rng.standard_normal((B, 1, H, D)), jnp.bfloat16)
    base = _paged_kernel(q, kv, pos)

    # move every row's blocks to new pool slots (consecutive or shuffled)
    old = np.asarray(kv.block_table).reshape(-1)
    new = (np.arange(1, N) if contiguous
           else rng.permutation(np.arange(1, N)))
    perm = np.zeros(N, np.int64)
    perm[new] = old                      # new slot <- old slot's contents
    move = lambda p: None if p is None else jnp.take(  # noqa: E731
        p, jnp.asarray(perm), axis=0 if p.ndim == 3 and p.shape[0] == N
        else 1)
    moved = PagedKV(move(kv.k_pool), move(kv.v_pool),
                    jnp.asarray(new.reshape(B, MB), jnp.int32), kv.lengths,
                    move(kv.k_scale), move(kv.v_scale))
    got = _paged_kernel(q, moved, pos)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(base, np.float32),
                               rtol=1e-6, atol=1e-6)
