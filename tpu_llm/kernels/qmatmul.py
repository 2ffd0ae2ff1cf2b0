"""Fused dequant-matmul for Q4_0 and Q8_0 weights (Pallas, Triton route).

``x (M, K) bf16 @ W (K, N) -> (M, N) f32`` with W packed as the loader
lays it out (``tpu_llm.quant.qtensor``): q4_0 ``q`` is (K/2, N) uint8 of
block-local nibble pairs, q8_0 ``q`` is (K, N) int8, and ``scales`` is
(K/32, N) f32 for both.

Decode is bound by weight bytes: the plain path materialises a bf16 copy
of every weight (4 bytes written and read per packed byte of q4_0) before
the GEMM. Here each program owns one (BM, BN) output tile and one slice of
K, loads the packed weights and their scales once, dequantises in
registers and feeds bf16 operands to ``pl.dot`` with an f32 accumulator.
Decode has few rows, so K is split across programs until the grid covers
the card's SMs about twice; the partial sums are added by XLA.

q4_0 byte (16b + j, n) holds W[32b + j, n] in its low nibble and
W[32b + 16 + j, n] in its high nibble. The kernel never interleaves
nibbles: x's columns are split the same way outside it (``x_lo``,
``x_hi``, each (M, K/2)), and the low and high planes contract against
their own half.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

KINDS = ("q4_0", "q8_0")
# blocks in flight to aim for: two waves over an H100's 132 SMs
_TARGET_PROGRAMS = 264


def _plan(kind: str, M: int, K: int, N: int):
    """Static tiling: (bm, bn, bk, split) for a (M, K) x (K, N) product.
    ``bk`` counts rows of the packed ``q`` plane per loop step."""
    bm = 16 if M <= 16 else 32 if M <= 32 else 64
    bn = 128 if N % 128 == 0 else 64
    kr = K // 2 if kind == "q4_0" else K
    bk = next(b for b in (64, 32, 16) if kr % b == 0)
    steps = kr // bk
    tiles = (N // bn) * (-(-M // bm))
    split = next((d for d in range(1, steps + 1)
                  if steps % d == 0 and tiles * d >= _TARGET_PROGRAMS), steps)
    return bm, bn, bk, split


def supported(kind: str, K: int, N: int) -> bool:
    """Shapes the kernel tiles without masking."""
    return kind in KINDS and K % 32 == 0 and N % 64 == 0


def _kernel(*refs, n_x: int, bk: int, rows_per_scale: int, steps: int):
    from jax.experimental import pallas as pl

    x_refs, (q_ref, s_ref, o_ref) = refs[:n_x], refs[n_x:]
    bm, bn = o_ref.shape
    base = pl.program_id(2) * steps * bk
    n_s = bk // rows_per_scale

    def body(i, acc):
        r = base + i * bk
        qp = q_ref[pl.ds(r, bk), :]
        sc = s_ref[pl.ds(r // rows_per_scale, n_s), :]
        sc = jnp.broadcast_to(sc[:, None, :], (n_s, rows_per_scale, bn))
        sc = sc.reshape(bk, bn)
        if n_x == 2:        # q4_0: low and high nibble planes, centred at 8
            planes = ((qp & 0xF).astype(jnp.int32) - 8,
                      (qp >> 4).astype(jnp.int32) - 8)
        else:               # q8_0
            planes = (qp.astype(jnp.int32),)
        for x_ref, p in zip(x_refs, planes):
            w = (p.astype(jnp.float32) * sc).astype(jnp.bfloat16)
            acc += pl.dot(x_ref[:, pl.ds(r, bk)], w)
        return acc

    acc = jax.lax.fori_loop(0, steps, body, jnp.zeros((bm, bn), jnp.float32))
    o_ref[...] = acc


@functools.partial(jax.jit, static_argnames=("interpret",))
def qmatmul(x: jax.Array, q: jax.Array, scales: jax.Array, *,
            interpret: bool = False) -> jax.Array:
    """x (..., K) @ dequant(q, scales) (K, N) -> (..., N) float32.

    The kind follows from the plane: uint8 ``q`` of K/2 rows is q4_0,
    int8 ``q`` of K rows is q8_0."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    *lead, K = x.shape
    N = q.shape[-1]
    kind = "q4_0" if q.dtype == jnp.uint8 else "q8_0"
    assert supported(kind, K, N), (kind, K, N)
    M = math.prod(lead)
    bm, bn, bk, split = _plan(kind, M, K, N)
    Mp = -(-M // bm) * bm
    x2 = jnp.pad(x.reshape(M, K).astype(jnp.bfloat16), ((0, Mp - M), (0, 0)))
    if kind == "q4_0":
        xr = x2.reshape(Mp, K // 32, 2, 16)
        xs = [xr[:, :, 0].reshape(Mp, K // 2), xr[:, :, 1].reshape(Mp, K // 2)]
        rows_per_scale, kr = 16, K // 2
    else:
        xs, rows_per_scale, kr = [x2], 32, K
    steps = kr // bk // split

    kernel = functools.partial(_kernel, n_x=len(xs), bk=bk,
                               rows_per_scale=rows_per_scale, steps=steps)
    x_spec = pl.BlockSpec((bm, kr), lambda n, m, s: (m, 0))
    out = pl.pallas_call(
        kernel,
        grid=(N // bn, Mp // bm, split),
        in_specs=[x_spec] * len(xs) + [
            pl.BlockSpec((kr, bn), lambda n, m, s: (0, n)),
            pl.BlockSpec((K // 32, bn), lambda n, m, s: (0, n)),
        ],
        out_specs=pl.BlockSpec((None, bm, bn), lambda n, m, s: (s, m, n)),
        out_shape=jax.ShapeDtypeStruct((split, Mp, N), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=3),
        interpret=interpret,
        name=f"qmatmul_{kind}",
    )(*xs, q, scales)
    return out.sum(axis=0)[:M].reshape(*lead, N)
