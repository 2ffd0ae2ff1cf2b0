"""Host-side (numpy) GGML block-quant formats.

Layouts follow the GGML spec the reference targets (Q4_0 constants
``qk4=32`` at ``load.f90:7-8``; the pack2x4/unpack C helpers it stubs at
``load.f90:136-152``):

- Q4_0: blocks of 32 weights; per block [f16 scale d][16 bytes qs].
  byte j: low nibble = q[j], high nibble = q[j+16]; value = (q - 8) * d.
- Q4_1: [f16 d][f16 m][16 bytes]; value = q * d + m.
- Q5_0: [f16 d][u32 qh][16 bytes qs]; 5th (high) bit of weight j is bit j
  of qh; value = ((q | (bit << 4)) - 16) * d.
- Q5_1: [f16 d][f16 m][u32 qh][16 bytes qs]; value = q5 * d + m.
- Q8_0: [f16 d][32 int8]; value = q * d.

These run at load/convert time only; on the device, weights stay packed
as QTensors (tpu_llm/quant/qtensor.py) and dequantize inside the matmul
path (tpu_llm/quant/linear.py).
"""

from __future__ import annotations

import numpy as np

QK4_0 = 32
QK4_1 = 32
QK5_0 = 32
QK5_1 = 32
QK8_0 = 32

# bytes per block
Q4_0_BLOCK_BYTES = 2 + 16
Q4_1_BLOCK_BYTES = 4 + 16
Q5_0_BLOCK_BYTES = 2 + 4 + 16
Q5_1_BLOCK_BYTES = 4 + 4 + 16
Q8_0_BLOCK_BYTES = 2 + 32


def quantize_q4_0(x: np.ndarray) -> bytes:
    """Quantize a flat f32 array (len % 32 == 0) to GGML Q4_0 bytes."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK4_0)
    amax_idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(x.shape[0]), amax_idx]  # signed value of abs-max (ggml convention)
    d = maxv / -8.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip((x * inv_d[:, None]) + 8.5, 0.0, 15.0).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    packed = (lo | (hi << 4)).astype(np.uint8)
    out = np.empty((x.shape[0], Q4_0_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = packed
    return out.tobytes()


def dequantize_q4_0(buf: bytes | np.ndarray, n: int) -> np.ndarray:
    """Dequantize GGML Q4_0 bytes to a flat f32 array of length n."""
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, Q4_0_BLOCK_BYTES)
    assert raw.shape[0] * QK4_0 == n, (raw.shape, n)
    d = raw[:, :2].copy().view(np.float16).astype(np.float32)  # (nb, 1)
    qs = raw[:, 2:]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)  # (nb, 32)
    return (q * d).reshape(-1)


def quantize_q4_1(x: np.ndarray) -> bytes:
    """Quantize a flat f32 array (len % 32 == 0) to GGML Q4_1 bytes
    (affine: value = d*q + m, q in [0, 15], d = (max-min)/15, m = min)."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK4_1)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 15.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip(np.round((x - mn[:, None]) * inv_d[:, None]), 0.0, 15.0)
    q = q.astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    out = np.empty((x.shape[0], Q4_1_BLOCK_BYTES), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = mn.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 4:] = (lo | (hi << 4)).astype(np.uint8)
    return out.tobytes()


def dequantize_q4_1(buf: bytes | np.ndarray, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, Q4_1_BLOCK_BYTES)
    assert raw.shape[0] * QK4_1 == n
    d = raw[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = raw[:, 2:4].copy().view(np.float16).astype(np.float32)
    qs = raw[:, 4:]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    q = np.concatenate([lo, hi], axis=1)
    return (q * d + m).reshape(-1)


def _split_qh(qh_bytes: np.ndarray) -> np.ndarray:
    """(nb, 4) u8 high-bit words -> (nb, 32) 0/1 high bits (bit j of qh)."""
    qh = qh_bytes.copy().view(np.uint32).reshape(-1, 1)
    return ((qh >> np.arange(32, dtype=np.uint32)[None, :]) & 1).astype(np.uint8)


def _pack_qh(hi_bits: np.ndarray) -> np.ndarray:
    """(nb, 32) 0/1 high bits -> (nb, 4) u8 packed words."""
    qh = (hi_bits.astype(np.uint32)
          << np.arange(32, dtype=np.uint32)[None, :]).sum(axis=1, dtype=np.uint32)
    return qh.view(np.uint8).reshape(-1, 4)


def quantize_q5_0(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK5_0)
    amax_idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(x.shape[0]), amax_idx]
    d = maxv / -16.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip((x * inv_d[:, None]) + 16.5, 0.0, 31.0).astype(np.uint8)
    lo4, hi4 = q[:, :16] & 0x0F, q[:, 16:] & 0x0F
    out = np.empty((x.shape[0], Q5_0_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:6] = _pack_qh(q >> 4)
    out[:, 6:] = lo4 | (hi4 << 4)
    return out.tobytes()


def dequantize_q5_0(buf: bytes | np.ndarray, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, Q5_0_BLOCK_BYTES)
    assert raw.shape[0] * QK5_0 == n, (raw.shape, n)
    d = raw[:, :2].copy().view(np.float16).astype(np.float32)
    hi_bit = _split_qh(raw[:, 2:6])
    qs = raw[:, 6:]
    lo = (qs & 0x0F).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    q4 = np.concatenate([lo, hi], axis=1)
    q = (q4 | (hi_bit.astype(np.int16) << 4)) - 16
    return (q.astype(np.float32) * d).reshape(-1)


def quantize_q5_1(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK5_1)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 31.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip((x - mn[:, None]) * inv_d[:, None] + 0.5, 0.0, 31.0).astype(np.uint8)
    out = np.empty((x.shape[0], Q5_1_BLOCK_BYTES), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = mn.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 4:8] = _pack_qh(q >> 4)
    out[:, 8:] = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    return out.tobytes()


def dequantize_q5_1(buf: bytes | np.ndarray, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, Q5_1_BLOCK_BYTES)
    assert raw.shape[0] * QK5_1 == n, (raw.shape, n)
    d = raw[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = raw[:, 2:4].copy().view(np.float16).astype(np.float32)
    hi_bit = _split_qh(raw[:, 4:8])
    qs = raw[:, 8:]
    lo = (qs & 0x0F).astype(np.uint16)
    hi = (qs >> 4).astype(np.uint16)
    q4 = np.concatenate([lo, hi], axis=1)
    q = q4 | (hi_bit.astype(np.uint16) << 4)
    return (q.astype(np.float32) * d + m).reshape(-1)


def quantize_q8_0(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK8_0)
    amax = np.max(np.abs(x), axis=1)
    d = amax / 127.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.round(x * inv_d[:, None]).astype(np.int8)
    out = np.empty((x.shape[0], Q8_0_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


def dequantize_q8_0(buf: bytes | np.ndarray, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, Q8_0_BLOCK_BYTES)
    assert raw.shape[0] * QK8_0 == n
    d = raw[:, :2].copy().view(np.float16).astype(np.float32)
    q = raw[:, 2:].view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)


# -- K-quants (256-weight superblocks) ----------------------------------------
#
# llama.cpp's "K-quants" are the de-facto GGUF distribution formats
# (Q4_K_M etc.). A superblock of QK_K=256 weights carries one f16 super
# scale ``d`` (and, for the affine kinds, a super min ``dmin``) plus
# per-sub-block 4/6-bit scale multipliers. Sub-blocks are CONSECUTIVE
# runs of 16 (Q2/Q3/Q6) or 32 (Q4/Q5) weights — only the value-bit
# packing is interleaved, so every codec below unpacks values to natural
# order and applies per-sub-block scales with a repeat.
#
# Layouts (little-endian, per superblock):
# - Q2_K: [u8 scales[16] (lo4=scale, hi4=min)][u8 qs[64]][f16 d][f16 dmin]
#         value = d*sc*q − dmin*m, q 2-bit in [0,3], sub-blocks of 16.
# - Q3_K: [u8 hmask[32]][u8 qs[64]][u8 scales[12] (16×6-bit)][f16 d]
#         value = d*(sc−32)*q, q in [−4,3] (2 low bits + high-bit −4 offset).
# - Q4_K: [f16 d][f16 dmin][u8 scales[12] (8×6-bit sc + 8×6-bit m)][u8 qs[128]]
#         value = d*sc*q − dmin*m, q 4-bit in [0,15], sub-blocks of 32.
# - Q5_K: [f16 d][f16 dmin][u8 scales[12]][u8 qh[32]][u8 qs[128]]
#         value = d*sc*q − dmin*m, q 5-bit in [0,31].
# - Q6_K: [u8 ql[128]][u8 qh[64]][i8 scales[16]][f16 d]
#         value = d*sc*q, q 6-bit in [−32,31], sub-blocks of 16.
#
# The quantizers here produce VALID encodings (simple per-sub-block
# min-max / abs-max fits) — any encoder is legal as long as the decoder
# is bit-exact to ggml's, which the unpack paths below are.

QK_K = 256

Q2_K_BLOCK_BYTES = 16 + 64 + 2 + 2           # 84
Q3_K_BLOCK_BYTES = 32 + 64 + 12 + 2          # 110
Q4_K_BLOCK_BYTES = 2 + 2 + 12 + 128          # 144
Q5_K_BLOCK_BYTES = 2 + 2 + 12 + 32 + 128     # 176
Q6_K_BLOCK_BYTES = 128 + 64 + 16 + 2         # 210


def _f16(b: np.ndarray) -> np.ndarray:
    """(nb, 2) u8 -> (nb, 1) f32 via f16 bits."""
    return b.copy().view(np.float16).astype(np.float32)


def _unpack_scale_min_k4(s: np.ndarray):
    """ggml get_scale_min_k4, vectorized: (nb, 12) u8 -> ((nb, 8), (nb, 8))
    6-bit scale and min multipliers."""
    s = s.astype(np.uint8)
    sc = np.empty(s.shape[:-1] + (8,), np.uint8)
    m = np.empty_like(sc)
    sc[..., :4] = s[..., 0:4] & 63
    m[..., :4] = s[..., 4:8] & 63
    sc[..., 4:] = (s[..., 8:12] & 0x0F) | ((s[..., 0:4] >> 6) << 4)
    m[..., 4:] = (s[..., 8:12] >> 4) | ((s[..., 4:8] >> 6) << 4)
    return sc, m


def _pack_scale_min_k4(sc: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_scale_min_k4: 6-bit (nb, 8) sc/m -> (nb, 12) u8."""
    sc = sc.astype(np.uint8)
    m = m.astype(np.uint8)
    out = np.empty(sc.shape[:-1] + (12,), np.uint8)
    out[..., 0:4] = (sc[..., :4] & 63) | ((sc[..., 4:] >> 4) << 6)
    out[..., 4:8] = (m[..., :4] & 63) | ((m[..., 4:] >> 4) << 6)
    out[..., 8:12] = (sc[..., 4:] & 0x0F) | ((m[..., 4:] & 0x0F) << 4)
    return out


def _unpack_q3_scales(s: np.ndarray) -> np.ndarray:
    """Q3_K 12-byte scale words -> (nb, 16) int8 in [-32, 31]."""
    a = s.copy().view(np.uint32).reshape(-1, 3)
    a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
    k1, k2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    n0 = (a0 & k2) | ((a2 & k1) << np.uint32(4))
    n1 = (a1 & k2) | (((a2 >> np.uint32(2)) & k1) << np.uint32(4))
    n2 = ((a0 >> np.uint32(4)) & k2) | (((a2 >> np.uint32(4)) & k1) << np.uint32(4))
    n3 = ((a1 >> np.uint32(4)) & k2) | (((a2 >> np.uint32(6)) & k1) << np.uint32(4))
    words = np.stack([n0, n1, n2, n3], axis=1).astype("<u4")
    return (words.view(np.uint8).reshape(-1, 16).astype(np.int16) - 32).astype(np.int8)


def _pack_q3_scales(v: np.ndarray) -> np.ndarray:
    """Inverse: (nb, 16) int8 in [-32, 31] -> (nb, 12) u8."""
    u = (v.astype(np.int16) + 32).astype(np.uint8)   # 6-bit
    lo = u & 0x0F
    hi = u >> 4                                       # 2-bit
    out = np.empty((u.shape[0], 12), np.uint8)
    out[:, 0:4] = lo[:, 0:4] | (lo[:, 8:12] << 4)
    out[:, 4:8] = lo[:, 4:8] | (lo[:, 12:16] << 4)
    out[:, 8:12] = (hi[:, 0:4] | (hi[:, 4:8] << 2)
                    | (hi[:, 8:12] << 4) | (hi[:, 12:16] << 6))
    return out


def _q2k_split(raw: np.ndarray):
    """(nb, 84) -> (q (nb, 256) u8 in [0,3], sc (nb, 16) u8, m (nb, 16) u8,
    d (nb, 1) f32, dmin (nb, 1) f32)."""
    scales = raw[:, :16]
    qs = raw[:, 16:80]
    d = _f16(raw[:, 80:82])
    dmin = _f16(raw[:, 82:84])
    sc = scales & 0x0F
    m = scales >> 4
    nb = raw.shape[0]
    q = np.empty((nb, QK_K), np.uint8)
    for half in range(2):                      # weights 128*half + ...
        qb = qs[:, 32 * half: 32 * half + 32]
        for j in range(4):
            q[:, 128 * half + 32 * j: 128 * half + 32 * (j + 1)] = (
                qb >> (2 * j)) & 3
    return q, sc, m, d, dmin


def _q3k_split(raw: np.ndarray):
    """(nb, 110) -> (q (nb, 256) int8 in [-4,3], sc (nb, 16) int8, d f32)."""
    hmask = raw[:, :32]
    qs = raw[:, 32:96]
    sc = _unpack_q3_scales(raw[:, 96:108])
    d = _f16(raw[:, 108:110])
    nb = raw.shape[0]
    q = np.empty((nb, QK_K), np.int8)
    for half in range(2):
        qb = qs[:, 32 * half: 32 * half + 32]
        for j in range(4):
            bit = 4 * half + j
            h = (hmask >> bit) & 1             # (nb, 32)
            v = ((qb >> (2 * j)) & 3).astype(np.int8) - (4 * (1 - h)).astype(np.int8)
            q[:, 128 * half + 32 * j: 128 * half + 32 * (j + 1)] = v
    return q, sc, d


def _q4k_split(raw: np.ndarray):
    """(nb, 144) -> (q (nb, 256) u8 in [0,15], sc (nb, 8), m (nb, 8), d, dmin)."""
    d = _f16(raw[:, 0:2])
    dmin = _f16(raw[:, 2:4])
    sc, m = _unpack_scale_min_k4(raw[:, 4:16])
    qs = raw[:, 16:144]
    nb = raw.shape[0]
    q = np.empty((nb, QK_K), np.uint8)
    for j in range(4):                          # chunks of 64 weights
        qb = qs[:, 32 * j: 32 * (j + 1)]
        q[:, 64 * j: 64 * j + 32] = qb & 0x0F
        q[:, 64 * j + 32: 64 * j + 64] = qb >> 4
    return q, sc, m, d, dmin


def _q5k_split(raw: np.ndarray):
    """(nb, 176) -> (q (nb, 256) u8 in [0,31], sc (nb, 8), m (nb, 8), d, dmin)."""
    d = _f16(raw[:, 0:2])
    dmin = _f16(raw[:, 2:4])
    sc, m = _unpack_scale_min_k4(raw[:, 4:16])
    qh = raw[:, 16:48]
    ql = raw[:, 48:176]
    nb = raw.shape[0]
    q = np.empty((nb, QK_K), np.uint8)
    for j in range(4):                          # chunks of 64 weights
        qb = ql[:, 32 * j: 32 * (j + 1)]
        h1 = (qh >> (2 * j)) & 1
        h2 = (qh >> (2 * j + 1)) & 1
        q[:, 64 * j: 64 * j + 32] = (qb & 0x0F) | (h1 << 4)
        q[:, 64 * j + 32: 64 * j + 64] = (qb >> 4) | (h2 << 4)
    return q, sc, m, d, dmin


def _q6k_split(raw: np.ndarray):
    """(nb, 210) -> (q (nb, 256) int8 in [-32,31], sc (nb, 16) int8, d f32)."""
    ql = raw[:, :128]
    qh = raw[:, 128:192]
    sc = raw[:, 192:208].view(np.int8)
    d = _f16(raw[:, 208:210])
    nb = raw.shape[0]
    q = np.empty((nb, QK_K), np.int8)
    for half in range(2):                       # weights 128*half + ...
        qlb = ql[:, 64 * half: 64 * half + 64]
        qhb = qh[:, 32 * half: 32 * half + 32]
        lo = [qlb[:, :32] & 0x0F, qlb[:, 32:] & 0x0F,
              qlb[:, :32] >> 4, qlb[:, 32:] >> 4]
        for c in range(4):                      # chunks of 32 within the half
            v = (lo[c] | (((qhb >> (2 * c)) & 3) << 4)).astype(np.int16) - 32
            q[:, 128 * half + 32 * c: 128 * half + 32 * (c + 1)] = v.astype(np.int8)
    return q, sc, d


def _rep16(x: np.ndarray) -> np.ndarray:
    return np.repeat(x.astype(np.float32), 16, axis=1)


def _rep32(x: np.ndarray) -> np.ndarray:
    return np.repeat(x.astype(np.float32), 32, axis=1)


def dequantize_q2_k(buf: bytes | np.ndarray, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, np.uint8).reshape(-1, Q2_K_BLOCK_BYTES)
    assert raw.shape[0] * QK_K == n, (raw.shape, n)
    q, sc, m, d, dmin = _q2k_split(raw)
    return (q * (d * _rep16(sc)) - dmin * _rep16(m)).reshape(-1).astype(np.float32)


def dequantize_q3_k(buf: bytes | np.ndarray, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, np.uint8).reshape(-1, Q3_K_BLOCK_BYTES)
    assert raw.shape[0] * QK_K == n, (raw.shape, n)
    q, sc, d = _q3k_split(raw)
    return (q * (d * _rep16(sc))).reshape(-1).astype(np.float32)


def dequantize_q4_k(buf: bytes | np.ndarray, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, np.uint8).reshape(-1, Q4_K_BLOCK_BYTES)
    assert raw.shape[0] * QK_K == n, (raw.shape, n)
    q, sc, m, d, dmin = _q4k_split(raw)
    return (q * (d * _rep32(sc)) - dmin * _rep32(m)).reshape(-1).astype(np.float32)


def dequantize_q5_k(buf: bytes | np.ndarray, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, np.uint8).reshape(-1, Q5_K_BLOCK_BYTES)
    assert raw.shape[0] * QK_K == n, (raw.shape, n)
    q, sc, m, d, dmin = _q5k_split(raw)
    return (q * (d * _rep32(sc)) - dmin * _rep32(m)).reshape(-1).astype(np.float32)


def dequantize_q6_k(buf: bytes | np.ndarray, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, np.uint8).reshape(-1, Q6_K_BLOCK_BYTES)
    assert raw.shape[0] * QK_K == n, (raw.shape, n)
    q, sc, d = _q6k_split(raw)
    return (q * (d * _rep16(sc))).reshape(-1).astype(np.float32)


def _fit_affine(x: np.ndarray, sub: int, qmax: int, smax: int):
    """Per-sub-block min-max affine fit for the 2-level K-quant scheme.

    x: (nb, 256) -> (d (nb,) f32, dmin (nb,) f32, sc (nb, 256//sub) u8,
    m6 (nb, 256//sub) u8, q (nb, 256) u8) with
    value ~= d*sc*q - dmin*m6."""
    xs = x.reshape(x.shape[0], -1, sub)
    mn = np.minimum(xs.min(axis=2), 0.0)
    mx = np.maximum(xs.max(axis=2), 0.0)
    msub = -mn                                  # >= 0
    dsub = (mx + msub) / qmax                   # >= 0
    d = dsub.max(axis=1) / smax
    dmin = msub.max(axis=1) / smax
    with np.errstate(divide="ignore", invalid="ignore"):
        sc = np.where(d[:, None] > 0, np.rint(dsub / d[:, None]), 0)
        m6 = np.where(dmin[:, None] > 0, np.rint(msub / dmin[:, None]), 0)
    sc = np.clip(sc, 0, smax).astype(np.uint8)
    m6 = np.clip(m6, 0, smax).astype(np.uint8)
    eff_d = d[:, None] * sc                     # (nb, nsub)
    eff_m = dmin[:, None] * m6
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(eff_d[:, :, None] > 0,
                     np.rint((xs + eff_m[:, :, None]) / eff_d[:, :, None]), 0)
    q = np.clip(q, 0, qmax).astype(np.uint8).reshape(x.shape[0], -1)
    return (d.astype(np.float16).astype(np.float32),
            dmin.astype(np.float16).astype(np.float32), sc, m6, q)


def _fit_symmetric(x: np.ndarray, sub: int, qmax: int, smax: int):
    """Per-sub-block abs-max symmetric fit: value ~= d*sc*q."""
    xs = x.reshape(x.shape[0], -1, sub)
    amax = np.abs(xs).max(axis=2)
    dsub = amax / qmax
    d = dsub.max(axis=1) / smax
    with np.errstate(divide="ignore", invalid="ignore"):
        sc = np.where(d[:, None] > 0, np.rint(dsub / d[:, None]), 0)
    sc = np.clip(sc, 0, smax).astype(np.uint8)
    eff = d[:, None] * sc
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(eff[:, :, None] > 0, np.rint(xs / eff[:, :, None]), 0)
    q = np.clip(q, -qmax - 1, qmax).astype(np.int8).reshape(x.shape[0], -1)
    return d.astype(np.float16).astype(np.float32), sc, q


def quantize_q2_k(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, np.float32).reshape(-1, QK_K)
    d, dmin, sc, m, q = _fit_affine(x, sub=16, qmax=3, smax=15)
    out = np.empty((x.shape[0], Q2_K_BLOCK_BYTES), np.uint8)
    out[:, :16] = sc | (m << 4)
    for half in range(2):
        acc = np.zeros((x.shape[0], 32), np.uint8)
        for j in range(4):
            acc |= q[:, 128 * half + 32 * j: 128 * half + 32 * (j + 1)] << (2 * j)
        out[:, 16 + 32 * half: 16 + 32 * half + 32] = acc
    out[:, 80:82] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 82:84] = dmin.astype(np.float16).view(np.uint8).reshape(-1, 2)
    return out.tobytes()


def quantize_q3_k(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, np.float32).reshape(-1, QK_K)
    d, sc, q = _fit_symmetric(x, sub=16, qmax=3, smax=31)   # q in [-4, 3]
    q = np.clip(q, -4, 3)
    out = np.empty((x.shape[0], Q3_K_BLOCK_BYTES), np.uint8)
    u = (q.astype(np.int16) + 4).astype(np.uint8)           # 0..7
    hmask = np.zeros((x.shape[0], 32), np.uint8)
    qs = np.zeros((x.shape[0], 64), np.uint8)
    for half in range(2):
        for j in range(4):
            chunk = u[:, 128 * half + 32 * j: 128 * half + 32 * (j + 1)]
            qs[:, 32 * half: 32 * half + 32] |= (chunk & 3) << (2 * j)
            hmask |= (chunk >> 2) << (4 * half + j)
    out[:, :32] = hmask
    out[:, 32:96] = qs
    out[:, 96:108] = _pack_q3_scales(sc.astype(np.int8))
    out[:, 108:110] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    return out.tobytes()


def quantize_q4_k(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, np.float32).reshape(-1, QK_K)
    d, dmin, sc, m, q = _fit_affine(x, sub=32, qmax=15, smax=63)
    out = np.empty((x.shape[0], Q4_K_BLOCK_BYTES), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = _pack_scale_min_k4(sc, m)
    for j in range(4):
        lo = q[:, 64 * j: 64 * j + 32]
        hi = q[:, 64 * j + 32: 64 * j + 64]
        out[:, 16 + 32 * j: 16 + 32 * (j + 1)] = lo | (hi << 4)
    return out.tobytes()


def quantize_q5_k(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, np.float32).reshape(-1, QK_K)
    d, dmin, sc, m, q = _fit_affine(x, sub=32, qmax=31, smax=63)
    out = np.empty((x.shape[0], Q5_K_BLOCK_BYTES), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = _pack_scale_min_k4(sc, m)
    qh = np.zeros((x.shape[0], 32), np.uint8)
    for j in range(4):
        lo = q[:, 64 * j: 64 * j + 32]
        hi = q[:, 64 * j + 32: 64 * j + 64]
        out[:, 48 + 32 * j: 48 + 32 * (j + 1)] = (lo & 0x0F) | ((hi & 0x0F) << 4)
        qh |= (lo >> 4) << (2 * j)
        qh |= (hi >> 4) << (2 * j + 1)
    out[:, 16:48] = qh
    return out.tobytes()


def quantize_q6_k(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, np.float32).reshape(-1, QK_K)
    d, sc, q = _fit_symmetric(x, sub=16, qmax=31, smax=127)  # q in [-32, 31]
    q = np.clip(q, -32, 31)
    out = np.empty((x.shape[0], Q6_K_BLOCK_BYTES), np.uint8)
    u = (q.astype(np.int16) + 32).astype(np.uint8)           # 0..63
    for half in range(2):
        c = [u[:, 128 * half + 32 * k: 128 * half + 32 * (k + 1)]
             for k in range(4)]
        out[:, 64 * half: 64 * half + 32] = (c[0] & 0x0F) | ((c[2] & 0x0F) << 4)
        out[:, 64 * half + 32: 64 * half + 64] = (c[1] & 0x0F) | ((c[3] & 0x0F) << 4)
        qh = ((c[0] >> 4) | ((c[1] >> 4) << 2)
              | ((c[2] >> 4) << 4) | ((c[3] >> 4) << 6))
        out[:, 128 + 32 * half: 128 + 32 * half + 32] = qh
    out[:, 192:208] = sc.astype(np.int8).view(np.uint8)
    out[:, 208:210] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    return out.tobytes()
