"""Quantized weight tensors as pytree nodes.

A ``QTensor`` keeps GGML block-quantized weights PACKED in device memory —
the decode hot path is bound by memory bandwidth, so Q4_0 reads 5
bits/weight (4-bit values, one f32 scale per 32) vs f16's 16 (the point
of the reference's four_bit_dev branch, SURVEY.md §2.2). On the GPU the
dequantization of Q4_0/Q8_0 is fused into the matmul
(tpu_llm/kernels/qmatmul.py); other kinds and platforms dequantize in
XLA, then multiply.

Device layout (struct-of-arrays planes, NOT ggml's array-of-structs):
- Logical weight W is (K, N) = (in_features, out_features), used as x @ W.
- q4_0: ``q`` is (K//2, N) uint8 with ggml's block-local nibble pairing kept
  column-major: byte (16*b + j, n) holds quants of W[32*b + j, n] (low
  nibble) and W[32*b + 16 + j, n] (high nibble). Any K-tile that is a
  multiple of 32 therefore maps to contiguous rows of ``q`` — kernels can
  tile K freely. In-kernel unpack is reshape (TK//32, 16, TN) → concat
  lo/hi on the middle axis → (TK, TN); no element interleave.
  Value = (nibble - 8) * scale[k//32, n].
- q8_0: ``q`` is (K, N) int8; value = q * scale[k//32, n].
- ``scales`` is (K//32, N) float32 (separate struct-of-arrays plane, so
  scale reads are contiguous).

Repacking from the ggml on-disk byte order is a pure transpose host-side
(numpy) at load time.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_llm.quant import blocks as qblocks


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class QTensor:
    q: jax.Array          # packed quants, see module docstring
    scales: jax.Array     # (..., K//block, N); block = 32 (_0/_1 kinds and
    #                       folded q4_K/q5_K) or 16 (folded q2/q3/q6_K)
    kind: str             # "q4_0" | "q8_0" | "q4_1" | "q5_0" |
    #                       "q5_1" | "q2_k" | "q2_kp" | "q3_k" | "q3_kp" |
    #                       "q6_k" | "q6_kp"
    #                       (q4_K loads AS q4_1, q5_K AS q5_1 — the 2-level
    #                       superblock scales fold into flat planes at load;
    #                       q2_K/q3_K load nibble-PACKED by default —
    #                       "q2_kp"/"q3_kp", TPU_LLM_Q23_INT8=1 restores the
    #                       int8 value planes)
    # affine kinds: per-block offset m (value = q*scale + m), same plane
    # layout as scales. For "q6_kp" this slot instead carries the qh
    # 2-bit plane (K/4, N) uint8 — see pack_q6_k.
    mins: Optional[jax.Array] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        *lead, kq, n = self.q.shape
        k = (kq * 2 if self.kind in ("q4_0", "q4_1", "q6_kp",
                                     "q2_kp", "q3_kp") else kq)
        return (*lead, k, n)

    @property
    def dtype(self):
        return jnp.float32

    def tree_flatten(self):
        return (self.q, self.scales, self.mins), (self.kind,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        q, scales, mins = children
        return cls(q=q, scales=scales, kind=aux[0], mins=mins)


def qmap(fn, *qts: QTensor) -> QTensor:
    """Apply ``fn`` to each plane of same-kind QTensors (q, scales, and —
    for affine kinds — mins all share N-axis layout, so structural
    transforms like stack/concat/index/permute/device_put apply the same
    function to every plane)."""
    kind = qts[0].kind
    mins = None
    if qts[0].mins is not None:
        mins = fn(*[t.mins for t in qts])
    return QTensor(q=fn(*[t.q for t in qts]),
                   scales=fn(*[t.scales for t in qts]), kind=kind, mins=mins)


# -- host-side repacking -----------------------------------------------------

def _split_ggml_q4_0(raw: np.ndarray, rows: int, row_len: int):
    """ggml q4_0 bytes of a (rows, row_len) row-major tensor ->
    (packed (row_len//2, rows) uint8, scales (row_len//32, rows) f32) for
    the transposed logical weight W (K=row_len, N=rows)."""
    from tpu_llm import native

    if native.available():
        return native.repack_q4_0(np.asarray(raw, np.uint8), rows, row_len)
    nb = row_len // qblocks.QK4_0
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q4_0_BLOCK_BYTES)
    d = raw[:, :, :2].copy().view(np.float16).astype(np.float32).reshape(rows, nb)
    # ggml already stores block-local nibble pairs (j, j+16); keeping that
    # order per column is exactly our device layout — repack is a transpose.
    qs = raw[:, :, 2:].reshape(rows, row_len // 2)
    return np.ascontiguousarray(qs.T), np.ascontiguousarray(d.T)


def _split_ggml_q4_1(raw: np.ndarray, rows: int, row_len: int):
    """ggml q4_1 bytes -> (packed (row_len//2, rows) uint8,
    scales (row_len//32, rows) f32, mins (row_len//32, rows) f32)."""
    from tpu_llm import native

    if native.available():
        return native.repack_q4_1(np.asarray(raw, np.uint8), rows, row_len)
    nb = row_len // qblocks.QK4_1
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q4_1_BLOCK_BYTES)
    d = raw[:, :, 0:2].copy().view(np.float16).astype(np.float32).reshape(rows, nb)
    m = raw[:, :, 2:4].copy().view(np.float16).astype(np.float32).reshape(rows, nb)
    qs = raw[:, :, 4:].reshape(rows, row_len // 2)
    return (np.ascontiguousarray(qs.T), np.ascontiguousarray(d.T),
            np.ascontiguousarray(m.T))


def _split_ggml_q5_0(raw: np.ndarray, rows: int, row_len: int):
    """ggml q5_0 -> (values (row_len, rows) int8 in [-16, 15],
    scales (row_len//32, rows) f32). The 4+1-bit packing is recombined to
    an int8 value plane at load: 8.25 bits/weight at rest — double the
    disk format but half of bf16, and the matmul path stays the plain
    int8 dequant (no in-kernel bit splicing)."""
    nb = row_len // qblocks.QK5_0
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q5_0_BLOCK_BYTES)
    d = raw[:, :, :2].copy().view(np.float16).astype(np.float32).reshape(rows, nb)
    hi_bit = qblocks._split_qh(raw[:, :, 2:6].reshape(rows * nb, 4))
    qs = raw[:, :, 6:]
    lo = (qs & 0x0F).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    q4 = np.concatenate([lo, hi], axis=2).reshape(rows * nb, 32)
    q = ((q4 | (hi_bit.astype(np.int16) << 4)) - 16).astype(np.int8)
    q = q.reshape(rows, row_len)
    return np.ascontiguousarray(q.T), np.ascontiguousarray(d.T)


def _split_ggml_q5_1(raw: np.ndarray, rows: int, row_len: int):
    """ggml q5_1 -> (values (row_len, rows) int8 in [0, 31],
    scales + mins (row_len//32, rows) f32)."""
    nb = row_len // qblocks.QK5_1
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q5_1_BLOCK_BYTES)
    d = raw[:, :, 0:2].copy().view(np.float16).astype(np.float32).reshape(rows, nb)
    m = raw[:, :, 2:4].copy().view(np.float16).astype(np.float32).reshape(rows, nb)
    hi_bit = qblocks._split_qh(raw[:, :, 4:8].reshape(rows * nb, 4))
    qs = raw[:, :, 8:]
    lo = (qs & 0x0F).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    q4 = np.concatenate([lo, hi], axis=2).reshape(rows * nb, 32)
    q = (q4 | (hi_bit.astype(np.int16) << 4)).astype(np.int8)
    q = q.reshape(rows, row_len)
    return (np.ascontiguousarray(q.T), np.ascontiguousarray(d.T),
            np.ascontiguousarray(m.T))


def _split_ggml_q8_0(raw: np.ndarray, rows: int, row_len: int):
    from tpu_llm import native

    if native.available():
        return native.repack_q8_0(np.asarray(raw, np.uint8), rows, row_len)
    nb = row_len // qblocks.QK8_0
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q8_0_BLOCK_BYTES)
    d = raw[:, :, :2].copy().view(np.float16).astype(np.float32).reshape(rows, nb)
    q = raw[:, :, 2:].view(np.int8).reshape(rows, row_len)
    return np.ascontiguousarray(q.T), np.ascontiguousarray(d.T)


def _pack_q4_unsigned(vals: np.ndarray) -> np.ndarray:
    """(K, N) u8 values in [0, 15] -> (K//2, N) packed uint8 in the device
    block-local layout (byte 16b+j holds W[32b+j] low / W[32b+16+j] high)."""
    k, n = vals.shape
    blk = vals.reshape(k // 32, 32, n)
    return (blk[:, :16, :] | (blk[:, 16:, :] << 4)).reshape(k // 2, n)


def _split_ggml_q4_k(raw: np.ndarray, rows: int, row_len: int):
    """ggml q4_K superblocks -> device planes: (packed (row_len//2, rows) u8,
    scales (row_len//32, rows) f32, mins (row_len//32, rows) f32).

    The two-level scale scheme (f16 super d/dmin x 6-bit sub multipliers)
    is FOLDED into flat per-32 planes at load: scale = d*sc, min = -dmin*m,
    so on device the tensor is exactly a q4_1 (value = q*scale + min) and
    shares its kernels. Bit layout follows ggml's dequantize_row_q4_K."""
    nb = row_len // qblocks.QK_K
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q4_K_BLOCK_BYTES)
    q, sc, m, d, dmin = qblocks._q4k_split(raw.reshape(rows * nb, -1))
    scales = (d * sc).reshape(rows, nb * 8)          # per-32 effective scale
    mins = (-dmin * m).reshape(rows, nb * 8)
    vals = q.reshape(rows, row_len)                  # u8 in [0, 15]
    packed = _pack_q4_unsigned(np.ascontiguousarray(vals.T))
    return (packed,
            np.ascontiguousarray(scales.T.astype(np.float32)),
            np.ascontiguousarray(mins.T.astype(np.float32)))


def _split_ggml_q5_k(raw: np.ndarray, rows: int, row_len: int):
    """ggml q5_K -> (values (row_len, rows) int8 in [0, 31], scales, mins
    per-32 f32 planes) — the q5_1 device layout with folded scales."""
    nb = row_len // qblocks.QK_K
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q5_K_BLOCK_BYTES)
    q, sc, m, d, dmin = qblocks._q5k_split(raw.reshape(rows * nb, -1))
    scales = (d * sc).reshape(rows, nb * 8)
    mins = (-dmin * m).reshape(rows, nb * 8)
    vals = q.reshape(rows, row_len).astype(np.int8)
    return (np.ascontiguousarray(vals.T),
            np.ascontiguousarray(scales.T.astype(np.float32)),
            np.ascontiguousarray(mins.T.astype(np.float32)))


def _split_ggml_q6_k(raw: np.ndarray, rows: int, row_len: int):
    """ggml q6_K -> (values (row_len, rows) int8 in [-32, 31],
    scales (row_len//16, rows) f32) — int8-plane kind with per-16 blocks."""
    nb = row_len // qblocks.QK_K
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q6_K_BLOCK_BYTES)
    q, sc, d = qblocks._q6k_split(raw.reshape(rows * nb, -1))
    scales = (d * sc).reshape(rows, nb * 16)         # per-16 effective scale
    vals = q.reshape(rows, row_len)
    return (np.ascontiguousarray(vals.T),
            np.ascontiguousarray(scales.T.astype(np.float32)))


def _split_ggml_q3_k(raw: np.ndarray, rows: int, row_len: int):
    """ggml q3_K -> (values (row_len, rows) int8 in [-4, 3],
    scales (row_len//16, rows) f32)."""
    nb = row_len // qblocks.QK_K
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q3_K_BLOCK_BYTES)
    q, sc, d = qblocks._q3k_split(raw.reshape(rows * nb, -1))
    scales = (d * sc).reshape(rows, nb * 16)
    vals = q.reshape(rows, row_len)
    return (np.ascontiguousarray(vals.T),
            np.ascontiguousarray(scales.T.astype(np.float32)))


def _split_ggml_q2_k(raw: np.ndarray, rows: int, row_len: int):
    """ggml q2_K -> (values (row_len, rows) int8 in [0, 3], scales + mins
    (row_len//16, rows) f32 planes)."""
    nb = row_len // qblocks.QK_K
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q2_K_BLOCK_BYTES)
    q, sc, m, d, dmin = qblocks._q2k_split(raw.reshape(rows * nb, -1))
    scales = (d * sc).reshape(rows, nb * 16)
    mins = (-dmin * m).reshape(rows, nb * 16)
    vals = q.reshape(rows, row_len).astype(np.int8)
    return (np.ascontiguousarray(vals.T),
            np.ascontiguousarray(scales.T.astype(np.float32)),
            np.ascontiguousarray(mins.T.astype(np.float32)))


def qtensor_from_ggml(ggml_type: int, raw: np.ndarray, rows: int, row_len: int) -> QTensor:
    """Build a device QTensor from on-disk ggml block bytes of a (rows,
    row_len) tensor, representing the transposed (row_len, rows) weight."""
    from tpu_llm.io import gguf as gg

    if ggml_type == gg.GGML_Q4_0:
        packed, scales = _split_ggml_q4_0(raw, rows, row_len)
        return QTensor(jnp.asarray(packed), jnp.asarray(scales), "q4_0")
    if ggml_type == gg.GGML_Q8_0:
        q, scales = _split_ggml_q8_0(raw, rows, row_len)
        return QTensor(jnp.asarray(q), jnp.asarray(scales), "q8_0")
    if ggml_type == gg.GGML_Q4_1:
        packed, scales, mins = _split_ggml_q4_1(raw, rows, row_len)
        return QTensor(jnp.asarray(packed), jnp.asarray(scales), "q4_1",
                       mins=jnp.asarray(mins))
    if ggml_type == gg.GGML_Q5_0:
        q, scales = _split_ggml_q5_0(raw, rows, row_len)
        return QTensor(jnp.asarray(q), jnp.asarray(scales), "q5_0")
    if ggml_type == gg.GGML_Q5_1:
        q, scales, mins = _split_ggml_q5_1(raw, rows, row_len)
        return QTensor(jnp.asarray(q), jnp.asarray(scales), "q5_1",
                       mins=jnp.asarray(mins))
    # K-quants: the 2-level superblock scales are folded into flat per-sub-
    # block planes at load, so on device q4_K IS a q4_1 and q5_K a q5_1;
    # q2/q3/q6_K become int8-plane kinds with per-16 scale blocks.
    # Folded planes ship in BF16 by default: half the scale bytes, at a
    # rounding of the f16-origin products by <= 2^-8 relative.
    # TPU_LLM_KQ_F32S=1 restores exact f32 planes.
    _kq = (lambda a: jnp.asarray(a) if os.environ.get("TPU_LLM_KQ_F32S")
           else jnp.asarray(a).astype(jnp.bfloat16))
    if ggml_type == gg.GGML_Q4_K:
        packed, scales, mins = _split_ggml_q4_k(raw, rows, row_len)
        return QTensor(jnp.asarray(packed), _kq(scales), "q4_1",
                       mins=_kq(mins))
    if ggml_type == gg.GGML_Q5_K:
        q, scales, mins = _split_ggml_q5_k(raw, rows, row_len)
        return QTensor(jnp.asarray(q), _kq(scales), "q5_1",
                       mins=_kq(mins))
    if ggml_type == gg.GGML_Q6_K:
        q, scales = _split_ggml_q6_k(raw, rows, row_len)
        qt = QTensor(jnp.asarray(q), _kq(scales), "q6_k")
        if os.environ.get("TPU_LLM_Q6K_PACK"):
            # capacity option: 6-bit packed values (20% less weight
            # memory) at the cost of a heavier unpack
            return pack_q6_k(qt)
        return qt
    if ggml_type == gg.GGML_Q3_K:
        q, scales = _split_ggml_q3_k(raw, rows, row_len)
        if os.environ.get("TPU_LLM_Q23_INT8"):
            return QTensor(jnp.asarray(q), _kq(scales), "q3_k")
        # default: nibble-packed "q3_kp" — values [-4, 3] store as u+4 in
        # [0, 7], halving the value-plane bytes (1.0 -> 0.5 B/w) with the
        # same nibble unpack as the q4 kinds (TPU_LLM_Q23_INT8=1 restores
        # the int8-plane layout)
        packed = _pack_q4_unsigned((q.astype(np.int16) + 4).astype(np.uint8))
        return QTensor(jnp.asarray(packed), _kq(scales), "q3_kp")
    if ggml_type == gg.GGML_Q2_K:
        q, scales, mins = _split_ggml_q2_k(raw, rows, row_len)
        if os.environ.get("TPU_LLM_Q23_INT8"):
            return QTensor(jnp.asarray(q), _kq(scales), "q2_k",
                           mins=_kq(mins))
        # default: nibble-packed "q2_kp" — unsigned [0, 3] values share
        # the q4_1 unpack (affine mins), per-16 planes
        packed = _pack_q4_unsigned(q.astype(np.uint8))
        return QTensor(jnp.asarray(packed), _kq(scales), "q2_kp",
                       mins=_kq(mins))
    raise ValueError(f"unsupported ggml type for QTensor: {ggml_type}")


def quantize_tensor(w: np.ndarray, kind: str = "q4_0") -> QTensor:
    """Quantize a float (K, N) logical weight (tests / converters)."""
    k, n = w.shape
    flat = np.ascontiguousarray(np.asarray(w, np.float32).T).reshape(-1)
    if kind == "q4_0":
        raw = np.frombuffer(qblocks.quantize_q4_0(flat), np.uint8)
        packed, scales = _split_ggml_q4_0(raw, rows=n, row_len=k)
        return QTensor(jnp.asarray(packed), jnp.asarray(scales), "q4_0")
    if kind == "q8_0":
        raw = np.frombuffer(qblocks.quantize_q8_0(flat), np.uint8)
        q, scales = _split_ggml_q8_0(raw, rows=n, row_len=k)
        return QTensor(jnp.asarray(q), jnp.asarray(scales), "q8_0")
    if kind == "q4_1":
        raw = np.frombuffer(qblocks.quantize_q4_1(flat), np.uint8)
        packed, scales, mins = _split_ggml_q4_1(raw, rows=n, row_len=k)
        return QTensor(jnp.asarray(packed), jnp.asarray(scales), "q4_1",
                       mins=jnp.asarray(mins))
    if kind == "q5_0":
        raw = np.frombuffer(qblocks.quantize_q5_0(flat), np.uint8)
        q, scales = _split_ggml_q5_0(raw, rows=n, row_len=k)
        return QTensor(jnp.asarray(q), jnp.asarray(scales), "q5_0")
    if kind == "q5_1":
        raw = np.frombuffer(qblocks.quantize_q5_1(flat), np.uint8)
        q, scales, mins = _split_ggml_q5_1(raw, rows=n, row_len=k)
        return QTensor(jnp.asarray(q), jnp.asarray(scales), "q5_1",
                       mins=jnp.asarray(mins))
    if kind in ("q2_k", "q3_k", "q4_k", "q5_k", "q6_k"):
        from tpu_llm.io import gguf as gg
        ttype = {"q2_k": gg.GGML_Q2_K, "q3_k": gg.GGML_Q3_K,
                 "q4_k": gg.GGML_Q4_K, "q5_k": gg.GGML_Q5_K,
                 "q6_k": gg.GGML_Q6_K}[kind]
        quant = {"q2_k": qblocks.quantize_q2_k, "q3_k": qblocks.quantize_q3_k,
                 "q4_k": qblocks.quantize_q4_k, "q5_k": qblocks.quantize_q5_k,
                 "q6_k": qblocks.quantize_q6_k}[kind]
        raw = np.frombuffer(quant(flat), np.uint8)
        return qtensor_from_ggml(ttype, raw, rows=n, row_len=k)
    raise ValueError(kind)


# -- device-side dequant (XLA fallback path) ---------------------------------

def unpack_q4(q: jax.Array) -> jax.Array:
    """(..., K//2, N) packed uint8 -> (..., K, N) int8 in [-8, 7]."""
    *lead, kh, n = q.shape
    blocks = q.reshape(*lead, kh // 16, 16, n)
    lo = (blocks & 0x0F).astype(jnp.int8) - 8
    hi = (blocks >> 4).astype(jnp.int8) - 8
    return jnp.concatenate([lo, hi], axis=-2).reshape(*lead, kh * 2, n)


def unpack_q4_unsigned(q: jax.Array) -> jax.Array:
    """(..., K//2, N) packed uint8 -> (..., K, N) uint8 in [0, 15] (q4_1's
    affine quants — no -8 recentering)."""
    *lead, kh, n = q.shape
    blocks = q.reshape(*lead, kh // 16, 16, n)
    lo = blocks & 0x0F
    hi = blocks >> 4
    return jnp.concatenate([lo, hi], axis=-2).reshape(*lead, kh * 2, n)


def pack_q2_k(qt: QTensor) -> QTensor:
    """int8-plane q2_k ([0, 3]) -> nibble-packed "q2_kp" (0.5 B/w value
    plane, the loader default). jit-traceable; byte 16b+j of each 32-row
    block holds rows 32b+j (low) and 32b+16+j (high) — the q4 layout, so
    the kernel unpack is the shared reshape+concat. The per-16 scale and
    mins planes are untouched (value = q*scale + min, q4_1 semantics)."""
    assert qt.kind == "q2_k", qt.kind
    *lead, K, N = qt.q.shape
    b = qt.q.astype(jnp.int32).reshape(*lead, K // 32, 32, N)
    q = (b[..., :16, :] | (b[..., 16:, :] << 4)).astype(jnp.uint8)
    return QTensor(q=q.reshape(*lead, K // 2, N), scales=qt.scales,
                   kind="q2_kp", mins=qt.mins)


def pack_q3_k(qt: QTensor) -> QTensor:
    """int8-plane q3_k ([-4, 3]) -> nibble-packed "q3_kp" storing u = q+4
    in [0, 7] (the loader default). value = (u - 4)*scale."""
    assert qt.kind == "q3_k", qt.kind
    *lead, K, N = qt.q.shape
    u = qt.q.astype(jnp.int32) + 4
    b = u.reshape(*lead, K // 32, 32, N)
    q = (b[..., :16, :] | (b[..., 16:, :] << 4)).astype(jnp.uint8)
    return QTensor(q=q.reshape(*lead, K // 2, N), scales=qt.scales,
                   kind="q3_kp")


def pack_q6_k(qt: QTensor) -> QTensor:
    """int8-plane q6_k -> the true 6-bit device layout "q6_kp": 1.0
    byte/weight at rest instead of 1.25 (int8 plane + f32 per-16 scales).

    ql (K/2, N) uint8 holds block-local nibble pairs — byte j of each
    32-row block packs rows j (low nibble) and j+16 (high nibble), the
    q4_0 convention, so the kernel unpack is the same reshape+concat.
    qh (K/4, N) uint8 rides the ``mins`` slot — byte j of a block holds
    the high 2 bits of rows j, j+8, j+16, j+24 at bit positions 0/2/4/6.
    value = (lo | (hi << 4)) - 32, scales unchanged (per-16)."""
    assert qt.kind == "q6_k", qt.kind
    K, N = qt.q.shape[-2], qt.q.shape[-1]
    u = qt.q.astype(jnp.int32) + 32              # [0, 63]
    b = u.reshape(K // 32, 32, N)
    lo = b & 0x0F
    ql = (lo[:, :16] | (lo[:, 16:] << 4)).astype(jnp.uint8).reshape(K // 2, N)
    hi = b >> 4                                  # [0, 3]
    qh = (hi[:, 0:8] | (hi[:, 8:16] << 2) | (hi[:, 16:24] << 4)
          | (hi[:, 24:32] << 6)).astype(jnp.uint8).reshape(K // 4, N)
    return QTensor(q=ql, scales=qt.scales, kind="q6_kp", mins=qh)


def dequantize(qt: QTensor, dtype=jnp.bfloat16) -> jax.Array:
    """Materialize the logical (.., K, N) weight (XLA ops, any backend).

    Structure-driven: packed-nibble kinds unpack (signed for q4_0,
    unsigned for the affine q4_1/q4_K layout); everything else is an int8
    value plane. The scale block size is K // scales_rows (32 for the
    _0/_1 kinds and folded q4_K/q5_K, 16 for folded q2/q3/q6_K), and a
    ``mins`` plane — when present — adds the affine offset."""
    affine = qt.mins is not None
    if qt.kind == "q4_0":
        vals = unpack_q4(qt.q).astype(dtype)
    elif qt.kind in ("q4_1", "q2_kp"):
        vals = unpack_q4_unsigned(qt.q).astype(dtype)
    elif qt.kind == "q3_kp":
        vals = (unpack_q4_unsigned(qt.q).astype(jnp.int32) - 4).astype(dtype)
    elif qt.kind == "q6_kp":
        lo = unpack_q4_unsigned(qt.q).astype(jnp.int32)
        *lead, kq4, n = qt.mins.shape            # qh plane (K/4, N)
        hb = qt.mins.reshape(*lead, kq4 // 8, 8, n).astype(jnp.int32)
        hi = jnp.concatenate(
            [hb & 3, (hb >> 2) & 3, (hb >> 4) & 3, (hb >> 6) & 3],
            axis=-2).reshape(*lead, kq4 * 4, n)
        vals = ((lo | (hi << 4)) - 32).astype(dtype)
        affine = False                           # mins slot is qh, not m
    elif qt.kind in ("q8_0", "q5_0", "q5_1",
                     "q2_k", "q3_k", "q6_k"):
        vals = qt.q.astype(dtype)
    else:
        raise ValueError(qt.kind)
    k = vals.shape[-2]
    nblocks = qt.scales.shape[-2]
    rep = lambda p: jnp.repeat(p.astype(dtype), k // nblocks,
                               axis=-2)
    out = vals * rep(qt.scales)
    if affine:
        out = out + rep(qt.mins)
    return out
