import numpy as np
import pytest

import jax.numpy as jnp

from tpu_llm.quant import blocks
from tpu_llm.quant.qtensor import QTensor, quantize_tensor, dequantize, unpack_q4
from tpu_llm.kernels.qmatmul import qmatmul


def test_q4_0_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(256).astype(np.float32)
    buf = blocks.quantize_q4_0(x)
    y = blocks.dequantize_q4_0(buf, 256)
    # max error per block is ~scale/2 = max|x|/16
    for b in range(256 // 32):
        blk = slice(b * 32, (b + 1) * 32)
        bound = np.abs(x[blk]).max() / 8.0
        assert np.abs(x[blk] - y[blk]).max() <= bound


def test_q8_0_roundtrip_tight():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(128).astype(np.float32)
    y = blocks.dequantize_q8_0(blocks.quantize_q8_0(x), 128)
    np.testing.assert_allclose(x, y, atol=np.abs(x).max() / 100)


def test_q4_0_exact_representable():
    # ggml derives d = signed_absmax / -8; include -8d so d is recovered
    # exactly, making every multiple of d in [-8d, 7d] round-trip exactly
    d = 0.5
    q = np.arange(32) % 16 - 8  # in [-8, 7], includes -8
    x = (q * d).astype(np.float32)
    y = blocks.dequantize_q4_0(blocks.quantize_q4_0(x), 32)
    np.testing.assert_allclose(x, y, atol=1e-6)


@pytest.mark.parametrize("kind", ["q4_0", "q8_0", "q4_1", "q5_0", "q5_1"])
def test_qtensor_dequant_matches_block_dequant(kind):
    rng = np.random.default_rng(2)
    K, N = 64, 128
    w = rng.standard_normal((K, N)).astype(np.float32)
    qt = quantize_tensor(w, kind)
    assert qt.shape == (K, N)
    wd = np.asarray(dequantize(qt, jnp.float32))
    # oracle: ggml-order quantize of W^T rows then transpose back
    deq = getattr(blocks, f"dequantize_{kind}")
    quant = getattr(blocks, f"quantize_{kind}")
    expected = deq(quant(np.ascontiguousarray(w.T).reshape(-1)), K * N)
    expected = expected.reshape(N, K).T
    np.testing.assert_allclose(wd, expected, rtol=1e-5, atol=1e-6)


def test_unpack_q4_layout():
    # W[k, n] = k for column 0 -> check block-local pairing survives packing
    K, N = 64, 128
    w = np.zeros((K, N), np.float32)
    w[:, 0] = (np.arange(K) % 16 - 8) * 0.25
    qt = quantize_tensor(w, "q4_0")
    wd = np.asarray(dequantize(qt, jnp.float32))
    np.testing.assert_allclose(wd[:, 0], w[:, 0], atol=1e-6)


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_pallas_qmatmul_interpret_matches_xla(kind, rows):
    """The Triton dequant-matmul (interpret mode) against the f32 matmul
    of the dequantized weight, on the same bf16-rounded activations."""
    rng = np.random.default_rng(3)
    K, N = 128, 256
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((rows, K)), jnp.bfloat16)
    qt = quantize_tensor(w, kind)
    expected = np.asarray(x, np.float32) @ np.asarray(dequantize(qt, jnp.float32))
    got = np.asarray(qmatmul(x, qt.q, qt.scales, interpret=True))
    # each dequantized weight is rounded once to bf16 in registers
    np.testing.assert_allclose(got, expected, rtol=0,
                               atol=1e-2 * np.abs(expected).max())


def test_pallas_qmatmul_3d_input():
    rng = np.random.default_rng(4)
    K, N = 64, 128
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((2, 3, K)), jnp.bfloat16)
    qt = quantize_tensor(w, "q4_0")
    expected = (np.asarray(x, np.float32).reshape(-1, K)
                @ np.asarray(dequantize(qt, jnp.float32)))
    got = np.asarray(qmatmul(x, qt.q, qt.scales, interpret=True))
    assert got.shape == (2, 3, N)
    np.testing.assert_allclose(got.reshape(-1, N), expected, rtol=0,
                               atol=1e-2 * np.abs(expected).max())


def test_q5_0_roundtrip_error_bounded():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(256).astype(np.float32)
    y = blocks.dequantize_q5_0(blocks.quantize_q5_0(x), 256)
    for b in range(256 // 32):
        blk = slice(b * 32, (b + 1) * 32)
        bound = np.abs(x[blk]).max() / 14.0  # half a 5-bit step + f16 scale error
        assert np.abs(x[blk] - y[blk]).max() <= bound


def test_q5_1_roundtrip_error_bounded():
    rng = np.random.default_rng(6)
    x = rng.standard_normal(256).astype(np.float32)
    y = blocks.dequantize_q5_1(blocks.quantize_q5_1(x), 256)
    for b in range(256 // 32):
        blk = slice(b * 32, (b + 1) * 32)
        span = x[blk].max() - x[blk].min()
        assert np.abs(x[blk] - y[blk]).max() <= span / 30.0


def test_q5_0_uses_high_bit():
    # values needing 5 bits: +/-15 around 0 quantize distinguishably
    x = np.linspace(-1.0, 1.0, 32, dtype=np.float32)
    y = blocks.dequantize_q5_0(blocks.quantize_q5_0(x), 32)
    assert len(np.unique(y)) > 16  # 4-bit could represent at most 16 levels


def test_q4_1_roundtrip_error_bounded():
    """Affine q4_1: reconstruction error <= d/2 per element (d spans the
    block range / 15), and constant blocks are exact (m carries them)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(32 * 64).astype(np.float32) * 3 + 1.5
    back = blocks.dequantize_q4_1(blocks.quantize_q4_1(x), x.size)
    step = (x.reshape(-1, 32).max(1) - x.reshape(-1, 32).min(1)) / 15.0
    err = np.abs((back - x).reshape(-1, 32))
    assert (err <= step[:, None] * 0.51 + 1e-3).all()
    const = np.full(64, 2.5, np.float32)
    np.testing.assert_allclose(
        blocks.dequantize_q4_1(blocks.quantize_q4_1(const), 64), const,
        rtol=1e-3)


def test_q4_1_matmul_via_linear_matches_dequant():
    """linear.matmul routes q4_1 to the XLA dequant path (no fused kernel
    for the affine form) and matches an explicit dequant matmul."""
    from tpu_llm.quant.linear import matmul

    rng = np.random.default_rng(8)
    K, N, B = 64, 96, 4
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((B, K)).astype(np.float32))
    qt = quantize_tensor(w, "q4_1")
    got = np.asarray(matmul(x, qt))
    want = np.asarray(x @ dequantize(qt, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_q4_1_fuse_unstack_preserve_mins():
    """Structural param transforms (stack/fuse/unstack) carry the affine
    mins plane."""
    from tpu_llm.models.llama import unstack_layers
    from tpu_llm.quant.convert_params import _quantize_stacked, fuse_llama_layers

    rng = np.random.default_rng(9)
    L, K, N = 2, 64, 32
    layers = {
        "wq": _quantize_stacked(rng.standard_normal((L, K, N)), "q4_1"),
        "wk": _quantize_stacked(rng.standard_normal((L, K, N)), "q4_1"),
        "wv": _quantize_stacked(rng.standard_normal((L, K, N)), "q4_1"),
    }
    fused = fuse_llama_layers(dict(layers, w1=layers["wq"], w3=layers["wk"]))
    assert fused["wqkv"].mins is not None
    assert fused["wqkv"].mins.shape == (L, K // 32, 3 * N)
    un = unstack_layers({"layers": fused, "tok_emb": jnp.zeros((4, 4))})
    per = un["layers"][0]["wqkv"]
    assert per.mins is not None and per.mins.shape == (K // 32, 3 * N)
    np.testing.assert_allclose(np.asarray(per.mins),
                               np.asarray(fused["wqkv"].mins[0]))


def test_q5_matmul_via_linear_matches_dequant():
    from tpu_llm.quant.linear import matmul

    rng = np.random.default_rng(11)
    K, N, B = 64, 96, 4
    x = jnp.asarray(rng.standard_normal((B, K)).astype(np.float32))
    for kind in ("q5_0", "q5_1"):
        qt = quantize_tensor(rng.standard_normal((K, N)).astype(np.float32),
                             kind)
        got = np.asarray(matmul(x, qt))
        want = np.asarray(x @ dequantize(qt, jnp.float32))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5), kind


# -- K-quants (256-weight superblocks, SURVEY addition: the de-facto GGUF
# distribution formats llama.cpp ships) ---------------------------------------

_K_KINDS = ("q2_k", "q3_k", "q4_k", "q5_k", "q6_k")
_K_RMS_TOL = {"q2_k": 0.45, "q3_k": 0.25, "q4_k": 0.09,
              "q5_k": 0.05, "q6_k": 0.03}


@pytest.mark.parametrize("kind", _K_KINDS)
def test_kquant_codec_roundtrip_error_bounded(kind):
    from tpu_llm.quant import blocks as B

    rng = np.random.default_rng(3)
    x = rng.normal(size=16 * 256).astype(np.float32)
    quant = getattr(B, f"quantize_{kind}")
    deq = getattr(B, f"dequantize_{kind}")
    y = deq(quant(x), x.size)
    rel = np.sqrt(((y - x) ** 2).mean()) / x.std()
    assert rel < _K_RMS_TOL[kind], (kind, rel)


def test_q4_k_golden_block():
    """Pin the ggml q4_K bit layout with a hand-built superblock:
    d=1.0, dmin=2.0, sub-scales sc=[1..8], sub-mins m=[0..7],
    qs chosen so weight w[64j+l] = lo nibble, w[64j+32+l] = hi nibble.
    value = d*sc*q - dmin*m (dequantize_row_q4_K)."""
    from tpu_llm.quant import blocks as B

    sc = np.arange(1, 9, dtype=np.uint8)[None, :]
    m = np.arange(0, 8, dtype=np.uint8)[None, :]
    blk = np.zeros((1, B.Q4_K_BLOCK_BYTES), np.uint8)
    blk[0, 0:2] = np.frombuffer(np.float16(1.0).tobytes(), np.uint8)
    blk[0, 2:4] = np.frombuffer(np.float16(2.0).tobytes(), np.uint8)
    blk[0, 4:16] = B._pack_scale_min_k4(sc, m)
    qs = np.arange(128, dtype=np.uint8)
    blk[0, 16:144] = (qs & 0x0F) | (((qs + 3) & 0x0F) << 4)
    y = B.dequantize_q4_k(blk.tobytes(), 256).reshape(8, 32)
    for j in range(4):
        lo_sub, hi_sub = 2 * j, 2 * j + 1
        for el in range(32):
            q_lo = (32 * j + el) & 0x0F
            q_hi = (32 * j + el + 3) & 0x0F
            assert y[lo_sub, el] == pytest.approx(
                1.0 * sc[0, lo_sub] * q_lo - 2.0 * m[0, lo_sub])
            assert y[hi_sub, el] == pytest.approx(
                1.0 * sc[0, hi_sub] * q_hi - 2.0 * m[0, hi_sub])


def test_q6_k_golden_block():
    """Pin the ggml q6_K layout: ql low/high nibbles + qh 2-bit planes,
    16 int8 sub-scales, value = d * sc[i//16] * (q6 - 32)."""
    from tpu_llm.quant import blocks as B

    blk = np.zeros((1, B.Q6_K_BLOCK_BYTES), np.uint8)
    blk[0, 208:210] = np.frombuffer(np.float16(0.5).tobytes(), np.uint8)
    scales = (np.arange(16, dtype=np.int8) - 4)
    blk[0, 192:208] = scales.view(np.uint8)
    # q6 value v = 0..63 cycling by weight index, packed per the spec
    v = (np.arange(256) * 5 % 64).astype(np.uint8)
    for half in range(2):
        c = [v[128 * half + 32 * k: 128 * half + 32 * (k + 1)] for k in range(4)]
        blk[0, 64 * half: 64 * half + 32] = (c[0] & 0xF) | ((c[2] & 0xF) << 4)
        blk[0, 64 * half + 32: 64 * half + 64] = (c[1] & 0xF) | ((c[3] & 0xF) << 4)
        blk[0, 128 + 32 * half: 128 + 32 * half + 32] = (
            (c[0] >> 4) | ((c[1] >> 4) << 2) | ((c[2] >> 4) << 4) | ((c[3] >> 4) << 6))
    y = B.dequantize_q6_k(blk.tobytes(), 256)
    expect = 0.5 * np.repeat(scales, 16).astype(np.float32) * (
        v.astype(np.float32) - 32)
    np.testing.assert_allclose(y, expect, rtol=1e-6)


def test_q3_k_scale_pack_roundtrip():
    from tpu_llm.quant import blocks as B

    rng = np.random.default_rng(5)
    v = rng.integers(-32, 32, (7, 16)).astype(np.int8)
    assert (B._unpack_q3_scales(B._pack_q3_scales(v)) == v).all()


@pytest.mark.parametrize("kind", _K_KINDS)
def test_kquant_qtensor_matches_host_dequant(kind):
    """Device QTensor (folded flat scale planes) dequantizes to exactly
    the host codec's values — the fold is lossless."""
    from tpu_llm.quant import blocks as B
    from tpu_llm.quant.qtensor import dequantize, quantize_tensor

    import os

    rng = np.random.default_rng(7)
    K, N = 512, 64
    w = rng.normal(size=(K, N)).astype(np.float32)
    os.environ["TPU_LLM_KQ_F32S"] = "1"    # exact-fold check (K-quants
    try:                                    # ship bf16 planes by default)
        qt = quantize_tensor(w, kind)
    finally:
        del os.environ["TPU_LLM_KQ_F32S"]
    wd = np.asarray(dequantize(qt, jnp.float32))
    quant = getattr(B, f"quantize_{kind}")
    deq = getattr(B, f"dequantize_{kind}")
    host = deq(quant(np.ascontiguousarray(w.T).reshape(-1)), w.size)
    np.testing.assert_allclose(wd, host.reshape(N, K).T, atol=2e-5)
    # the shipped bf16 planes round the folded products by <= 2^-8 rel.
    qt_b = quantize_tensor(w, kind)
    assert qt_b.scales.dtype == jnp.bfloat16
    wb = np.asarray(dequantize(qt_b, jnp.float32))
    ref = host.reshape(N, K).T
    np.testing.assert_allclose(wb, ref, rtol=1 / 64, atol=3e-2)


@pytest.mark.parametrize("kind", _K_KINDS + ("q4_1", "q5_1"))
def test_kquant_pallas_kernel_interpret(kind, monkeypatch):
    """Kinds the GPU dequant-matmul does not cover take the plain path by
    an explicit choice, also on a GPU: the selection says no and
    linear.matmul matches the XLA dequant matmul."""
    from tpu_llm.kernels import select
    from tpu_llm.quant.linear import matmul
    from tpu_llm.quant.qtensor import dequantize, quantize_tensor

    monkeypatch.setattr(select, "platform", lambda: "gpu")
    rng = np.random.default_rng(9)
    K, N = 512, 128
    w = rng.normal(size=(K, N)).astype(np.float32)
    x = jnp.asarray(rng.normal(size=(3, K)), jnp.bfloat16)
    qt = quantize_tensor(w, kind)
    assert not select.qmatmul(x.dtype, 3, qt)
    ref = np.asarray(x, np.float32) @ np.asarray(
        dequantize(qt, jnp.bfloat16), np.float32)
    got = np.asarray(matmul(x, qt, out_dtype=jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_kquant_gguf_roundtrip_and_native_load():
    """write_gguf(q4_k/q6_k) -> GGUFFile.dequantized matches the codec,
    and the native loader path builds device QTensors with the right
    kinds (q4_K folds to the q4_1 device layout)."""
    import tempfile

    from tpu_llm.io import gguf as gg
    from tpu_llm.quant import blocks as B
    from tpu_llm.quant.qtensor import QTensor, qtensor_from_ggml

    rng = np.random.default_rng(11)
    arr = rng.normal(size=(64, 512)).astype(np.float32)   # (rows, row_len)
    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/t.gguf"
        gg.write_gguf(path, {"general.name": "kq"}, {
            "a.weight": (arr, gg.GGML_Q4_K),
            "b.weight": (arr, gg.GGML_Q6_K),
        })
        f = gg.GGUFFile(path)
        ya = f.dequantized("a.weight")
        expect = B.dequantize_q4_k(
            np.frombuffer(B.quantize_q4_k(arr.reshape(-1)), np.uint8),
            arr.size).reshape(arr.shape)
        np.testing.assert_allclose(ya, expect, atol=1e-6)

        ta = f.tensors["a.weight"]
        qa = qtensor_from_ggml(gg.GGML_Q4_K, f.raw("a.weight"),
                               ta.shape[0], ta.dims[0])
        assert isinstance(qa, QTensor) and qa.kind == "q4_1"
        assert qa.mins is not None and qa.shape == (512, 64)
        tb = f.tensors["b.weight"]
        qb = qtensor_from_ggml(gg.GGML_Q6_K, f.raw("b.weight"),
                               tb.shape[0], tb.dims[0])
        assert qb.kind == "q6_k" and qb.scales.shape == (512 // 16, 64)


def test_kquant_linear_matmul_dispatch():
    """linear.matmul over K-quant QTensors (XLA fallback on CPU) agrees
    with the dequantized dense matmul."""
    from tpu_llm.quant.linear import matmul
    from tpu_llm.quant.qtensor import dequantize, quantize_tensor

    rng = np.random.default_rng(13)
    K, N = 256, 96
    w = rng.normal(size=(K, N)).astype(np.float32)
    x = rng.normal(size=(2, K)).astype(np.float32)
    for kind in _K_KINDS:
        qt = quantize_tensor(w, kind)
        ref = x @ np.asarray(dequantize(qt, jnp.float32))
        got = np.asarray(matmul(jnp.asarray(x), qt, out_dtype=jnp.float32))
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-4), kind


# -- Independent golden decoders for q2_k / q3_k / q5_k ----------------------
# Scalar transcriptions of ggml's dequantize_row_q{2,3,5}_K reference loops
# (written from the ggml-quants.c algorithm description, independent of the
# vectorized codecs in quant/blocks.py). Random bit patterns + hand-pinned
# elements kill the matched encode/decode blind spot for the three kinds
# that previously had only self-inverse coverage (VERDICT r3 item 4).

def _ggml_deq_q2k_scalar(blk: np.ndarray) -> np.ndarray:
    """One 84-byte q2_K block -> 256 floats, ggml scalar order."""
    scales, qs = blk[:16], blk[16:80]
    d = np.frombuffer(blk[80:82].tobytes(), np.float16)[0].astype(np.float32)
    dmin = np.frombuffer(blk[82:84].tobytes(), np.float16)[0].astype(np.float32)
    y = np.zeros(256, np.float32)
    n = 0
    is_ = 0
    for half in range(2):
        q = qs[32 * half: 32 * half + 32]
        shift = 0
        for _j in range(4):
            sc = scales[is_]; is_ += 1
            dl, ml = d * (sc & 0xF), dmin * (sc >> 4)
            for l in range(16):
                y[n] = dl * ((q[l] >> shift) & 3) - ml; n += 1
            sc = scales[is_]; is_ += 1
            dl, ml = d * (sc & 0xF), dmin * (sc >> 4)
            for l in range(16, 32):
                y[n] = dl * ((q[l] >> shift) & 3) - ml; n += 1
            shift += 2
    return y


def _ggml_deq_q3k_scalar(blk: np.ndarray) -> np.ndarray:
    """One 110-byte q3_K block -> 256 floats (ggml aux-word scale unpack)."""
    hmask, qs = blk[:32], blk[32:96]
    aux = np.frombuffer(blk[96:108].tobytes(), "<u4").copy()
    k1, k2 = 0x03030303, 0x0F0F0F0F
    tmp = int(aux[2])
    out = np.zeros(4, "<u4")
    out[0] = (int(aux[0]) & k2) | (((tmp >> 0) & k1) << 4)
    out[1] = (int(aux[1]) & k2) | (((tmp >> 2) & k1) << 4)
    out[2] = ((int(aux[0]) >> 4) & k2) | (((tmp >> 4) & k1) << 4)
    out[3] = ((int(aux[1]) >> 4) & k2) | (((tmp >> 6) & k1) << 4)
    scales = out.view(np.int8).astype(np.int32) - 32
    d_all = np.frombuffer(blk[108:110].tobytes(), np.float16)[0].astype(np.float32)
    y = np.zeros(256, np.float32)
    n = 0
    is_ = 0
    m = 1
    for half in range(2):
        q = qs[32 * half: 32 * half + 32]
        shift = 0
        for _j in range(4):
            dl = d_all * scales[is_]; is_ += 1
            for l in range(16):
                v = int((q[l] >> shift) & 3) - (0 if (hmask[l] & m) else 4)
                y[n] = dl * v; n += 1
            dl = d_all * scales[is_]; is_ += 1
            for l in range(16, 32):
                v = int((q[l] >> shift) & 3) - (0 if (hmask[l] & m) else 4)
                y[n] = dl * v; n += 1
            shift += 2
            m <<= 1
    return y


def _ggml_scale_min_k4(j: int, scales: np.ndarray):
    if j < 4:
        return scales[j] & 63, scales[j + 4] & 63
    return ((scales[j + 4] & 0xF) | ((scales[j - 4] >> 6) << 4),
            (scales[j + 4] >> 4) | ((scales[j] >> 6) << 4))


def _ggml_deq_q5k_scalar(blk: np.ndarray) -> np.ndarray:
    """One 176-byte q5_K block -> 256 floats."""
    d = np.frombuffer(blk[0:2].tobytes(), np.float16)[0].astype(np.float32)
    dmin = np.frombuffer(blk[2:4].tobytes(), np.float16)[0].astype(np.float32)
    scales = blk[4:16]
    qh, ql = blk[16:48], blk[48:176]
    y = np.zeros(256, np.float32)
    n = 0
    is_ = 0
    u1, u2 = 1, 2
    for j in range(0, 256, 64):
        sc, mn = _ggml_scale_min_k4(is_, scales)
        d1, m1 = d * sc, dmin * mn
        sc, mn = _ggml_scale_min_k4(is_ + 1, scales)
        d2, m2 = d * sc, dmin * mn
        q = ql[32 * (j // 64): 32 * (j // 64) + 32]
        for l in range(32):
            y[n] = d1 * ((q[l] & 0xF) + (16 if (qh[l] & u1) else 0)) - m1; n += 1
        for l in range(32):
            y[n] = d2 * ((q[l] >> 4) + (16 if (qh[l] & u2) else 0)) - m2; n += 1
        is_ += 2
        u1 <<= 2
        u2 <<= 2
    return y


def _random_k_block(kind: str, rng) -> np.ndarray:
    """Random bit patterns everywhere except the f16 scale fields, which
    get controlled finite values."""
    from tpu_llm.quant import blocks as B

    nbytes = getattr(B, f"{kind.upper()}_BLOCK_BYTES")
    blk = rng.integers(0, 256, nbytes, dtype=np.uint8)
    d16 = np.frombuffer(np.float16(0.375).tobytes(), np.uint8)
    dmin16 = np.frombuffer(np.float16(-1.5).tobytes(), np.uint8)
    if kind == "q2_k":
        blk[80:82], blk[82:84] = d16, dmin16
    elif kind == "q3_k":
        blk[108:110] = d16
    elif kind == "q5_k":
        blk[0:2], blk[2:4] = d16, dmin16
    return blk


@pytest.mark.parametrize("kind,scalar", [
    ("q2_k", _ggml_deq_q2k_scalar),
    ("q3_k", _ggml_deq_q3k_scalar),
    ("q5_k", _ggml_deq_q5k_scalar),
])
def test_kquant_golden_vs_ggml_scalar(kind, scalar):
    from tpu_llm.quant import blocks as B

    rng = np.random.default_rng(11)
    deq = getattr(B, f"dequantize_{kind}")
    for trial in range(8):
        blk = _random_k_block(kind, rng)
        got = deq(blk.tobytes(), 256)
        expect = scalar(blk)
        np.testing.assert_allclose(got, expect, rtol=1e-6, atol=0,
                                   err_msg=f"{kind} trial {trial}")


def test_q2_k_golden_block_pinned():
    """Hand-pinned q2_K elements: scales byte g = (min<<4)|scale covers
    weights 16g..16g+15; qs byte 32*half+l packs 2-bit fields for shifts
    0/2/4/6 covering weights 128*half + 32j + l."""
    from tpu_llm.quant import blocks as B

    blk = np.zeros(B.Q2_K_BLOCK_BYTES, np.uint8)
    blk[80:82] = np.frombuffer(np.float16(2.0).tobytes(), np.uint8)   # d
    blk[82:84] = np.frombuffer(np.float16(0.5).tobytes(), np.uint8)   # dmin
    for g in range(16):
        blk[g] = ((15 - g) << 4) | (g & 0xF)     # scale=g, min=15-g
    # q value (l + j + half) % 4 at weight 128*half + 32*j + l
    for half in range(2):
        for l in range(32):
            byte = 0
            for j in range(4):
                byte |= ((l + j + half) % 4) << (2 * j)
            blk[16 + 32 * half + l] = byte
    y = B.dequantize_q2_k(blk.tobytes(), 256)
    for n in [0, 15, 16, 31, 40, 127, 128, 200, 255]:
        half, rem = divmod(n, 128)
        j, l = divmod(rem, 32)
        g = n // 16
        expect = 2.0 * g * ((l + j + half) % 4) - 0.5 * (15 - g)
        assert y[n] == pytest.approx(expect), n


def test_q5_k_golden_block_pinned():
    """Hand-pinned q5_K elements: the qh bit planes add +16 to the 4-bit
    lane; value = d*sc*q - dmin*m."""
    from tpu_llm.quant import blocks as B

    sc = np.arange(1, 9, dtype=np.uint8)[None, :]
    m = np.arange(0, 8, dtype=np.uint8)[None, :]
    blk = np.zeros(B.Q5_K_BLOCK_BYTES, np.uint8)
    blk[0:2] = np.frombuffer(np.float16(1.0).tobytes(), np.uint8)
    blk[2:4] = np.frombuffer(np.float16(2.0).tobytes(), np.uint8)
    blk[4:16] = B._pack_scale_min_k4(sc, m)[0]
    # low nibbles l%16, high nibbles (l+5)%16; qh bit 2j set iff l even,
    # bit 2j+1 set iff l divisible by 3
    for l in range(32):
        blk[48 + 0 * 32 + l] = (l % 16) | (((l + 5) % 16) << 4)
        blk[48 + 1 * 32 + l] = (l % 16) | (((l + 5) % 16) << 4)
        blk[48 + 2 * 32 + l] = (l % 16) | (((l + 5) % 16) << 4)
        blk[48 + 3 * 32 + l] = (l % 16) | (((l + 5) % 16) << 4)
        qh = 0
        for j in range(4):
            if l % 2 == 0:
                qh |= 1 << (2 * j)
            if l % 3 == 0:
                qh |= 1 << (2 * j + 1)
        blk[16 + l] = qh
    y = B.dequantize_q5_k(blk.tobytes(), 256)
    for n in [0, 31, 32, 63, 64, 100, 128, 190, 255]:
        j, rem = divmod(n, 64)
        hi, l = divmod(rem, 32)
        sub = 2 * j + hi
        if hi == 0:
            q = (l % 16) + (16 if l % 2 == 0 else 0)
        else:
            q = ((l + 5) % 16) + (16 if l % 3 == 0 else 0)
        expect = 1.0 * sc[0, sub] * q - 2.0 * m[0, sub]
        assert y[n] == pytest.approx(expect), n


def test_pack_q6_k_roundtrip_and_matmul():
    """The 6-bit q6_kp device layout (pack_q6_k): dequantizes EXACTLY like
    the int8 plane it came from, and the projection matches the dense
    matmul."""
    import jax.numpy as jnp

    from tpu_llm.quant.linear import matmul
    from tpu_llm.quant.qtensor import QTensor, dequantize, pack_q6_k

    rng = np.random.default_rng(2)
    K, N = 512, 256
    v = rng.integers(-32, 32, (K, N)).astype(np.int8)
    s = rng.uniform(0.001, 0.01, (K // 16, N)).astype(np.float32)
    qt8 = QTensor(jnp.asarray(v), jnp.asarray(s), "q6_k")
    qtp = pack_q6_k(qt8)
    assert qtp.kind == "q6_kp" and qtp.shape == (K, N)
    assert qtp.q.shape == (K // 2, N) and qtp.mins.shape == (K // 4, N)
    d8 = np.asarray(dequantize(qt8, jnp.float32))
    dp = np.asarray(dequantize(qtp, jnp.float32))
    np.testing.assert_array_equal(d8, dp)
    x = rng.standard_normal((4, K)).astype(np.float32)
    got = np.asarray(matmul(jnp.asarray(x), qtp))
    np.testing.assert_allclose(got, x @ d8, rtol=2e-5, atol=1e-5)


def test_pack_q23_roundtrip_and_matmul():
    """Nibble-packed q2_kp/q3_kp (the loader default): dequantize and the
    projection match the int8-plane layout exactly."""
    import os

    import jax
    from tpu_llm.quant.linear import matmul
    from tpu_llm.quant.qtensor import (dequantize, pack_q2_k, pack_q3_k,
                                       quantize_tensor)

    rng = np.random.default_rng(31)
    K, N = 512, 128
    w = rng.normal(size=(K, N)).astype(np.float32)
    x = rng.normal(size=(3, K)).astype(np.float32)
    for kind, packer in (("q2_k", pack_q2_k), ("q3_k", pack_q3_k)):
        os.environ["TPU_LLM_Q23_INT8"] = "1"
        try:
            qt8 = quantize_tensor(w, kind)
        finally:
            del os.environ["TPU_LLM_Q23_INT8"]
        assert qt8.kind == kind                       # escape hatch layout
        qp = jax.jit(packer)(qt8)
        assert qp.kind == kind + "p"
        assert qp.q.shape == (K // 2, N)
        np.testing.assert_array_equal(
            np.asarray(dequantize(qp, jnp.float32)),
            np.asarray(dequantize(qt8, jnp.float32)))
        # the default quantize_tensor path lands on the packed kind
        qdef = quantize_tensor(w, kind)
        assert qdef.kind == kind + "p"
        ref = x @ np.asarray(dequantize(qdef, jnp.float32))
        got = np.asarray(matmul(jnp.asarray(x), qdef))
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-4)


def test_fold_norms_requant_numerics():
    """fold_norms_requant: rmsnorm weights fold into the projections
    (dense EXACT; quantized via one extra requant rounding). Greedy
    decode through the folded model matches the unfolded one — dense
    exactly, quantized within the requant error (same argmax stream on
    this toy)."""
    import jax
    from tests.test_llama import CFG, make_weights, to_params
    from tpu_llm.config import LlamaConfig
    from tpu_llm.models import llama as M
    from tpu_llm.quant.convert_params import fold_norms_requant

    cfg = LlamaConfig(**CFG)
    params = to_params(make_weights(0))
    tokens = jnp.asarray([[3, 7, 5, 9]], jnp.int32)

    def logits_of(p):
        cache = M.init_cache(cfg, 1, CFG["seq_len"])
        hidden, _ = M.forward(p, cfg, tokens, cache, jnp.int32(0))
        return np.asarray(M.lm_head(p, cfg, hidden))

    ref = logits_of(params)
    folded = fold_norms_requant(params, cfg)         # stacked layers in
    assert folded["layers"]["attn_norm"] is None
    np.testing.assert_allclose(logits_of(folded), ref, rtol=2e-4,
                               atol=2e-4)      # dense fold: exact-ish

    # unstacked input folds to the same values
    unst = fold_norms_requant(M.unstack_layers(params), cfg)
    assert unst["layers"][0]["attn_norm"] is None
    np.testing.assert_allclose(logits_of(unst), logits_of(folded),
                               rtol=1e-6, atol=1e-6)

    # quantized fold: one extra rounding, bounded drift
    from tpu_llm.quant.convert_params import quantize_llama_params

    qparams = quantize_llama_params(
        to_params(make_weights(0)), "q8_0",
        layer_keys=("wq", "wk", "wv"))
    qref = logits_of(qparams)
    qfold = fold_norms_requant(qparams, cfg)
    dq = logits_of(qfold)
    # requant error stays well under the logit scale
    assert np.abs(dq - qref).max() < 0.15 * np.abs(qref).max()
