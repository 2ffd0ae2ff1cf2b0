"""The selection point (tpu_llm.kernels.select): with the platform
reported as a GPU, each op picks its kernel or the plain path from the
shapes, dtypes and quant kind it can see; elsewhere nothing is selected."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_llm.kernels import select
from tpu_llm.ops.kv_cache import QuantKV
from tpu_llm.ops.paged_kv import PagedKV
from tpu_llm.quant.qtensor import quantize_tensor


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(select, "platform", lambda: "gpu")


def _qt(kind, K=256, N=128):
    rng = np.random.default_rng(0)
    return quantize_tensor(rng.standard_normal((K, N)).astype(np.float32),
                           kind)


@pytest.mark.parametrize("kind,rows,dtype,N,want", [
    ("q4_0", 1, jnp.bfloat16, 128, True),
    ("q8_0", 32, jnp.bfloat16, 128, True),
    ("q4_0", select.QMATMUL_MAX_ROWS, jnp.bfloat16, 128, True),
    ("q4_0", select.QMATMUL_MAX_ROWS + 1, jnp.bfloat16, 128, False),
    ("q4_0", 1, jnp.float32, 128, False),     # f32 runs stay HIGHEST-plain
    ("q4_0", 1, jnp.bfloat16, 96, False),     # N not a multiple of 64
    ("q4_1", 1, jnp.bfloat16, 128, False),    # kind not covered
])
def test_qmatmul_selection(on_gpu, kind, rows, dtype, N, want):
    assert select.qmatmul(dtype, rows, _qt(kind, N=N)) is want


def _dense(B=1, T=1, S=512, dtype=jnp.bfloat16):
    q = jnp.zeros((B, T, 8, 64), dtype)
    return q, jnp.zeros((B, S, 2 * 64), dtype)


@pytest.mark.parametrize("case,want", [
    ("bf16", True), ("f32", False), ("int8", False), ("prefill", False),
    ("odd_cache", False),
])
def test_decode_attention_selection(on_gpu, case, want):
    q, kc = _dense(dtype=jnp.float32 if case == "f32" else jnp.bfloat16)
    if case == "int8":
        kc = QuantKV.zeros((1, 512, 2, 64), flat=True)
    elif case == "prefill":
        q = jnp.zeros((1, 4, 8, 64), jnp.bfloat16)
    elif case == "odd_cache":
        kc = jnp.zeros((1, 500, 128), jnp.bfloat16)
    assert select.decode_attention(q, kc) is want


@pytest.mark.parametrize("case,want", [
    ("from_zero", True), ("short", False), ("offset", False),
    ("int8", True), ("int8_short", False), ("f32", False),
])
def test_prefill_attention_selection(on_gpu, case, want):
    T = (select.PREFILL_MIN_T // 2 if case.endswith("short")
         else select.PREFILL_MIN_T)
    q, kc = _dense(T=T, S=2048,
                   dtype=jnp.float32 if case == "f32" else jnp.bfloat16)
    offset = jnp.int32(7 if case == "offset" else 0)
    if case.startswith("int8"):
        kc = QuantKV.zeros((1, 2048, 2, 64), flat=True)
    assert select.prefill_attention(q, kc, offset) is want


def test_prefill_attention_traced_offset_takes_plain_path(on_gpu):
    """An offset only known at run time (chunked prefill, continuous
    batching) cannot promise position 0: the plain path."""
    q, kc = _dense(T=1024, S=2048)
    seen = []

    @jax.jit
    def f(offset):
        seen.append(select.prefill_attention(q, kc, offset))
        return offset

    f(jnp.int32(0))
    assert seen == [False]


@pytest.mark.parametrize("case,want", [
    ("bf16", True), ("int8", True), ("f32", False), ("odd_block", False),
])
def test_paged_decode_selection(on_gpu, case, want):
    bs = 12 if case == "odd_block" else 16
    dtype = {"bf16": jnp.bfloat16, "f32": jnp.float32, "int8": "int8",
             "odd_block": jnp.bfloat16}[case]
    kv = PagedKV.zeros(n_blocks=9, block_size=bs, batch=2, max_blocks=4,
                       kv_dim=128, dtype=dtype, n_kv_heads=2)
    q = jnp.zeros((2, 1, 8, 64), jnp.bfloat16)
    assert select.paged_decode_attention(q, kv) is want


def test_scoped_disable_and_cpu_select_nothing(monkeypatch):
    q, kc = _dense()
    w = _qt("q4_0")
    # the CPU test backend: no kernel anywhere
    assert not select.qmatmul(jnp.bfloat16, 1, w)
    assert not select.decode_attention(q, kc)
    monkeypatch.setattr(select, "platform", lambda: "gpu")
    assert select.qmatmul(jnp.bfloat16, 1, w)
    with select.kernels_disabled():
        assert not select.qmatmul(jnp.bfloat16, 1, w)
        assert not select.decode_attention(q, kc)
    assert select.decode_attention(q, kc)


def test_importing_the_package_loads_no_other_pallas_backend():
    """Importing every module of the package, and tracing each GPU
    kernel, loads no Pallas backend but the GPU ones."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import jax, jax.numpy as jnp\n"
        "import tpu_llm\n"
        "for m in pkgutil.walk_packages(tpu_llm.__path__, 'tpu_llm.'):\n"
        "    importlib.import_module(m.name)\n"
        "from tpu_llm.kernels import attention as A, qmatmul as Q\n"
        "S = jax.ShapeDtypeStruct\n"
        "bf, i32 = jnp.bfloat16, jnp.int32\n"
        "jax.eval_shape(Q.qmatmul, S((1, 64), bf), S((32, 64), jnp.uint8),"
        " S((2, 64), jnp.float32))\n"
        "jax.eval_shape(A.decode_attention, S((1, 1, 8, 64), bf),"
        " S((1, 256, 128), bf), S((1, 256, 128), bf), S((1,), i32))\n"
        "jax.eval_shape(A.paged_decode_attention, S((1, 1, 8, 64), bf),"
        " S((5, 16, 128), bf), S((5, 16, 128), bf), S((1, 4), i32),"
        " S((1,), i32))\n"
        "pallas = [m.split('.') for m in sys.modules\n"
        "          if m.startswith('jax.experimental.pallas.')]\n"
        "bad = [p for p in pallas if p[3] not in\n"
        "       ('ops', 'triton', 'mosaic_gpu', 'fuser')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**__import__("os").environ,
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr[-2000:]


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_engine_prefill_selects_flash_prefill_on_gpu(on_gpu, monkeypatch,
                                                     cache_dtype):
    """The engines' prefill passes a static zero offset, so on a GPU a
    long prompt over a bf16 or int8 cache takes the flash prefill kernel
    (here the same call on XLA's implementation, counted), and its logits
    match the plain path's."""
    from tpu_llm.config import LlamaConfig
    from tpu_llm.kernels import attention as KA
    from tpu_llm.models import llama as M
    from tpu_llm.runtime.engine import Engine, ModelAdapter

    calls = []
    real = KA.prefill_attention

    def counting(q, k, v):
        calls.append(q.shape)
        return real(q, k, v, implementation="xla")

    monkeypatch.setattr(KA, "prefill_attention", counting)
    cfg = LlamaConfig(dim=256, hidden_dim=96, n_layers=2, n_heads=4,
                      n_kv_heads=2, vocab_size=64, seq_len=1024)
    rng = np.random.default_rng(0)
    s = lambda *sh: jnp.asarray(  # noqa: E731
        rng.standard_normal(sh) * 0.1, jnp.bfloat16)
    L, E, F, KV = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.kv_dim
    params = M.unstack_layers({
        "tok_emb": s(64, E), "final_norm": jnp.ones((E,)),
        "wcls": s(E, 64),
        "layers": {"attn_norm": jnp.ones((L, E)), "ffn_norm": jnp.ones((L, E)),
                   "wq": s(L, E, E), "wk": s(L, E, KV), "wv": s(L, E, KV),
                   "wo": s(L, E, E), "w1": s(L, E, F), "w3": s(L, E, F),
                   "w2": s(L, F, E)}})
    dtype = {"bf16": jnp.bfloat16, "int8": "int8"}[cache_dtype]
    make = lambda: Engine(params, ModelAdapter.llama(  # noqa: E731
        cfg, cache_dtype=dtype, stacked=False), max_seq=1024)
    T = select.PREFILL_MIN_T
    toks = jnp.asarray(rng.integers(3, 64, (1, T)), jnp.int32)
    eng = make()
    logits, _ = eng._prefill(eng.params, toks, jnp.int32(T - 1))
    assert calls == [(1, T, 4, 64)] * L
    with select.kernels_disabled():
        plain = make()
        want, _ = plain._prefill(plain.params, toks, jnp.int32(T - 1))
    assert calls == [(1, T, 4, 64)] * L
    # bf16 activations through two layers; the int8 route rounds the
    # dequantized cache to bf16 where the plain path scales f32 scores
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(logits, np.float32), want,
                               rtol=0, atol=3e-2 * np.abs(want).max())
