"""The GPU kernels lower to Triton for CUDA at TinyLlama-1.1B widths.

``jax.export`` lowers a program for a platform this process does not
have, so the Pallas-to-Triton lowering of every kernel is checked here
on the CPU. What only the card can say (shared memory, registers, the
Triton compile) is checked by ``chip_smoke.py`` and by the ``gpu``
tests, which run with ``python -m pytest -m gpu tests/`` on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.export import DisabledSafetyCheck

from tpu_llm.config import tinyllama_1_1b
from tpu_llm.kernels import attention as KA
from tpu_llm.kernels.qmatmul import qmatmul
from tpu_llm.quant.qtensor import QTensor

CFG = tinyllama_1_1b()
E, F, KV, V = CFG.dim, CFG.hidden_dim, CFG.kv_dim, CFG.vocab_size
H, HKV, D = CFG.n_heads, CFG.n_kv_heads, CFG.head_dim
TRITON = "__gpu$xla.gpu.triton"


def lower_for_cuda(fn, *args) -> str:
    exp = jax.export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[DisabledSafetyCheck.custom_call(TRITON)])(*args)
    return exp.mlir_module()


def _qt(kind, K, N):
    if kind == "q4_0":
        q = jax.ShapeDtypeStruct((K // 2, N), jnp.uint8)
    else:
        q = jax.ShapeDtypeStruct((K, N), jnp.int8)
    return q, jax.ShapeDtypeStruct((K // 32, N), jnp.float32)


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("name,K,N,rows", [
    ("wqkv", E, E + 2 * KV, 1), ("wo", E, E, 8), ("w13", E, 2 * F, 32),
    ("w2", F, E, 1), ("classifier", E, V, 1),
])
def test_qmatmul_lowers_to_triton(kind, name, K, N, rows):
    q, s = _qt(kind, K, N)
    x = jax.ShapeDtypeStruct((rows, K), jnp.bfloat16)
    text = lower_for_cuda(lambda x, q, s: qmatmul(x, q, s), x, q, s)
    assert text.count(TRITON) == 1, name


@pytest.mark.parametrize("B,S", [(1, 1024), (32, 4096)])
def test_decode_attention_lowers_to_triton(B, S):
    q = jax.ShapeDtypeStruct((B, 1, H, D), jnp.bfloat16)
    kc = jax.ShapeDtypeStruct((B, S, HKV * D), jnp.bfloat16)
    pos = jax.ShapeDtypeStruct((B,), jnp.int32)
    text = lower_for_cuda(KA.decode_attention, q, kc, kc, pos)
    assert TRITON in text


@pytest.mark.parametrize("dtype,bs", [("bf16", 16), ("int8", 32)])
def test_paged_decode_attention_lowers_to_triton(dtype, bs):
    B, MB = 8, 4096 // bs
    N = 1 + B * MB
    q = jax.ShapeDtypeStruct((B, 1, H, D), jnp.bfloat16)
    pdt = jnp.bfloat16 if dtype == "bf16" else jnp.int8
    pool = jax.ShapeDtypeStruct((N, bs, HKV * D), pdt)
    sc = (None if dtype == "bf16"
          else jax.ShapeDtypeStruct((HKV, N, bs), jnp.float32))
    table = jax.ShapeDtypeStruct((B, MB), jnp.int32)
    pos = jax.ShapeDtypeStruct((B,), jnp.int32)
    args = (q, pool, pool, table, pos) + (() if sc is None else (sc, sc))
    text = lower_for_cuda(KA.paged_decode_attention, *args)
    assert TRITON in text


@pytest.mark.parametrize("S", [256, 1024, 4096, 4160])
def test_decode_plan_tiles_the_cache(S):
    """Every split is a whole number of kernel blocks, and the grid is
    wide enough to spread a batch-1 row over several programs."""
    k_splits, block_k = KA.decode_plan(S)
    assert S % k_splits == 0 and (S // k_splits) % block_k == 0
    assert k_splits >= (S // 256 if S % 256 == 0 else 2)
    assert KA.decode_plan(S + 1) is None


@pytest.mark.parametrize("M,K,N", [(1, E, E), (1, E, V), (32, F, E),
                                   (512, E, 2 * F)])
def test_qmatmul_plan_fills_the_card(M, K, N):
    """Decode row counts split K until about two waves of programs cover
    the SMs; the split always divides the K loop."""
    from tpu_llm.kernels.qmatmul import _TARGET_PROGRAMS, _plan

    bm, bn, bk, split = _plan("q4_0", M, K, N)
    steps = K // 2 // bk
    assert steps % split == 0 and N % bn == 0
    programs = (N // bn) * (-(-M // bm)) * split
    assert programs >= _TARGET_PROGRAMS or split == steps


@pytest.mark.gpu
def test_qmatmul_compiled_matches_reference(gpu):
    """The compiled kernel (not interpret mode) at TinyLlama's w13."""
    from tpu_llm.quant.qtensor import dequantize

    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.integers(0, 256, (E // 2, 2 * F)), jnp.uint8)
    s = jnp.asarray(rng.uniform(0.001, 0.01, (E // 32, 2 * F)), jnp.float32)
    x = jnp.asarray(rng.standard_normal((8, E)), jnp.bfloat16)
    got = np.asarray(qmatmul(x, q, s))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(x.astype(jnp.float32)
                         @ dequantize(QTensor(q, s, "q4_0"), jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-2 * np.abs(ref).max())
