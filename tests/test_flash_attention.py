"""GPU attention kernels against the plain einsum attention.

The decode kernel runs in Pallas interpret mode. cuDNN flash prefill has
no CPU implementation, so its wrapper is checked here through the same
``jax.nn.dot_product_attention`` call on XLA's implementation; the cuDNN
numbers come from ``chip_smoke.py`` on the card.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_llm.kernels.attention import decode_attention, prefill_attention
from tpu_llm.ops.attention import gqa_attention, update_kv_cache


def make(B=2, T=32, S=64, H=4, Hkv=2, D=16, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return (jnp.asarray(q, dtype), jnp.asarray(k, dtype),
            jnp.asarray(v, dtype))


def f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("extra_slots", [0, 7, 30])
def test_flash_matches_einsum(extra_slots):
    """Prefill from position 0 over a cache longer than the prompt: slots
    past T are never attended (causal), whatever they hold."""
    q, k, v = make(S=32 + extra_slots)
    positions = jnp.arange(32, dtype=jnp.int32)
    expected = gqa_attention(q, k, v, positions)
    got = prefill_attention(q, k, v, implementation="xla")
    np.testing.assert_allclose(f32(got), f32(expected), rtol=2e-5,
                               atol=2e-5)


def test_flash_single_tile():
    q, k, v = make(B=1, T=8, S=8, H=2, Hkv=1, D=8, seed=1)
    positions = jnp.arange(8, dtype=jnp.int32)
    expected = gqa_attention(q, k, v, positions)
    got = prefill_attention(q, k.reshape(1, 8, 8), v.reshape(1, 8, 8),
                            implementation="xla")      # flat cache planes
    np.testing.assert_allclose(f32(got), f32(expected), rtol=2e-5,
                               atol=2e-5)


def test_flash_mha_large_blocks():
    q, k, v = make(B=1, T=64, S=128, H=2, Hkv=2, D=32, seed=2)
    positions = jnp.arange(64, dtype=jnp.int32)
    expected = gqa_attention(q, k, v, positions)
    got = prefill_attention(q, k, v, implementation="xla")
    np.testing.assert_allclose(f32(got), f32(expected), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("pos", [0, 3, 77, 511])
def test_flash_decode_matches_einsum(pos):
    q, k, v = make(B=2, T=1, S=512, H=8, Hkv=2, D=64, seed=2,
                   dtype=jnp.bfloat16)
    positions = jnp.full((2,), pos, jnp.int32)
    expected = gqa_attention(q.astype(jnp.float32), k.astype(jnp.float32),
                             v.astype(jnp.float32),
                             jnp.asarray([[pos], [pos]], jnp.int32))
    got = decode_attention(q, k, v, positions, interpret=True)
    # bf16 probabilities in the p.v product: ~2^-8 relative
    np.testing.assert_allclose(f32(got), f32(expected), rtol=2e-2,
                               atol=2e-2)


def test_flash_decode_per_row_positions():
    q, k, v = make(B=3, T=1, S=256, H=4, Hkv=4, D=64, seed=3,
                   dtype=jnp.bfloat16)
    positions = jnp.asarray([5, 130, 255], jnp.int32)
    expected = gqa_attention(q.astype(jnp.float32), k.astype(jnp.float32),
                             v.astype(jnp.float32), positions[:, None])
    # flat (B, S, Hkv*D) planes, as the unstacked cache stores them
    got = decode_attention(q, k.reshape(3, 256, -1), v.reshape(3, 256, -1),
                           positions, interpret=True)
    np.testing.assert_allclose(f32(got), f32(expected), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("pos", [0, 5, 7, 8, 63, 190])
@pytest.mark.parametrize("batch", [1, 2])
def test_decode_after_write_matches_einsum(pos, batch):
    """Decode as the model runs it: this step's k/v written into the flat
    cache at ``pos``, then the flash-decode kernel over the updated cache,
    equals the einsum over the same cache; the slot at ``pos`` is the one
    just written and slots past it stay invisible."""
    B, S, H, Hkv, D = batch, 256, 8, 2, 64
    rng = np.random.default_rng(1000 + pos)
    bf = jnp.bfloat16
    q = jnp.asarray(rng.standard_normal((B, 1, H, D)), bf)
    kc = jnp.asarray(rng.standard_normal((B, S, Hkv * D)), bf)
    vc = jnp.asarray(rng.standard_normal((B, S, Hkv * D)), bf)
    k_cur = jnp.asarray(rng.standard_normal((B, 1, Hkv, D)), bf)
    v_cur = jnp.asarray(rng.standard_normal((B, 1, Hkv, D)), bf)
    kc, vc = update_kv_cache(kc, vc, k_cur, v_cur, jnp.int32(pos))
    np.testing.assert_array_equal(
        f32(kc[:, pos]), f32(k_cur.reshape(B, Hkv * D)))

    positions = jnp.full((B,), pos, jnp.int32)
    expected = gqa_attention(q.astype(jnp.float32),
                             kc.astype(jnp.float32).reshape(B, S, Hkv, D),
                             vc.astype(jnp.float32).reshape(B, S, Hkv, D),
                             positions[:, None])
    got = decode_attention(q, kc, vc, positions, interpret=True)
    np.testing.assert_allclose(f32(got), f32(expected), rtol=2e-2,
                               atol=2e-2)


def test_flash_decode_multistep_parity(monkeypatch):
    """Chained decode steps of the model with the flash-decode kernel
    selected (interpret mode) equal the plain einsum decode over a whole
    token sequence (the in-model usage pattern)."""
    import jax

    from tpu_llm.config import LlamaConfig
    from tpu_llm.kernels import attention as KA
    from tpu_llm.kernels import select
    from tpu_llm.models import llama as M

    cfg = LlamaConfig(dim=256, hidden_dim=96, n_layers=2, n_heads=4,
                      n_kv_heads=2, vocab_size=64, seq_len=64)
    rng = np.random.default_rng(7)
    s = lambda *sh: jnp.asarray(  # noqa: E731
        rng.standard_normal(sh) * 0.05, jnp.bfloat16)
    L, E, F, KV = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.kv_dim
    params = M.unstack_layers({
        "tok_emb": s(64, E), "final_norm": jnp.ones((E,)), "wcls": s(E, 64),
        "layers": {"attn_norm": jnp.ones((L, E)), "ffn_norm": jnp.ones((L, E)),
                   "wq": s(L, E, E), "wk": s(L, E, KV), "wv": s(L, E, KV),
                   "wo": s(L, E, E), "w1": s(L, E, F), "w3": s(L, E, F),
                   "w2": s(L, F, E)}})
    real = KA.decode_attention
    calls = []

    def interpreted(q, k, v, positions):
        calls.append(q.shape)
        return real(q, k, v, positions, interpret=True)

    monkeypatch.setattr(KA, "decode_attention", interpreted)
    plain = jax.jit(lambda p, t, c, pos: M.decode_step(p, cfg, t, c, pos))
    cache_p = M.init_cache(cfg, 1, 64, jnp.bfloat16, stacked=False)
    cache_k = M.init_cache(cfg, 1, 64, jnp.bfloat16, stacked=False)
    toks = [1, 5, 9, 3, 60, 7, 7, 2, 33, 11]
    want = []
    for pos, t in enumerate(toks):
        lg, cache_p = plain(params, jnp.asarray([t], jnp.int32), cache_p,
                            jnp.int32(pos))
        want.append(np.asarray(lg, np.float32))
    monkeypatch.setattr(select, "platform", lambda: "gpu")
    kern = jax.jit(lambda p, t, c, pos: M.decode_step(p, cfg, t, c, pos))
    for pos, t in enumerate(toks):
        lg, cache_k = kern(params, jnp.asarray([t], jnp.int32), cache_k,
                           jnp.int32(pos))
        np.testing.assert_allclose(np.asarray(lg, np.float32), want[pos],
                                   rtol=2e-2, atol=2e-2)
    assert calls == [(1, 1, 4, 64)] * L      # traced once, every layer
