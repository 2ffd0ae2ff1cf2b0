"""int8 KV cache (tpu_llm.ops.kv_cache): quantization accuracy, cache
update dispatch, end-to-end decode parity vs the f32 cache, and the
sharded variant on the virtual mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_llm.ops.attention import gqa_attention, update_kv_cache
from tpu_llm.ops.kv_cache import QuantKV, quantize_kv, dequantize_kv


def test_quantize_kv_roundtrip():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 5, 4, 64)), jnp.float32)
    q, s = quantize_kv(x)
    back = np.asarray(q, np.float32) * np.asarray(s)[..., None]
    err = np.abs(back - np.asarray(x))
    # per-vector absmax/127 step -> error <= step/2 per element
    bound = np.asarray(s)[..., None] * 0.5 + 1e-7
    assert (err <= bound).all()


def test_quantize_kv_zero_vector():
    q, s = quantize_kv(jnp.zeros((1, 3, 2, 8)))
    assert np.asarray(q).max() == 0
    assert np.asarray(s).max() == 0.0


def test_update_kv_cache_int8_scalar_and_vector_offsets():
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 16, 4, 8
    kc = QuantKV.zeros((B, S, H, D))
    vc = QuantKV.zeros((B, S, H, D))
    k = jnp.asarray(rng.standard_normal((B, 3, H, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, 3, H, D)), jnp.float32)
    kc2, vc2 = update_kv_cache(kc, vc, k, v, jnp.int32(4))
    got = np.asarray(dequantize_kv(kc2))[:, 4:7]
    np.testing.assert_allclose(got, np.asarray(k), atol=2e-2)
    assert np.asarray(dequantize_kv(kc2))[:, :4].max() == 0

    # per-row offsets (continuous batching)
    off = jnp.asarray([0, 9], jnp.int32)
    kc3, vc3 = update_kv_cache(kc, vc, k, v, off)
    d3 = np.asarray(dequantize_kv(kc3))
    np.testing.assert_allclose(d3[0, 0:3], np.asarray(k)[0], atol=2e-2)
    np.testing.assert_allclose(d3[1, 9:12], np.asarray(k)[1], atol=2e-2)


def test_gqa_attention_int8_close_to_f32():
    rng = np.random.default_rng(2)
    B, S, H, Hkv, D, T = 2, 32, 8, 4, 16, 1
    q = jnp.asarray(rng.standard_normal((B, T, H, D)), jnp.float32)
    kf = jnp.asarray(rng.standard_normal((B, S, Hkv, D)), jnp.float32)
    vf = jnp.asarray(rng.standard_normal((B, S, Hkv, D)), jnp.float32)
    pos = jnp.asarray([S - 1], jnp.int32)

    ref = np.asarray(gqa_attention(q, kf, vf, pos))

    kq, ks = quantize_kv(kf)
    vq, vs = quantize_kv(vf)
    got = np.asarray(gqa_attention(q, QuantKV(kq, ks), QuantKV(vq, vs), pos))
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


def test_decode_parity_int8_vs_f32_cache():
    from tpu_llm.config import LlamaConfig
    from tpu_llm.models import llama as M

    cfg = LlamaConfig(dim=32, hidden_dim=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, vocab_size=64, seq_len=32)
    rng = np.random.default_rng(3)
    s = lambda *sh: jnp.asarray(rng.standard_normal(sh) * 0.05, jnp.float32)
    L, E, F, V, KV = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim
    params = {
        "tok_emb": s(V, E), "final_norm": s(E) + 1.0, "wcls": s(E, V),
        "layers": {
            "attn_norm": s(L, E) + 1.0, "ffn_norm": s(L, E) + 1.0,
            "wq": s(L, E, E), "wk": s(L, E, KV), "wv": s(L, E, KV),
            "wo": s(L, E, E), "w1": s(L, E, F), "w3": s(L, E, F),
            "w2": s(L, F, E),
        },
    }
    tokens = jnp.asarray(rng.integers(0, V, (1, 4)), jnp.int32)

    def run(cache_dtype):
        cache = M.init_cache(cfg, 1, cfg.seq_len, dtype=cache_dtype)
        hidden, cache = M.forward(params, cfg, tokens, cache, jnp.int32(0))
        toks = []
        tok = jnp.argmax(M.lm_head(params, cfg, hidden[:, -1:, :])[:, 0], -1)
        for i in range(6):
            toks.append(int(tok[0]))
            logits, cache = M.decode_step(
                params, cfg, tok.astype(jnp.int32), cache, jnp.int32(4 + i))
            tok = jnp.argmax(logits, -1)
        return toks

    assert run(jnp.float32) == run("int8")


def test_int8_cache_sharded_matches_single_device():
    from tpu_llm.config import LlamaConfig
    from tpu_llm.models import llama as M
    from tpu_llm.parallel import (
        make_mesh, llama_param_specs, llama_cache_spec, shard_pytree)

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")

    cfg = LlamaConfig(dim=32, hidden_dim=64, n_layers=2, n_heads=4,
                      n_kv_heads=4, vocab_size=128, seq_len=16)
    rng = np.random.default_rng(4)
    s = lambda *sh: jnp.asarray(rng.standard_normal(sh) * 0.05, jnp.float32)
    L, E, F, V, KV = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim
    params = {
        "tok_emb": s(V, E), "final_norm": s(E) + 1.0, "wcls": s(E, V),
        "layers": {
            "attn_norm": s(L, E) + 1.0, "ffn_norm": s(L, E) + 1.0,
            "wq": s(L, E, E), "wk": s(L, E, KV), "wv": s(L, E, KV),
            "wo": s(L, E, E), "w1": s(L, E, F), "w3": s(L, E, F),
            "w2": s(L, F, E),
        },
    }
    tokens = jnp.asarray(rng.integers(0, V, (2, 4)), jnp.int32)

    def step(params, cache):
        hidden, cache = M.forward(params, cfg, tokens, cache, jnp.int32(0))
        return M.lm_head(params, cfg, hidden[:, -1:, :])[:, 0, :]

    logits_1dev = np.asarray(step(params, M.init_cache(cfg, 2, 16, "int8")))

    mesh = make_mesh(2, 2)
    p_tp = shard_pytree(params, llama_param_specs(cfg), mesh)
    cache = shard_pytree(
        M.init_cache(cfg, 2, 16, "int8"), llama_cache_spec(quant=True), mesh)
    logits_mesh = np.asarray(jax.jit(step)(p_tp, cache))
    np.testing.assert_allclose(logits_mesh, logits_1dev, atol=2e-5, rtol=1e-4)


def test_quantkv_is_donatable_pytree():
    kv = QuantKV.zeros((1, 8, 2, 16))
    leaves, treedef = jax.tree_util.tree_flatten(kv)
    assert len(leaves) == 2
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, QuantKV)


def _int8_prompt_cache(flat: bool, B=1, T=32, S=48, H=8, Hkv=2, D=16):
    rng = np.random.default_rng(9)
    q = jnp.asarray(rng.standard_normal((B, T, H, D)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((B, T, Hkv, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, T, Hkv, D)), jnp.float32)
    kc = QuantKV.zeros((B, S, Hkv, D), flat=flat)
    vc = QuantKV.zeros((B, S, Hkv, D), flat=flat)
    kc, vc = update_kv_cache(kc, vc, k, v, jnp.int32(0))
    return q, kc, vc


def test_flash_prefill_over_dequantized_int8_matches_einsum():
    """The int8-prefill flash route (kernels.attention.prefill_attention
    over a QuantKV cache, as models/llama._attend takes it): the prompt's
    slots are dequantized once to bf16 and run through flash attention;
    this must match the direct int8 einsum attention within bf16
    tolerance, for the flat planes (scales (B, Hkv, S)) and the stacked
    layout's 4D planes (scales (B, S, Hkv)). XLA's implementation of the
    same call stands in for cuDNN, which has no CPU implementation."""
    from tpu_llm.kernels.attention import prefill_attention

    for flat in (True, False):
        q, kc, vc = _int8_prompt_cache(flat)
        positions = jnp.arange(q.shape[1], dtype=jnp.int32)
        expected = gqa_attention(q.astype(jnp.float32), kc, vc, positions)
        got = prefill_attention(q, kc, vc, implementation="xla")
        np.testing.assert_allclose(
            np.asarray(got, np.float32), np.asarray(expected), rtol=0.05,
            atol=0.05)
