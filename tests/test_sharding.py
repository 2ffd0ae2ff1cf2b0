"""TP/DP sharding tests on the 8-virtual-device CPU mesh (SURVEY.md §4):
the same pjit program a multi-GPU mesh would run, asserting sharded == single-
device numerics."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_llm.config import LlamaConfig
from tpu_llm.models import llama as M
from tpu_llm.parallel import make_mesh, llama_param_specs, llama_cache_spec, shard_pytree

CFG = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
           vocab_size=256, seq_len=32)


def make_params(seed=0):
    rng = np.random.default_rng(seed)
    d, h, L, V = CFG["dim"], CFG["hidden_dim"], CFG["n_layers"], CFG["vocab_size"]
    kv = d // CFG["n_heads"] * CFG["n_kv_heads"]
    s = lambda *sh: jnp.asarray((rng.standard_normal(sh) * 0.08).astype(np.float32))
    return {
        "tok_emb": s(V, d),
        "final_norm": 1.0 + 0.1 * s(d),
        "wcls": s(d, V),
        "layers": {
            "attn_norm": 1.0 + 0.1 * s(L, d),
            "ffn_norm": 1.0 + 0.1 * s(L, d),
            "wq": s(L, d, d), "wk": s(L, d, kv), "wv": s(L, d, kv),
            "wo": s(L, d, d),
            "w1": s(L, d, h), "w3": s(L, d, h), "w2": s(L, h, d),
        },
    }


def test_eight_devices_available():
    assert jax.device_count() >= 8, "conftest must force 8 CPU devices"


@pytest.mark.parametrize("data,model", [(1, 4), (2, 4), (8, 1)])
def test_sharded_decode_matches_single_device(data, model):
    cfg = LlamaConfig(**CFG)
    params = make_params()
    batch = max(data, 2)
    tokens = jnp.asarray(
        np.random.default_rng(1).integers(0, CFG["vocab_size"], (batch, 4)),
        jnp.int32,
    )

    # single-device reference
    cache0 = M.init_cache(cfg, batch, CFG["seq_len"])
    hidden0, cache0 = M.forward(params, cfg, tokens, cache0, jnp.int32(0))
    logits0, cache0 = M.decode_step(
        params, cfg, tokens[:, -1], cache0, jnp.int32(4)
    )

    # sharded
    mesh = make_mesh(data, model)
    specs = llama_param_specs(cfg)
    p_sh = shard_pytree(params, specs, mesh)
    cache = M.init_cache(cfg, batch, CFG["seq_len"])
    cache = shard_pytree(cache, llama_cache_spec(), mesh)

    fwd = jax.jit(lambda p, t, c: M.forward(p, cfg, t, c, jnp.int32(0)))
    hidden1, cache = fwd(p_sh, tokens, cache)
    step = jax.jit(lambda p, t, c: M.decode_step(p, cfg, t, c, jnp.int32(4)))
    logits1, cache = step(p_sh, tokens[:, -1], cache)

    np.testing.assert_allclose(
        np.asarray(hidden0), np.asarray(hidden1), rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(logits0), np.asarray(logits1), rtol=2e-4, atol=2e-4
    )


def test_sharded_qtensor_decode():
    from tpu_llm.quant.qtensor import quantize_tensor

    cfg = LlamaConfig(**CFG)
    params = make_params(2)
    rng = np.random.default_rng(3)

    # quantize the MLP to q4_0 (stacked per-layer)
    from tpu_llm.quant.qtensor import QTensor

    def quant_stack(w):
        qts = [quantize_tensor(np.asarray(w[l]), "q4_0") for l in range(w.shape[0])]
        return QTensor(
            q=jnp.stack([q.q for q in qts]),
            scales=jnp.stack([q.scales for q in qts]),
            kind="q4_0",
        )

    for key in ("w1", "w3", "w2"):
        params["layers"][key] = quant_stack(params["layers"][key])

    tokens = jnp.asarray([[5, 9]], jnp.int32)
    cache0 = M.init_cache(cfg, 1, CFG["seq_len"])
    h0, _ = M.forward(params, cfg, tokens, cache0, jnp.int32(0))

    mesh = make_mesh(1, 4)  # batch 1 cannot shard on "data"
    p_sh = shard_pytree(params, llama_param_specs(cfg), mesh)
    cache = M.init_cache(cfg, 1, CFG["seq_len"])
    cache = shard_pytree(cache, llama_cache_spec(), mesh)
    h1, _ = jax.jit(lambda p, t, c: M.forward(p, cfg, t, c, jnp.int32(0)))(
        p_sh, tokens, cache
    )
    np.testing.assert_allclose(np.asarray(h0), np.asarray(h1), rtol=2e-4, atol=2e-4)
