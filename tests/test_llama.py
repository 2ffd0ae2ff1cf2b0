import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests import reference_impl as ref
from tpu_llm.config import LlamaConfig
from tpu_llm.models import llama as M
from tpu_llm.runtime.engine import Engine, ModelAdapter

CFG = dict(dim=32, hidden_dim=48, n_layers=2, n_heads=4, n_kv_heads=2,
           vocab_size=96, seq_len=16)


def make_weights(seed=0):
    """Random tiny model in (out, in) numpy orientation (oracle layout)."""
    rng = np.random.default_rng(seed)
    d, h, L, V = CFG["dim"], CFG["hidden_dim"], CFG["n_layers"], CFG["vocab_size"]
    kv = d // CFG["n_heads"] * CFG["n_kv_heads"]
    s = lambda *shape: (rng.standard_normal(shape) * 0.08).astype(np.float32)
    return {
        "tok_emb": s(V, d),
        "attn_norm": 1.0 + 0.1 * s(L, d),
        "ffn_norm": 1.0 + 0.1 * s(L, d),
        "wq": s(L, d, d), "wk": s(L, kv, d), "wv": s(L, kv, d), "wo": s(L, d, d),
        "w1": s(L, h, d), "w2": s(L, d, h), "w3": s(L, h, d),
        "final_norm": 1.0 + 0.1 * s(d),
        "wcls": s(V, d),
    }


def to_params(w):
    proj = lambda a: jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1)))
    return {
        "tok_emb": jnp.asarray(w["tok_emb"]),
        "final_norm": jnp.asarray(w["final_norm"]),
        "wcls": jnp.asarray(w["wcls"].T.copy()),
        "layers": {
            "attn_norm": jnp.asarray(w["attn_norm"]),
            "ffn_norm": jnp.asarray(w["ffn_norm"]),
            "wq": proj(w["wq"]), "wk": proj(w["wk"]), "wv": proj(w["wv"]),
            "wo": proj(w["wo"]),
            "w1": proj(w["w1"]), "w2": proj(w["w2"]), "w3": proj(w["w3"]),
        },
    }


def oracle_cfg():
    return dict(CFG, kv_dim=CFG["dim"] // CFG["n_heads"] * CFG["n_kv_heads"])


@pytest.mark.parametrize("rope", ["llmf90", "interleaved"])
def test_decode_matches_fortran_oracle(rope):
    w = make_weights()
    params = to_params(w)
    cfg = LlamaConfig(**CFG, rope_variant=rope)
    oracle = ref.RefLlama(w, oracle_cfg(), rope=rope)

    cache = M.init_cache(cfg, batch=1, max_seq=CFG["seq_len"])
    tokens = [1, 5, 17, 3, 42]
    for pos, tok in enumerate(tokens):
        logits, cache = M.decode_step(
            params, cfg, jnp.asarray([tok], jnp.int32), cache, jnp.int32(pos)
        )
        expected = oracle.step(tok, pos)
        np.testing.assert_allclose(
            np.asarray(logits[0]), expected, rtol=2e-4, atol=2e-4,
            err_msg=f"step {pos} ({rope})",
        )


def test_prefill_equals_stepwise():
    w = make_weights(1)
    params = to_params(w)
    cfg = LlamaConfig(**CFG)
    tokens = [1, 9, 33, 7]

    # stepwise
    cache = M.init_cache(cfg, 1, CFG["seq_len"])
    step_logits = []
    for pos, tok in enumerate(tokens):
        lg, cache = M.decode_step(
            params, cfg, jnp.asarray([tok], jnp.int32), cache, jnp.int32(pos)
        )
        step_logits.append(np.asarray(lg[0]))

    # one prefill pass
    cache2 = M.init_cache(cfg, 1, CFG["seq_len"])
    hidden, cache2 = M.forward(
        params, cfg, jnp.asarray([tokens], jnp.int32), cache2, jnp.int32(0)
    )
    all_logits = np.asarray(M.lm_head(params, cfg, hidden))[0]
    for pos in range(len(tokens)):
        np.testing.assert_allclose(
            all_logits[pos], step_logits[pos], rtol=2e-4, atol=2e-4,
            err_msg=f"pos {pos}",
        )
    # caches must agree on the filled region
    np.testing.assert_allclose(
        np.asarray(cache["k"][:, :, : len(tokens)]),
        np.asarray(cache2["k"][:, :, : len(tokens)]),
        rtol=1e-5, atol=1e-5,
    )


def test_prefill_padding_is_safe():
    """Padded prefill + decode must equal unpadded stepwise decode
    (the engine right-pads prompts to shape buckets)."""
    w = make_weights(2)
    params = to_params(w)
    cfg = LlamaConfig(**CFG)
    tokens = [1, 9, 33]

    # padded prefill of 3 real tokens in an 8-slot buffer, then decode
    padded = tokens + [0] * 5
    cache = M.init_cache(cfg, 1, CFG["seq_len"])
    hidden, cache = M.forward(
        params, cfg, jnp.asarray([padded], jnp.int32), cache, jnp.int32(0)
    )
    lg_padded, cache = M.decode_step(
        params, cfg, jnp.asarray([7], jnp.int32), cache, jnp.int32(3)
    )

    # oracle: plain stepwise
    cache2 = M.init_cache(cfg, 1, CFG["seq_len"])
    for pos, tok in enumerate(tokens + [7]):
        lg_ref, cache2 = M.decode_step(
            params, cfg, jnp.asarray([tok], jnp.int32), cache2, jnp.int32(pos)
        )
    np.testing.assert_allclose(
        np.asarray(lg_padded), np.asarray(lg_ref), rtol=2e-4, atol=2e-4
    )


def test_engine_greedy_matches_oracle_generation():
    w = make_weights(3)
    params = to_params(w)
    cfg = LlamaConfig(**CFG, rope_variant="llmf90")
    adapter = ModelAdapter.llama(cfg, bos_id=1)
    engine = Engine(params, adapter, max_seq=CFG["seq_len"])

    prompt = [5, 11]
    res = engine.generate(prompt, n_total=8, temperature=0.0, seed=0)

    # oracle greedy loop, reference-style: BOS then teacher-forced prompt
    oracle = ref.RefLlama(w, oracle_cfg(), rope="llmf90")
    seq = [1] + prompt
    emitted = []
    pos = 0
    token = seq[0]
    for i in range(8):
        logits = oracle.step(token, pos)
        if pos + 1 < len(seq):
            token = seq[pos + 1]
        else:
            token = int(np.argmax(logits))
        emitted.append(token)
        pos += 1
    assert res.tokens == emitted


def test_engine_scan_matches_loop():
    w = make_weights(4)
    params = to_params(w)
    cfg = LlamaConfig(**CFG)
    adapter = ModelAdapter.llama(cfg, bos_id=1)

    e1 = Engine(params, adapter, max_seq=CFG["seq_len"])
    r1 = e1.generate([3, 4], n_total=9, temperature=0.0, seed=7)
    e2 = Engine(params, adapter, max_seq=CFG["seq_len"])
    r2 = e2.generate([3, 4], n_total=9, temperature=0.0, seed=7, use_scan=True)
    assert r1.tokens == r2.tokens


def test_engine_temperature_deterministic_per_seed():
    w = make_weights(5)
    params = to_params(w)
    cfg = LlamaConfig(**CFG)
    adapter = ModelAdapter.llama(cfg, bos_id=1)
    e1 = Engine(params, adapter, max_seq=CFG["seq_len"])
    r1 = e1.generate([2], n_total=8, temperature=0.9, seed=123)
    e2 = Engine(params, adapter, max_seq=CFG["seq_len"])
    r2 = e2.generate([2], n_total=8, temperature=0.9, seed=123)
    assert r1.tokens == r2.tokens


def test_fused_projections_match_unfused():
    """wqkv/w13 fusion (the reference's layout, read_ggml.f90:265,340) must
    be numerically identical to the unfused path, dense and quantized."""
    import jax.numpy as jnp
    import numpy as np

    from tests.test_sharding import CFG, make_params
    from tpu_llm.config import LlamaConfig
    from tpu_llm.models import llama as M
    from tpu_llm.quant.convert_params import fuse_llama_layers, quantize_llama_params

    cfg = LlamaConfig(**CFG)
    params = make_params(21)
    tokens = jnp.asarray(
        np.random.default_rng(9).integers(0, CFG["vocab_size"], (2, 4)), jnp.int32
    )

    cache0 = M.init_cache(cfg, 2, CFG["seq_len"])
    h0, _ = M.forward(params, cfg, tokens, cache0, jnp.int32(0))

    fused = dict(params, layers=fuse_llama_layers(params["layers"]))
    assert "wqkv" in fused["layers"] and "w13" in fused["layers"]
    cache1 = M.init_cache(cfg, 2, CFG["seq_len"])
    h1, _ = M.forward(fused, cfg, tokens, cache1, jnp.int32(0))
    np.testing.assert_allclose(np.asarray(h0), np.asarray(h1), rtol=1e-6, atol=1e-6)

    # quantized: fused-then-quantized == quantized-then-fused == same values
    qp = quantize_llama_params(params, "q4_0", fuse=True)
    cache2 = M.init_cache(cfg, 2, CFG["seq_len"])
    h2, _ = M.forward(qp, cfg, tokens, cache2, jnp.int32(0))
    qp2 = quantize_llama_params(params, "q4_0", fuse=False)
    cache3 = M.init_cache(cfg, 2, CFG["seq_len"])
    h3, _ = M.forward(qp2, cfg, tokens, cache3, jnp.int32(0))
    np.testing.assert_allclose(np.asarray(h2), np.asarray(h3), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cache_dtype", [jnp.float32, "int8"])
def test_kv_window_decode_matches_full(cache_dtype):
    """decode_step(kv_window=w) attends only to cache slots [0, w); for
    positions < w the result is identical to full-cache attention (the
    dropped slots carry exactly zero softmax weight)."""
    w8 = make_weights(41)
    params = to_params(w8)
    cfg = LlamaConfig(**CFG)
    pu = M.unstack_layers(dict(params, layers=dict(params["layers"])))

    tokens = jnp.asarray([[3, 17, 42], [9, 9, 1]], jnp.int32)
    c_a = M.init_cache(cfg, 2, CFG["seq_len"], dtype=cache_dtype, stacked=False)
    c_b = M.init_cache(cfg, 2, CFG["seq_len"], dtype=cache_dtype, stacked=False)
    _, c_a = M.forward(pu, cfg, tokens, c_a, jnp.int32(0))
    _, c_b = M.forward(pu, cfg, tokens, c_b, jnp.int32(0))

    tok = jnp.asarray([7, 12], jnp.int32)
    for step in range(3):
        pos = jnp.int32(3 + step)
        lg_a, c_a = M.decode_step(pu, cfg, tok, c_a, pos)
        lg_b, c_b = M.decode_step(pu, cfg, tok, c_b, pos, kv_window=8)
        np.testing.assert_allclose(np.asarray(lg_b), np.asarray(lg_a),
                                   rtol=1e-6, atol=1e-6)
        tok = jnp.argmax(lg_a, -1).astype(jnp.int32)


def test_fold_rope_interleave_matches():
    """fold_rope_interleave: permuted wq/wk + neox rotation produce the
    same logits as interleaved rope on the original weights (dot products
    are permutation-invariant; only f32 summation order differs)."""
    from tpu_llm.quant.convert_params import fold_rope_interleave

    w = make_weights(31)
    params = to_params(w)
    cfg = LlamaConfig(**CFG, rope_variant="interleaved")
    pf, cf = fold_rope_interleave(params, cfg)
    assert cf.rope_variant == "neox"

    tokens = jnp.asarray([[3, 17, 42, 8], [9, 9, 1, 77]], jnp.int32)
    c0 = M.init_cache(cfg, 2, CFG["seq_len"])
    c1 = M.init_cache(cf, 2, CFG["seq_len"])
    h0, c0 = M.forward(params, cfg, tokens, c0, jnp.int32(0))
    h1, c1 = M.forward(pf, cf, tokens, c1, jnp.int32(0))
    np.testing.assert_allclose(np.asarray(h1), np.asarray(h0),
                               rtol=1e-5, atol=1e-5)
    tok = jnp.asarray([7, 12], jnp.int32)
    lg0, _ = M.decode_step(params, cfg, tok, c0, jnp.int32(4))
    lg1, _ = M.decode_step(pf, cf, tok, c1, jnp.int32(4))
    np.testing.assert_allclose(np.asarray(lg1), np.asarray(lg0),
                               rtol=1e-5, atol=1e-5)
    # quantized + fused layout: permutation acts on QTensor column planes
    # (the sharding fixture's dims are q4-blockable; this file's are not)
    from tests.test_sharding import CFG as QCFG, make_params
    from tpu_llm.quant.convert_params import quantize_llama_params

    qcfg = LlamaConfig(**QCFG, rope_variant="interleaved")
    pq = quantize_llama_params(make_params(5), "q4_0", fuse=True)
    pqf, cqf = fold_rope_interleave(pq, qcfg)
    qt = jnp.asarray([[3, 17, 42, 8]], jnp.int32)
    cq0 = M.init_cache(qcfg, 1, QCFG["seq_len"])
    cq1 = M.init_cache(cqf, 1, QCFG["seq_len"])
    hq0, _ = M.forward(pq, qcfg, qt, cq0, jnp.int32(0))
    hq1, _ = M.forward(pqf, cqf, qt, cq1, jnp.int32(0))
    np.testing.assert_allclose(np.asarray(hq1), np.asarray(hq0),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cache_dtype", [jnp.float32, "int8"])
def test_flat_unstacked_cache_matches_stacked(cache_dtype):
    """Unstacked caches store flat (B, S, Hkv*D) planes (in-place updates
    ); numerics must match the stacked 4D path
    exactly (dense) / exactly (int8: same quantization, different plane
    layout)."""
    w = make_weights(11)
    params = to_params(w)
    cfg = LlamaConfig(**CFG)
    pu = M.unstack_layers(dict(params, layers=dict(params["layers"])))

    tokens = jnp.asarray([[3, 17, 42], [9, 9, 1]], jnp.int32)
    c_s = M.init_cache(cfg, 2, CFG["seq_len"], dtype=cache_dtype)
    c_u = M.init_cache(cfg, 2, CFG["seq_len"], dtype=cache_dtype,
                       stacked=False)
    h_s, c_s = M.forward(params, cfg, tokens, c_s, jnp.int32(0))
    h_u, c_u = M.forward(pu, cfg, tokens, c_u, jnp.int32(0))
    np.testing.assert_allclose(np.asarray(h_s), np.asarray(h_u),
                               rtol=1e-5, atol=1e-5)

    nxt = jnp.asarray([[7], [12]], jnp.int32)
    h_s2, _ = M.forward(params, cfg, nxt, c_s, jnp.int32(3))
    h_u2, _ = M.forward(pu, cfg, nxt, c_u, jnp.int32(3))
    np.testing.assert_allclose(np.asarray(h_s2), np.asarray(h_u2),
                               rtol=1e-5, atol=1e-5)


def test_qwen2_gguf_load_and_decode(tmp_path):
    """Qwen2-family GGUF: NeoX rope, QKV bias tensors, tied embeddings
    (no output.weight). The bias path is additive-only: a zero-bias
    qwen2 file produces the exact logits of the same tensors without
    bias entries."""
    import numpy as np

    from tpu_llm.io import gguf as gg
    from tpu_llm.models import llama as M

    rng = np.random.default_rng(4)
    dim, hidden, L, H, KVH, V = 64, 96, 2, 4, 2, 48
    kv = dim // H * KVH
    s = lambda *sh: (rng.standard_normal(sh) * 0.08).astype(np.float32)

    def meta(arch):
        return {
            "general.architecture": arch,
            f"{arch}.block_count": L,
            f"{arch}.embedding_length": dim,
            f"{arch}.feed_forward_length": hidden,
            f"{arch}.attention.head_count": H,
            f"{arch}.attention.head_count_kv": KVH,
            f"{arch}.context_length": 128,
            f"{arch}.rope.freq_base": 10000.0,
            f"{arch}.attention.layer_norm_rms_epsilon": 1e-5,
            "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>"]
            + [f"t{i}" for i in range(V - 3)],
            "tokenizer.ggml.scores": np.zeros((V,), np.float32),
        }

    def tensors(biases):
        t = {"token_embd.weight": s(V, dim),
             "output_norm.weight": 1.0 + 0.1 * s(dim)}
        for i in range(L):
            t[f"blk.{i}.attn_norm.weight"] = 1.0 + 0.1 * s(dim)
            t[f"blk.{i}.ffn_norm.weight"] = 1.0 + 0.1 * s(dim)
            t[f"blk.{i}.attn_q.weight"] = s(dim, dim)
            t[f"blk.{i}.attn_k.weight"] = s(kv, dim)
            t[f"blk.{i}.attn_v.weight"] = s(kv, dim)
            t[f"blk.{i}.attn_output.weight"] = s(dim, dim)
            t[f"blk.{i}.ffn_gate.weight"] = s(hidden, dim)
            t[f"blk.{i}.ffn_up.weight"] = s(hidden, dim)
            t[f"blk.{i}.ffn_down.weight"] = s(dim, hidden)
            if biases == "zero":
                t[f"blk.{i}.attn_q.bias"] = np.zeros((dim,), np.float32)
                t[f"blk.{i}.attn_k.bias"] = np.zeros((kv,), np.float32)
                t[f"blk.{i}.attn_v.bias"] = np.zeros((kv,), np.float32)
            elif biases == "random":
                t[f"blk.{i}.attn_q.bias"] = s(dim)
                t[f"blk.{i}.attn_k.bias"] = s(kv)
                t[f"blk.{i}.attn_v.bias"] = s(kv)
        return t

    rng = np.random.default_rng(4)
    t_zero = tensors("zero")
    rng = np.random.default_rng(4)
    t_none = tensors("none")
    rng = np.random.default_rng(4)
    t_rand = tensors("random")

    paths = {}
    for name, t in (("zero", t_zero), ("none", t_none), ("rand", t_rand)):
        p = str(tmp_path / f"q2_{name}.gguf")
        gg.write_gguf(p, meta("qwen2"), t)
        paths[name] = p

    params, cfg = M.load_gguf(paths["rand"])
    assert cfg.rope_variant == "neox" and cfg.use_bias and cfg.tie_embeddings
    assert params["wcls"] is None and "bq" in params["layers"]

    toks = jnp.asarray([[1, 5, 9]], jnp.int32)

    def run(path):
        p, c = M.load_gguf(path)
        cache = M.init_cache(c, 1, 32)
        h, _ = M.forward(p, c, toks, cache, jnp.int32(0))
        return np.asarray(M.lm_head(p, c, h))

    np.testing.assert_allclose(run(paths["zero"]), run(paths["none"]),
                               rtol=1e-6, atol=1e-6)
    assert np.abs(run(paths["rand"]) - run(paths["none"])).max() > 1e-3


def test_gemma_gguf_load_and_decode(tmp_path):
    """Gemma-family GGUF: explicit head_dim (q width != dim), (1 + w)
    RMSNorm folding at load, GeGLU mlp, sqrt(dim) embedding scale, NeoX
    rope, tied embeddings."""
    import numpy as np

    from tpu_llm.io import gguf as gg
    from tpu_llm.models import llama as M

    rng = np.random.default_rng(6)
    dim, hidden, L, H, KVH, V, HD = 48, 64, 2, 4, 2, 32, 24  # q width 96
    s = lambda *sh: (rng.standard_normal(sh) * 0.08).astype(np.float32)
    meta = {
        "general.architecture": "gemma",
        "gemma.block_count": L,
        "gemma.embedding_length": dim,
        "gemma.feed_forward_length": hidden,
        "gemma.attention.head_count": H,
        "gemma.attention.head_count_kv": KVH,
        "gemma.attention.key_length": HD,
        "gemma.attention.value_length": HD,
        "gemma.context_length": 128,
        "gemma.attention.layer_norm_rms_epsilon": 1e-6,
        "tokenizer.ggml.tokens": ["<pad>", "<s>", "</s>"]
        + [f"t{i}" for i in range(V - 3)],
        "tokenizer.ggml.scores": np.zeros((V,), np.float32),
    }
    norm0 = 0.25 + 0.0 * s(dim)
    t = {"token_embd.weight": s(V, dim), "output_norm.weight": norm0}
    for i in range(L):
        t[f"blk.{i}.attn_norm.weight"] = 0.1 * s(dim)
        t[f"blk.{i}.ffn_norm.weight"] = 0.1 * s(dim)
        t[f"blk.{i}.attn_q.weight"] = s(H * HD, dim)
        t[f"blk.{i}.attn_k.weight"] = s(KVH * HD, dim)
        t[f"blk.{i}.attn_v.weight"] = s(KVH * HD, dim)
        t[f"blk.{i}.attn_output.weight"] = s(dim, H * HD)
        t[f"blk.{i}.ffn_gate.weight"] = s(hidden, dim)
        t[f"blk.{i}.ffn_up.weight"] = s(hidden, dim)
        t[f"blk.{i}.ffn_down.weight"] = s(dim, hidden)
    path = str(tmp_path / "gemma.gguf")
    gg.write_gguf(path, meta, t)

    params, cfg = M.load_gguf(path)
    assert cfg.head_dim == HD and cfg.q_dim == H * HD != cfg.dim
    assert cfg.kv_dim == KVH * HD
    assert cfg.act == "gelu" and cfg.rope_variant == "neox"
    assert cfg.emb_scale == pytest.approx(dim ** 0.5)
    assert cfg.tie_embeddings and params["wcls"] is None
    # (1 + w) fold
    np.testing.assert_allclose(np.asarray(params["final_norm"]),
                               1.0 + norm0, rtol=1e-6)

    cache = M.init_cache(cfg, 1, 32)
    toks = jnp.asarray([[1, 4, 7]], jnp.int32)
    h, cache = M.forward(params, cfg, toks, cache, jnp.int32(0))
    logits = np.asarray(M.lm_head(params, cfg, h))
    assert logits.shape == (1, 3, V) and np.isfinite(logits).all()
    # greedy decode continues without shape errors
    tok = jnp.asarray([int(logits[0, -1].argmax())], jnp.int32)
    lg, cache = M.decode_step(params, cfg, tok, cache, jnp.int32(3))
    assert lg.shape == (1, V) and np.isfinite(np.asarray(lg)).all()

    # the embedding scale is load-bearing: rebuilding with emb_scale=1
    # changes the logits
    import dataclasses as dc
    cfg1 = dc.replace(cfg, emb_scale=1.0)
    h1, _ = M.forward(params, cfg1, toks, M.init_cache(cfg1, 1, 32),
                      jnp.int32(0))
    assert np.abs(np.asarray(M.lm_head(params, cfg1, h1)) - logits).max() > 1e-3
