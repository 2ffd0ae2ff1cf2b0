import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests import reference_impl as ref
from tpu_llm.ops.norms import rmsnorm, layernorm
from tpu_llm.ops.rope import apply_rope
from tpu_llm.ops.sampling import masked_softmax, greedy, sample_token


def test_rmsnorm_matches_fortran_semantics():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(64).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    expected = ref.rmsnorm(x, w)
    got = np.asarray(rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)


def test_rmsnorm_batched():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    got = np.asarray(rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    for i in range(2):
        for j in range(3):
            np.testing.assert_allclose(
                got[i, j], ref.rmsnorm(x[i, j], w), rtol=1e-5, atol=1e-6
            )


def test_layernorm():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(48).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    mu, var = x.mean(), x.var()
    expected = (x - mu) / np.sqrt(var + 1e-5) * w + b
    got = np.asarray(layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("variant", ["llmf90", "interleaved"])
@pytest.mark.parametrize("pos", [0, 1, 7])
def test_rope_variants_match_scalar_loop(variant, pos):
    rng = np.random.default_rng(3)
    H, D = 4, 16
    x = rng.standard_normal((1, 1, H, D)).astype(np.float32)
    flat = x.reshape(H * D)
    fn = ref.rope_llmf90 if variant == "llmf90" else ref.rope_interleaved
    expected = fn(flat, pos, D).reshape(1, 1, H, D)
    got = np.asarray(
        apply_rope(jnp.asarray(x), jnp.asarray([pos], dtype=jnp.int32), variant=variant)
    )
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-5)


def test_rope_neox_pairs():
    # neox rotates (j, j+rot/2); pos 0 must be identity
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 1, 2, 8)).astype(np.float32)
    got = np.asarray(apply_rope(jnp.asarray(x), jnp.asarray([0]), variant="neox"))
    np.testing.assert_allclose(got, x, rtol=1e-6)


def test_rope_partial_dims_passthrough():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 1, 2, 16)).astype(np.float32)
    got = np.asarray(
        apply_rope(jnp.asarray(x), jnp.asarray([3]), variant="neox", rope_dims=8)
    )
    np.testing.assert_allclose(got[..., 8:], x[..., 8:], rtol=1e-6)
    assert not np.allclose(got[..., :8], x[..., :8])


def test_masked_softmax_matches_truncation():
    rng = np.random.default_rng(6)
    x = rng.standard_normal(32).astype(np.float32)
    for n in (1, 5, 32):
        expected = ref.softmax_trunc(x, n)
        got = np.asarray(masked_softmax(jnp.asarray(x), n))
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-7)


def test_greedy_first_max():
    x = jnp.asarray([0.0, 3.0, 3.0, 1.0])
    assert int(greedy(x)) == 1


def test_sample_temperature_zero_is_greedy():
    key = jax.random.PRNGKey(0)
    logits = jnp.asarray([[0.1, 2.0, -1.0]])
    tok = sample_token(key, logits, temperature=0.0)
    assert int(tok[0]) == 1


def test_sample_cdf_statistics():
    key = jax.random.PRNGKey(0)
    logits = jnp.log(jnp.asarray([0.7, 0.2, 0.1]))
    keys = jax.random.split(key, 512)
    toks = jax.vmap(lambda k: sample_token(k, logits, temperature=1.0))(keys)
    counts = np.bincount(np.asarray(toks), minlength=3) / 512
    np.testing.assert_allclose(counts, [0.7, 0.2, 0.1], atol=0.08)


def test_sample_top_k():
    key = jax.random.PRNGKey(0)
    logits = jnp.asarray([5.0, 4.0, -10.0, -10.0])
    keys = jax.random.split(key, 64)
    toks = jax.vmap(lambda k: sample_token(k, logits, temperature=1.0, top_k=2))(keys)
    assert set(np.asarray(toks).tolist()) <= {0, 1}


def test_rope_table_matches_apply_rope():
    import jax.numpy as jnp
    import numpy as np

    from tpu_llm.ops.rope import apply_rope, apply_rope_table, rope_table

    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((2, 3, 4, 16)), jnp.float32)
    positions = jnp.asarray([5, 6, 7], jnp.int32)
    for variant in ("interleaved", "neox", "llmf90"):
        table = rope_table(32, 16, 10000.0, variant)
        direct = apply_rope(x, positions, 10000.0, variant)
        via_table = apply_rope_table(x, table, positions, variant)
        np.testing.assert_array_equal(
            np.asarray(direct), np.asarray(via_table))


def test_rope_table_partial_dims():
    import jax.numpy as jnp
    import numpy as np

    from tpu_llm.ops.rope import apply_rope, apply_rope_table, rope_table

    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.standard_normal((1, 2, 2, 32)), jnp.float32)
    positions = jnp.asarray([0, 9], jnp.int32)
    table = rope_table(16, 32, 10000.0, "neox", rope_dims=16)
    direct = apply_rope(x, positions, 10000.0, "neox", rope_dims=16)
    via = apply_rope_table(x, table, positions, "neox", rope_dims=16)
    np.testing.assert_array_equal(np.asarray(direct), np.asarray(via))


# ---- RoPE context-extension scaling ------------------------------------

def test_rope_linear_scaling_closed_form():
    """linear factor f == evaluating unscaled angles at positions/f."""
    from tpu_llm.ops.rope import rope_angles

    pos = jnp.asarray([0, 7, 100, 2047], jnp.int32)
    cos_s, sin_s = rope_angles(pos, 64, 10000.0, "interleaved",
                               scaling=("linear", 4.0, 2048))
    cos_ref, sin_ref = rope_angles(pos.astype(jnp.float32) / 4.0, 64, 10000.0,
                                   "interleaved")
    np.testing.assert_allclose(np.asarray(cos_s), np.asarray(cos_ref),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sin_s), np.asarray(sin_ref),
                               rtol=1e-6, atol=1e-6)


def test_rope_yarn_matches_ggml_formula():
    """YaRN per-dim frequencies and mscale vs a direct transcription of
    ggml's rope_yarn (beta_fast 32, beta_slow 1, ext_factor 1)."""
    import math

    from tpu_llm.ops.rope import rope_angles

    D, theta, factor, orig_ctx = 128, 10000.0, 8.0, 4096
    pos = jnp.asarray([1], jnp.int32)
    cos_s, sin_s = rope_angles(pos, D, theta, "neox",
                               scaling=("yarn", factor, orig_ctx))
    # independent scalar transcription
    def corr_dim(n_rot):
        return D * math.log(orig_ctx / (n_rot * 2 * math.pi)) / (2 * math.log(theta))
    low, high = max(math.floor(corr_dim(32.0)), 0), min(math.ceil(corr_dim(1.0)), D - 1)
    mscale = 1.0 + 0.1 * math.log(factor)
    exp_cos = np.zeros(D // 2, np.float32)
    exp_sin = np.zeros(D // 2, np.float32)
    for j in range(D // 2):
        f = theta ** (-2.0 * j / D)
        ramp = 1.0 - min(1.0, max(0.0, (j - low) / max(0.001, high - low)))
        f_scaled = (f / factor) * (1.0 - ramp) + f * ramp
        exp_cos[j] = math.cos(f_scaled) * mscale
        exp_sin[j] = math.sin(f_scaled) * mscale
    np.testing.assert_allclose(np.asarray(cos_s)[0], exp_cos, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sin_s)[0], exp_sin, rtol=1e-5, atol=1e-6)
    # high-frequency dims (j << low) must be pure extrapolation: identical
    # to the unscaled angles
    cos_u, sin_u = rope_angles(pos, D, theta, "neox")
    np.testing.assert_allclose(np.asarray(cos_s)[0][0] / mscale,
                               np.asarray(cos_u)[0][0], rtol=1e-6)


def test_rope_scaling_metadata_from_gguf(tmp_path):
    """rope.scaling.* keys land in the config (modern + legacy spellings)."""
    from tests.make_tiny_gguf import build

    from tpu_llm.io import gguf as gg
    from tpu_llm.models.llama import config_from_gguf

    path = str(tmp_path / "scaled.gguf")
    build(path, extra_meta={"llama.rope.scaling.type": "linear",
                            "llama.rope.scaling.factor": 4.0})
    cfg = config_from_gguf(gg.GGUFFile(path))
    assert cfg.rope_scaling == ("linear", 4.0, cfg.seq_len)

    path2 = str(tmp_path / "legacy.gguf")
    build(path2, extra_meta={"llama.rope.scale_linear": 2.0})
    cfg2 = config_from_gguf(gg.GGUFFile(path2))
    assert cfg2.rope_scaling == ("linear", 2.0, cfg2.seq_len)

    path3 = str(tmp_path / "yarn.gguf")
    build(path3, extra_meta={
        "llama.rope.scaling.type": "yarn",
        "llama.rope.scaling.factor": 8.0,
        "llama.rope.scaling.original_context_length": 4096})
    cfg3 = config_from_gguf(gg.GGUFFile(path3))
    assert cfg3.rope_scaling == ("yarn", 8.0, 4096)
    # the scaling must actually reach the rotation inside forward(): spy on
    # rope_angles and run a decode step (the tiny random model's logits are
    # too attention-flat for an end-to-end numeric assertion)
    from tpu_llm.models import llama as L

    params, cfg_s = L.load_gguf(path)
    seen = []
    orig = L.rope_angles

    def spy(*a, **kw):
        seen.append(kw.get("scaling", a[5] if len(a) > 5 else None))
        return orig(*a, **kw)

    L.rope_angles = spy
    try:
        cache = L.init_cache(cfg_s, 1, 16)
        logits, _ = L.decode_step(params, cfg_s, jnp.asarray([4], jnp.int32),
                                  cache, jnp.asarray(1, jnp.int32))
    finally:
        L.rope_angles = orig
    assert ("linear", 4.0, cfg_s.seq_len) in seen
    assert np.isfinite(np.asarray(logits)).all()
