"""`llm-bench` — the perf harness (SURVEY.md §7 step 9).

Emits JSON lines, one per metric: decode tokens/s and p50 TTFT for
each weight format (bf16, Q4_0, Q8_0) on TinyLlama-1.1B-shaped random
weights (throughput is weight-content independent). Every row names the
device it ran on (``device``: platform, kind, count); rows measured on
the CPU carry a ``_cpu`` suffix, and the mesh rows run scaled-down shapes
there. ``vs_baseline`` anchors on the reference's best published
single-stream number, 7.3 tok/s on one CPU core
(/root/reference/README.md:13).

Timing: each program runs once to compile and warm up, then once more
under the clock, ending in a host fetch of its result.
"""

from __future__ import annotations

import argparse
import os
import json
import time

import numpy as np

REFERENCE_TOK_S = 7.3


def _device() -> dict:
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def _emit(row: dict) -> None:
    """Print one result row, labelled with the device it ran on."""
    print(json.dumps(dict(row, device=_device())), flush=True)


def _per_step_s(make_run, steps: int) -> float:
    """Seconds per step of a ``steps``-step program, timed after a warm-up
    run. ``make_run(n)`` returns a thunk that runs an n-step program and
    waits for its result."""
    run = make_run(steps)
    run()
    t0 = time.perf_counter()
    run()
    return (time.perf_counter() - t0) / steps


def _build(quant: str):
    import __graft_entry__ as ge
    from tpu_llm.models.llama import unstack_layers
    from tpu_llm.quant.convert_params import fuse_llama_layers, quantize_llama_params

    _, (params, _, _, _) = ge.entry()
    if quant != "bf16":
        params = quantize_llama_params(params, quant, fuse=True)
    else:
        params = dict(params, layers=fuse_llama_layers(params["layers"]))
    return unstack_layers(params)


def _build_mamba():
    """Random Mamba-130M weights in model orientation (throughput is
    weight-content independent; the reference's headline Mamba number is
    6.237 tok/s on one CPU core, ssm/README.md:77-78)."""
    import jax.numpy as jnp

    from tpu_llm.config import mamba_130m

    cfg = mamba_130m()
    rng = np.random.default_rng(0)
    s = lambda *sh: jnp.asarray(
        (rng.standard_normal(sh) * 0.02).astype(np.float32))
    E, di, ds, dr, dc = (cfg.d_model, cfg.d_inner, cfg.d_state,
                         cfg.dt_rank_, cfg.d_conv)
    L, V = cfg.n_layers, cfg.vocab_size
    params = {
        "tok_emb": s(V, E),
        "norm_f": s(E) + 1.0,
        "wcls": s(E, V),
        "layers": {
            "norm": s(L, E) + 1.0,
            "in_proj": s(L, E, 2 * di),
            "conv_w": s(L, dc, di), "conv_b": s(L, di),
            "x_proj": s(L, di, dr + 2 * ds),
            "dt_proj": s(L, dr, di), "dt_bias": s(L, di),
            "A_log": jnp.abs(s(L, ds, di)) + 0.1,
            "d": s(L, di),
            "out_proj": s(L, di, E),
        },
    }
    return params, cfg


def random_llama_params(cfg, seed: int = 0):
    """Random dense bf16 llama-family weights at cfg shapes (throughput is
    weight-content-independent). Shared by bench.py and the 7B config."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    E, F, L, V, KV = (cfg.dim, cfg.hidden_dim, cfg.n_layers, cfg.vocab_size,
                      cfg.kv_dim)
    w = lambda *sh: jnp.asarray(
        (rng.standard_normal(sh) * 0.02).astype(np.float32), jnp.bfloat16)
    return {
        "tok_emb": w(V, E),
        "final_norm": jnp.ones((E,), jnp.float32),
        "wcls": w(E, V),
        "layers": {
            "attn_norm": jnp.ones((L, E), jnp.float32),
            "ffn_norm": jnp.ones((L, E), jnp.float32),
            "wq": w(L, E, E), "wk": w(L, E, KV), "wv": w(L, E, KV),
            "wo": w(L, E, E), "w1": w(L, E, F), "w3": w(L, E, F),
            "w2": w(L, F, E),
        },
    }


def _synth_qtensor(key, K, N, kind):
    """Random packed QTensor with on-device RNG (see synth_quant_llama)."""
    import jax
    import jax.numpy as jnp

    from tpu_llm.quant.qtensor import QTensor

    kq, ks = jax.random.split(key)
    if kind in ("q2_k", "q3_k", "q4_k", "q5_k", "q6_k"):
        # device layouts the K-quant loader produces (folded flat planes):
        # q4_K -> q4_1 packed-affine per-32; q5_K -> q5_1 int8-affine
        # per-32; q2/q3/q6_K -> int8 kinds with per-16 scale blocks
        km = jax.random.fold_in(ks, 1)
        kq_dt = (jnp.float32 if os.environ.get("TPU_LLM_KQ_F32S")
                 else jnp.bfloat16)    # loader default: bf16 folded planes
        if kind == "q4_k":
            q = jax.random.randint(kq, (K // 2, N), 0, 256,
                                   jnp.int32).astype(jnp.uint8)
            scales = jax.random.uniform(ks, (K // 32, N), jnp.float32,
                                        0.001, 0.01)
            mins = -8.0 * scales + 0.001 * jax.random.uniform(
                km, (K // 32, N), jnp.float32)
            return QTensor(q=q, scales=scales.astype(kq_dt), kind="q4_1",
                           mins=mins.astype(kq_dt))
        if kind == "q5_k":
            q = jax.random.randint(kq, (K, N), 0, 32,
                                   jnp.int32).astype(jnp.int8)
            scales = jax.random.uniform(ks, (K // 32, N), jnp.float32,
                                        0.001, 0.01)
            mins = -16.0 * scales + 0.001 * jax.random.uniform(
                km, (K // 32, N), jnp.float32)
            return QTensor(q=q, scales=scales.astype(kq_dt), kind="q5_1",
                           mins=mins.astype(kq_dt))
        if kind in ("q2_k", "q3_k"):
            lo, hi = ((0, 4) if kind == "q2_k" else (-4, 4))
            q = jax.random.randint(kq, (K, N), lo, hi,
                                   jnp.int32).astype(jnp.int8)
            scales = jax.random.uniform(ks, (K // 16, N), jnp.float32,
                                        0.001, 0.01)
            mins = None
            if kind == "q2_k":
                mins = (-2.0 * scales).astype(kq_dt)
            qt = QTensor(q=q, scales=scales.astype(kq_dt), kind=kind,
                         mins=mins)
            if os.environ.get("TPU_LLM_Q23_INT8"):   # A/B escape hatch
                return qt
            from tpu_llm.quant.qtensor import pack_q2_k, pack_q3_k

            # loader default: nibble-packed value planes (q2_kp/q3_kp)
            return pack_q2_k(qt) if kind == "q2_k" else pack_q3_k(qt)
        q = jax.random.randint(kq, (K, N), -32, 32, jnp.int32).astype(jnp.int8)
        scales = jax.random.uniform(ks, (K // 16, N), jnp.float32, 0.001, 0.01)
        qt = QTensor(q=q, scales=scales.astype(kq_dt), kind="q6_k")
        if os.environ.get("TPU_LLM_Q6K_PACK"):      # loader's capacity option
            from tpu_llm.quant.qtensor import pack_q6_k

            return pack_q6_k(qt)
        return qt
    if kind == "q4_0":
        q = jax.random.randint(kq, (K // 2, N), 0, 256,
                               jnp.int32).astype(jnp.uint8)
    else:
        q = jax.random.randint(kq, (K, N), -127, 128,
                               jnp.int32).astype(jnp.int8)
    scales = jax.random.uniform(ks, (K // 32, N), jnp.float32, 0.001, 0.01)
    return QTensor(q=q, scales=scales, kind=kind)


def synth_quant_llama(cfg, kind: str = "q4_0", seed: int = 0):
    """Random PACKED llama-family weights built with on-device RNG —
    no host f32 materialization, no host quantize pass, no multi-GB
    host-to-device upload (the host path costs minutes for 7B; this is
    seconds).
    Throughput benching is weight-content-independent, so these exercise
    the same kernels as GGUF-loaded weights. Fused wqkv/w13 layout,
    unstacked layers."""
    import jax
    import jax.numpy as jnp

    E, F, L, V, KV = (cfg.dim, cfg.hidden_dim, cfg.n_layers,
                      cfg.vocab_size, cfg.kv_dim)
    key = iter(jax.random.split(jax.random.PRNGKey(seed), 8 + 8 * L))

    def qt(K, N):
        return _synth_qtensor(next(key), K, N, kind)

    emb = (jax.random.normal(next(key), (V, E), jnp.bfloat16) * 0.02)
    layers = [{
        "attn_norm": jnp.ones((E,), jnp.float32),
        "ffn_norm": jnp.ones((E,), jnp.float32),
        "wqkv": qt(E, E + 2 * KV),
        "wo": qt(E, E),
        "w13": qt(E, 2 * F),
        "w2": qt(F, E),
    } for _ in range(L)]
    return {
        "tok_emb": emb,
        "final_norm": jnp.ones((E,), jnp.float32),
        "wcls": qt(E, V),
        "layers": layers,
    }


def _build_moe(quant: str = "q4_0"):
    """Synthetic Mixtral-style MoE (8 experts, top-2): dim 1024, ffn 2816,
    8 layers — the family's decode regime at single-chip scale. Decode
    gathers the 2 selected experts' stacked planes per token
    (models/llama._moe_ffn), so HBM reads scale with k, not n_experts."""
    import jax

    from tpu_llm.config import LlamaConfig
    from tpu_llm.quant.qtensor import qmap

    cfg = LlamaConfig(dim=1024, hidden_dim=2816, n_layers=8, n_heads=16,
                      n_kv_heads=8, vocab_size=32000, seq_len=2048,
                      rope_variant="neox", n_experts=8, n_experts_used=2)
    E, F, L, V, KV, EX = (cfg.dim, cfg.hidden_dim, cfg.n_layers,
                          cfg.vocab_size, cfg.kv_dim, cfg.n_experts)
    key = iter(jax.random.split(jax.random.PRNGKey(0), 16 + (3 * EX + 8) * L))
    import jax.numpy as jnp

    def qt(K, N):
        return _synth_qtensor(next(key), K, N, quant)

    def qte(K, N):
        return qmap(lambda *ps: jnp.stack(ps),
                    *[_synth_qtensor(next(key), K, N, quant)
                      for _ in range(EX)])

    layers = [{
        "attn_norm": jnp.ones((E,), jnp.float32),
        "ffn_norm": jnp.ones((E,), jnp.float32),
        "wqkv": qt(E, E + 2 * KV),
        "wo": qt(E, E),
        "router": (jax.random.normal(next(key), (E, EX), jnp.float32)
                   * 0.05),
        "w1e": qte(E, F), "w3e": qte(E, F), "w2e": qte(F, E),
    } for _ in range(L)]
    return {
        "tok_emb": (jax.random.normal(next(key), (V, E), jnp.bfloat16)
                    * 0.02),
        "final_norm": jnp.ones((E,), jnp.float32),
        "wcls": qt(E, V),
        "layers": layers,
    }, cfg


def _build_llama2_7b(quant: str = "q4_0"):
    """Random Llama-2 7B-shaped weights (SURVEY.md §2.3: the model the PP
    axis exists for; q4_0 = ~3.5 GB packed, single-chip resident)."""
    from tpu_llm.config import llama2_7b
    from tpu_llm.models.llama import unstack_layers
    from tpu_llm.quant.convert_params import fuse_llama_layers

    cfg = llama2_7b()
    if quant in ("q4_0", "q8_0"):
        return synth_quant_llama(cfg, quant), cfg
    params = random_llama_params(cfg)
    params = dict(params, layers=fuse_llama_layers(params["layers"]))
    return unstack_layers(params), cfg


def _build_phi2(quant: str = "bf16"):
    """Random phi-2 2.7B-shaped weights (parallel attn+MLP block, biases,
    tanh-GELU MLP, partial NeoX RoPE) — exercises the same llama-family
    forward on the second architecture (SURVEY.md §7 step 8)."""
    import jax.numpy as jnp

    from tpu_llm.config import phi2_2_7b

    cfg = phi2_2_7b()
    rng = np.random.default_rng(0)
    E, F, L, V = cfg.dim, cfg.hidden_dim, cfg.n_layers, cfg.vocab_size

    def w(*sh):
        return jnp.asarray(
            (rng.standard_normal(sh) * 0.02).astype(np.float32), jnp.bfloat16)

    def b(*sh):
        return jnp.asarray(np.zeros(sh, np.float32))

    params = {
        "tok_emb": w(V, E),
        "final_norm": b(E) + 1.0, "final_norm_b": b(E),
        "wcls": w(E, V), "bcls": b(V),
        "layers": {
            "attn_norm": jnp.ones((L, E), jnp.float32) + 0.0,
            "attn_norm_b": jnp.zeros((L, E), jnp.float32),
            "wq": w(L, E, E), "wk": w(L, E, E), "wv": w(L, E, E),
            "wo": w(L, E, E),
            "bq": jnp.zeros((L, E)), "bk": jnp.zeros((L, E)),
            "bv": jnp.zeros((L, E)), "bo": jnp.zeros((L, E)),
            "w3": w(L, E, F), "b3": jnp.zeros((L, F)),
            "w2": w(L, F, E), "b2": jnp.zeros((L, E)),
        },
    }
    if quant in ("q4_0", "q8_0"):
        # device-side packed synth (the host quantize pass for 2.7B of
        # f32 costs minutes; same kernels either way)
        import jax

        key = iter(jax.random.split(jax.random.PRNGKey(1), 8 * L + 8))
        for k in ("wq", "wk", "wv", "wo", "w3", "w2"):
            K, N = params["layers"][k].shape[1:]
            params["layers"][k] = [
                _synth_qtensor(next(key), K, N, quant) for _ in range(L)]
        params["wcls"] = _synth_qtensor(next(key), E, V, quant)
        layers = params.pop("layers")
        # unstack: [i] slices both the stacked (L, ...) dense leaves and
        # the per-layer QTensor lists
        out = [{k: layers[k][i] for k in layers} for i in range(L)]
        return dict(params, layers=out), cfg
    from tpu_llm.models.llama import unstack_layers

    return unstack_layers(params), cfg


def _decode_tok_s_mamba(params, cfg, steps, batch):
    import jax
    import jax.numpy as jnp

    from tpu_llm.models import mamba as M

    params = M.unstack_layers(params)
    state = M.init_state(cfg, batch, stacked=False)
    token = jnp.ones((batch,), jnp.int32)

    def make_run(length):
        @jax.jit
        def decode_n(params, token, state):
            def body(carry, _):
                token, state = carry
                hidden, state = M.forward(params, cfg, token[:, None], state)
                logits = M.lm_head(params, cfg, hidden)[:, 0, :]
                token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                return (token, state), token

            (token_, state_), toks = jax.lax.scan(
                body, (token, state), None, length=length)
            return toks, state_

        def run():
            toks, _ = decode_n(params, token, state)
            _ = np.asarray(toks[-1])

        return run

    return batch / _per_step_s(make_run, steps)


def _decode_tok_s(params, cfg, steps, batch, max_seq, prompt_len,
                  cache_dtype=None):
    import jax
    import jax.numpy as jnp

    from tpu_llm.models import llama as M

    stacked = not isinstance(params["layers"], (list, tuple))
    cache = M.init_cache(cfg, batch, max_seq,
                         dtype=cache_dtype or jnp.bfloat16, stacked=stacked)
    token = jnp.ones((batch,), jnp.int32)

    def make_run(length):
        @jax.jit
        def decode_n(params, token, cache, pos0):
            def body(carry, _):
                token, cache, pos = carry
                logits, cache = M.decode_step(params, cfg, token, cache, pos)
                token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                return (token, cache, pos + 1), token

            (token_, cache_, _), toks = jax.lax.scan(
                body, (token, cache, pos0), None, length=length
            )
            return toks, cache_

        def run():
            toks, _ = decode_n(params, token, cache, jnp.int32(prompt_len))
            _ = np.asarray(toks[-1])

        return run

    # keep the scan inside the cache (update_kv_cache would silently
    # clamp writes past max_seq and corrupt the measured regime)
    steps = min(steps, max(1, max_seq - prompt_len - 1))
    return batch / _per_step_s(make_run, steps)


def _ttft_p50(params, cfg, prompt_len, max_seq, samples):
    import jax
    import jax.numpy as jnp

    from tpu_llm.models import llama as M

    rng = np.random.default_rng(0)
    tokens = jnp.asarray(
        rng.integers(0, cfg.vocab_size, (1, prompt_len)), jnp.int32
    )

    stacked = not isinstance(params["layers"], (list, tuple))

    @jax.jit
    def prefill_and_first(params, tokens):
        # cache allocated in-program: an eager zeros() dispatch would be
        # counted as TTFT while being pure harness overhead
        cache = M.init_cache(cfg, 1, max_seq, dtype=jnp.bfloat16,
                             stacked=stacked)
        hidden, cache = M.forward(params, cfg, tokens, cache, jnp.int32(0))
        logits = M.lm_head(params, cfg, hidden[:, -1:, :])[:, 0, :]
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), cache

    times = []
    for i in range(samples + 1):
        t0 = time.perf_counter()
        tok, cache = prefill_and_first(params, tokens)
        _ = int(np.asarray(tok)[0])
        if i > 0:  # skip compile
            times.append(time.perf_counter() - t0)
    return float(np.percentile(times, 50))


def _scaling_rows(args):
    """Data-parallel weak-scaling harness (BASELINE ">=85% 2-host scaling
    efficiency"): decode tok/s at dp in {1, 2, 4, ...} with constant
    per-replica batch, same jitted program at every world size. On the
    one-real-chip dev environment this runs on virtual CPU devices
    (harness correctness); on GPUs it measures real scaling."""
    import jax
    import jax.numpy as jnp

    from tpu_llm.config import LlamaConfig, tinyllama_1_1b
    from tpu_llm.models import llama as M
    from tpu_llm.parallel import (
        llama_cache_spec, llama_param_specs, make_mesh, shard_pytree,
    )

    ndev = len(jax.devices())
    on_device = jax.default_backend() != "cpu"
    if on_device:
        cfg = tinyllama_1_1b()
    else:
        # CPU virtual mesh: scaled-down llama shape (the harness, not the
        # hardware, is under test there)
        cfg = LlamaConfig(dim=256, hidden_dim=512, n_layers=4, n_heads=8,
                          n_kv_heads=4, vocab_size=2048, seq_len=256)
    params = random_llama_params(cfg)
    max_seq = min(cfg.seq_len, args.max_seq)
    steps = min(args.steps, max(1, (max_seq - 2) // 5))
    base = None
    dp = 1
    while dp <= ndev:
        mesh = make_mesh(data=dp, model=1)
        p_sh = shard_pytree(params, llama_param_specs(cfg), mesh)
        batch = args.batch * dp
        cache = M.init_cache(cfg, batch, max_seq, dtype=jnp.bfloat16)
        cache = shard_pytree(cache, llama_cache_spec(), mesh)
        token = jnp.zeros((batch,), jnp.int32)

        def make_run(length, p_sh=p_sh, cache=cache, token=token):
            @jax.jit
            def decode_n(params, token, cache):
                def body(carry, _):
                    token, cache, pos = carry
                    logits, cache = M.decode_step(params, cfg, token, cache, pos)
                    token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                    return (token, cache, pos + 1), token

                (_, cache_, _), toks = jax.lax.scan(
                    body, (token, cache, jnp.int32(1)), None, length=length)
                return toks, cache_

            def run():
                toks, _ = decode_n(p_sh, token, cache)
                _ = np.asarray(jax.device_get(toks[-1].addressable_shards[0].data))

            return run

        tok_s = batch / _per_step_s(make_run, steps)
        if base is None:
            base = tok_s
        eff = tok_s / (dp * base)
        _emit({
            "metric": f"scaling_dp{dp}_decode_tokens_per_s"
                      + ("" if on_device else "_cpu"),
            "value": round(tok_s, 2),
            "unit": "tok/s",
            "vs_baseline": round(eff, 3),   # weak-scaling efficiency vs dp=1
        })
        dp *= 2
    return 0


def _tp_rows(args):
    """Sharded-decode rows: the explicit shard_map TP decode step
    (tpu_llm.parallel.tp_decode — unstacked buffers, per-shard GPU
    kernels, Megatron psum placement) at every tp that divides the
    available devices and the KV heads."""
    import jax
    import jax.numpy as jnp

    from tpu_llm.config import tinyllama_1_1b, LlamaConfig
    from tpu_llm.parallel.mesh import make_mesh
    from tpu_llm.parallel.tp_decode import (
        init_tp_cache, make_tp_decode_step, repack_fused_for_tp,
        shard_tp_params,
    )
    from tpu_llm.models.llama import unstack_layers
    from tpu_llm.quant.convert_params import quantize_llama_params

    ndev = len(jax.devices())
    on_device = jax.default_backend() != "cpu"
    if on_device:
        cfg = tinyllama_1_1b()
        import __graft_entry__ as ge

        _, (params, _, _, _) = ge.entry()
        params = quantize_llama_params(params, "q4_0", fuse=True)
        name = "q4_0"
    else:
        cfg = LlamaConfig(dim=256, hidden_dim=512, n_layers=4, n_heads=8,
                          n_kv_heads=4, vocab_size=2048, seq_len=256)
        rng = np.random.default_rng(0)
        s = lambda *sh: jnp.asarray(
            (rng.standard_normal(sh) * 0.02).astype(np.float32))
        L, E, F, V, KV = (cfg.n_layers, cfg.dim, cfg.hidden_dim,
                          cfg.vocab_size, cfg.kv_dim)
        params = {
            "tok_emb": s(V, E), "final_norm": s(E) + 1.0, "wcls": s(E, V),
            "layers": {
                "attn_norm": s(L, E) + 1.0, "ffn_norm": s(L, E) + 1.0,
                "wq": s(L, E, E), "wk": s(L, E, KV), "wv": s(L, E, KV),
                "wo": s(L, E, E), "w1": s(L, E, F), "w3": s(L, E, F),
                "w2": s(L, F, E)},
        }
        name = "bf16"
    params = unstack_layers(params)
    fused = "wqkv" in params["layers"][0]

    max_seq = min(cfg.seq_len, args.max_seq)
    steps = min(args.steps, max(1, (max_seq - 2) // 5))
    tp = 1
    while tp <= min(ndev, cfg.n_kv_heads):
        mesh = make_mesh(data=1, model=tp)
        layers = (repack_fused_for_tp(params["layers"], cfg, tp)
                  if fused and tp > 1 else params["layers"])
        p_sh = shard_tp_params(dict(params, layers=layers), cfg, mesh,
                               fused=fused)
        cache = init_tp_cache(cfg, mesh, args.batch, max_seq)
        step = make_tp_decode_step(cfg, mesh, fused=fused)
        token = jnp.zeros((args.batch,), jnp.int32)

        def make_run(length, step=step, p_sh=p_sh, cache=cache, token=token):
            @jax.jit
            def decode_n(params, token, cache):
                def body(carry, _):
                    token, cache, pos = carry
                    logits, cache = step(params, token, cache, pos)
                    token = jnp.argmax(logits, -1).astype(jnp.int32)
                    return (token, cache, pos + 1), token

                (_, cache_, _), toks = jax.lax.scan(
                    body, (token, cache, jnp.int32(1)), None, length=length)
                return toks, cache_

            def run():
                toks, _ = decode_n(p_sh, token, cache)
                _ = np.asarray(jax.device_get(
                    toks[-1].addressable_shards[0].data))

            return run

        tok_s = args.batch / _per_step_s(make_run, steps)
        _emit({
            "metric": f"tp{tp}_shardmap_{name}_decode_tokens_per_s"
                      + ("" if on_device else "_cpu"),
            "value": round(tok_s, 2),
            "unit": "tok/s",
            "vs_baseline": (round(tok_s / REFERENCE_TOK_S, 2) if on_device
                            else None),
        })
        tp *= 2
    return 0


def paged_decode_tok_s(params, cfg, batch: int, block_size: int,
                       steps: int, prompt_len: int) -> float:
    """Device-side paged-decode throughput: the PagedEngine's jitted step
    in a lax.scan over bf16 pools, tables pre-mapped for the measured
    window. Measures the paged indirection itself — host scheduling
    (admission, growth) is between-step work the dense engine shares."""
    import jax
    import jax.numpy as jnp

    from tpu_llm.models import llama as M
    from tpu_llm.ops.paged_kv import PagedKV
    from tpu_llm.runtime.paged_engine import _paged_attn_fn, _paged_update_fn

    B, bs = batch, block_size
    span = prompt_len + steps + 1
    blocks_per_row = -(-span // bs)
    n_layers = len(params["layers"])
    kvd = cfg.kv_dim

    n_blocks = 1 + B * blocks_per_row
    table = np.zeros((B, blocks_per_row), np.int32)
    table[:] = 1 + np.arange(B * blocks_per_row).reshape(B, blocks_per_row)
    state = {
        "k": [jnp.zeros((n_blocks, bs, kvd), jnp.bfloat16)
              for _ in range(n_layers)],
        "v": [jnp.zeros((n_blocks, bs, kvd), jnp.bfloat16)
              for _ in range(n_layers)],
        "table": jnp.asarray(table),
        "lengths": jnp.full((B,), prompt_len, jnp.int32),
    }
    token = jnp.ones((B,), jnp.int32)

    def make_run(length):
        @jax.jit
        def decode_n(params, token, state, pos0):
            def body(carry, _):
                token, state, pos = carry
                cache = {
                    "k": [PagedKV(state["k"][i], state["v"][i],
                                  state["table"], state["lengths"])
                          for i in range(n_layers)],
                    "v": [None] * n_layers,
                }
                offsets = jnp.full((B,), pos, jnp.int32)
                hidden, nc = M.forward(params, cfg, token[:, None], cache,
                                       offsets, update_fn=_paged_update_fn,
                                       attn_fn=_paged_attn_fn)
                logits = M.lm_head(params, cfg, hidden)[:, 0, :]
                token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                state = {
                    "k": [kv.k_pool for kv in nc["k"]],
                    "v": [kv.v_pool for kv in nc["k"]],
                    "table": state["table"],
                    "lengths": nc["k"][0].lengths,
                }
                return (token, state, pos + 1), token

            (token_, state_, _), toks = jax.lax.scan(
                body, (token, state, pos0), None, length=length)
            return toks, state_

        def run():
            toks, _ = decode_n(params, token, state, jnp.int32(prompt_len))
            _ = np.asarray(toks[-1])

        return run

    return B / _per_step_s(make_run, steps)


def _paged_rows(args) -> int:
    """Paged decode tok/s (``paged_decode_tok_s``) next to the dense
    preallocated cache at the same batch."""
    import jax.numpy as jnp

    from tpu_llm.config import tinyllama_1_1b

    cfg = tinyllama_1_1b()
    params = _build("q4_0")
    B, bs = args.batch, args.block_size
    tok_s = paged_decode_tok_s(params, cfg, B, bs, args.steps,
                               args.prompt_len)
    _emit({
        "metric": f"tinyllama_1.1b_q4_0_PAGED_decode_tokens_per_s_b{B}_bs{bs}",
        "value": round(tok_s, 2),
        "unit": "tok/s",
        "vs_baseline": round(tok_s / REFERENCE_TOK_S, 2),
    })

    span = args.prompt_len + args.steps + 1
    dense = _decode_tok_s(params, cfg, args.steps, B,
                          max(_round_up(span, 128), 256), args.prompt_len,
                          cache_dtype=jnp.bfloat16)
    _emit({
        "metric": f"tinyllama_1.1b_q4_0_dense_decode_tokens_per_s_b{B}",
        "value": round(dense, 2),
        "unit": "tok/s",
        "vs_baseline": round(dense / REFERENCE_TOK_S, 2),
    })
    return 0


def _spec_rows(args) -> int:
    """Speculative-decoding rows: prompt-lookup speculation vs the plain
    pipelined engine step, measured through the real BatchEngine host loop
    (the regime where the synchronous verify fetch matters). Emits tok/s
    and tokens-per-verify-forward (accepted drafts + 1) for repetitive and
    non-repetitive prompts at batch 1 and 8."""
    import time

    import jax.numpy as jnp

    from tpu_llm.config import tinyllama_1_1b
    from tpu_llm.runtime.batching import BatchEngine, Request
    from tpu_llm.runtime.engine import ModelAdapter

    cfg = tinyllama_1_1b()
    params = _build("q4_0")
    rng = np.random.default_rng(0)
    pat = rng.integers(5, cfg.vocab_size - 1, 8).tolist()
    prompts = {
        "repetitive": (pat * 16)[:128],
        "random": rng.integers(5, cfg.vocab_size - 1, 128).tolist(),
    }

    for B in (1, 8):
        for pname, prompt in prompts.items():
            for spec in (0, args.spec_k):
                # _build returns unstacked params (python layer loop)
                adapter = ModelAdapter.llama(cfg, cache_dtype=jnp.bfloat16,
                                             stacked=False)
                eng = BatchEngine(params, adapter, batch=B,
                                  max_seq=args.max_seq, speculative_k=spec)
                # warm the jit caches with a full run, then measure a
                # fresh submission on the same engine
                for _ in range(B):
                    eng.submit(Request(prompt=list(prompt), max_new=8))
                eng.run()
                eng.stats["spec_forwards"] = eng.stats["spec_tokens"] = 0
                reqs = [Request(prompt=list(prompt), max_new=args.steps)
                        for _ in range(B)]
                t0 = time.perf_counter()
                for r in reqs:
                    eng.submit(r)
                eng.run()
                dt = time.perf_counter() - t0
                total = sum(len(r.tokens) for r in reqs)
                fwd = eng.stats["spec_forwards"]
                tpf = (eng.stats["spec_tokens"] / fwd) if fwd else None
                label = f"spec{spec}" if spec else "plain"
                _emit({
                    "metric": (f"tinyllama_1.1b_q4_0_engine_{label}_{pname}"
                               f"_tokens_per_s_b{B}"),
                    "value": round(total / dt, 2),
                    "unit": "tok/s",
                    "vs_baseline": round(total / dt / REFERENCE_TOK_S, 2),
                    **({"tokens_per_verify_forward": round(tpf, 3)}
                       if tpf is not None else {}),
                })
    return 0


def _serve_tp_rows(args) -> int:
    """Mesh-sharded serving row (chip-gated): BatchEngine tok/s with
    params+cache under the TP GSPMD specs. On a single chip this degrades
    to tp=1 (the row documents the gate); the multi-chip number needs
    real hardware this environment doesn't have."""
    import time

    import jax
    import jax.numpy as jnp

    from tpu_llm.config import tinyllama_1_1b
    from tpu_llm.parallel import make_mesh
    from tpu_llm.parallel.serving import shard_engine
    from tpu_llm.runtime.batching import BatchEngine, Request
    from tpu_llm.runtime.engine import ModelAdapter

    cfg = tinyllama_1_1b()
    n_dev = len(jax.devices())
    tp = max(1, min(args.serve_tp, n_dev, cfg.n_kv_heads))
    if tp < args.serve_tp:
        _emit({"note": f"serve-tp clamped {args.serve_tp}->{tp} "
                                  f"({n_dev} devices, "
                                  f"{cfg.n_kv_heads} kv heads)"})
    # stacked bf16 params: GSPMD serving runs the XLA paths anyway
    # (shard_engine disables Pallas), so dense weights measure the same
    # regime a sharded quantized load would fall back to
    import __graft_entry__ as ge

    _, (params, _, _, _) = ge.entry()
    adapter = ModelAdapter.llama(cfg, cache_dtype=jnp.bfloat16)
    eng = BatchEngine(params, adapter, batch=args.batch,
                      max_seq=args.max_seq)
    eng = shard_engine(eng, cfg, make_mesh(data=1, model=tp))
    rng = np.random.default_rng(0)
    prompt = rng.integers(5, cfg.vocab_size - 1, 64).tolist()
    for _ in range(args.batch):
        eng.submit(Request(prompt=list(prompt), max_new=8))
    eng.run()                                  # compile warmup
    reqs = [Request(prompt=list(prompt), max_new=args.steps)
            for _ in range(args.batch)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    dt = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in reqs)
    _emit({
        "metric": (f"tinyllama_1.1b_bf16_engine_serving_tp{tp}"
                   f"_tokens_per_s_b{args.batch}"),
        "value": round(total / dt, 2),
        "unit": "tok/s",
        "vs_baseline": round(total / dt / REFERENCE_TOK_S, 2),
    })
    return 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def main(argv=None) -> int:
    import os as _os

    from tpu_llm.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="llm-bench", description=__doc__)
    ap.add_argument("--configs", default="bf16,q8_0,q4_0")
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--ttft-samples", type=int, default=5)
    ap.add_argument("--skip-ttft", action="store_true")
    ap.add_argument("--cache-dtype", default="bf16",
                    choices=["f32", "bf16", "int8"])
    ap.add_argument("--scaling", action="store_true",
                    help="emit dp-scaling rows (tok/s + efficiency at "
                         "dp=1,2,4,... over the available devices)")
    ap.add_argument("--sharded", action="store_true",
                    help="emit shard_map TP decode rows (tp=1,2,... up to "
                         "min(devices, kv heads))")
    ap.add_argument("--paged", action="store_true",
                    help="emit paged-KV decode rows (block-table kernel vs "
                         "dense cache at the same batch)")
    ap.add_argument("--block-size", type=int, default=64)
    ap.add_argument("--spec", action="store_true",
                    help="emit speculative-decoding rows (engine tok/s + "
                         "tokens-per-verify-forward vs the plain step)")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--serve-tp", type=int, default=0, metavar="N",
                    help="emit the mesh-sharded serving row (BatchEngine "
                         "under TP GSPMD specs; clamps to the available "
                         "devices)")
    args = ap.parse_args(argv)

    if args.scaling:
        return _scaling_rows(args)
    if args.sharded:
        return _tp_rows(args)
    if args.paged:
        return _paged_rows(args)
    if args.spec:
        return _spec_rows(args)
    if args.serve_tp:
        return _serve_tp_rows(args)

    from tpu_llm.config import tinyllama_1_1b

    cfg = tinyllama_1_1b()
    for name in args.configs.split(","):
        name = name.strip()
        if name.startswith("7b"):
            # 7b | 7b_q4_0 | 7b_q8_0 | 7b_bf16 | 7b_foldnorm (q4_0 with
            # rmsnorm weights folded into the projections)
            quant = name[3:] or "q4_0"
            foldnorm = quant == "foldnorm"
            if foldnorm:
                quant = "q4_0"
            lparams, lcfg = _build_llama2_7b(quant)
            if foldnorm:
                # measurement form of convert_params.fold_norms_requant:
                # synth weights are random, so zero norm READS is the
                # whole effect (the fold itself is numerics, not perf)
                lparams = dict(lparams, layers=[
                    dict(lp, attn_norm=None, ffn_norm=None)
                    for lp in lparams["layers"]
                ], final_norm=None)
            tok_s = _decode_tok_s(lparams, lcfg, args.steps, args.batch,
                                  min(args.max_seq, lcfg.seq_len),
                                  args.prompt_len)
            _emit({
                "metric": (f"llama2_7b_{quant}"
                           f"{'_foldnorm' if foldnorm else ''}"
                           f"_decode_tokens_per_s"),
                "value": round(tok_s, 2),
                "unit": "tok/s",
                "vs_baseline": None,
            })
            continue
        if name.startswith("phi2"):
            quant = name[5:] or "bf16"    # phi2 | phi2_q4_0 | phi2_q8_0
            pparams, pcfg = _build_phi2(quant)
            tok_s = _decode_tok_s(pparams, pcfg, args.steps, args.batch,
                                  min(args.max_seq, pcfg.seq_len),
                                  args.prompt_len)
            _emit({
                "metric": f"phi2_2.7b_{quant}_decode_tokens_per_s",
                "value": round(tok_s, 2),
                "unit": "tok/s",
                "vs_baseline": None,   # reference never published phi-2 numbers
            })
            continue
        if name.startswith("moe"):
            quant = name[4:] or "q4_0"    # moe | moe_q4_0 | moe_q8_0
            mo_params, mo_cfg = _build_moe(quant)
            tok_s = _decode_tok_s(mo_params, mo_cfg, args.steps, args.batch,
                                  min(args.max_seq, mo_cfg.seq_len),
                                  args.prompt_len)
            _emit({
                "metric": (f"synthetic_moe_8e_top2_{quant}"
                           f"_decode_tokens_per_s"),
                "value": round(tok_s, 2),
                "unit": "tok/s",
                "vs_baseline": None,   # no MoE in the reference
            })
            continue
        if name in ("mamba", "mamba_bf16"):
            mparams, mcfg = _build_mamba()
            if name == "mamba_bf16":
                from tpu_llm.models.mamba import cast_weights

                mparams = cast_weights(mparams)
            tok_s = _decode_tok_s_mamba(mparams, mcfg, args.steps, args.batch)
            dt = "f32" if name == "mamba" else "bf16"
            _emit({
                "metric": f"mamba_130m_{dt}_decode_tokens_per_s",
                "value": round(tok_s, 2),
                "unit": "tok/s",
                "vs_baseline": round(tok_s / 6.237, 2),  # ssm/README.md:77
            })
            continue
        if name in ("q2_k", "q3_k", "q4_k", "q5_k", "q6_k"):
            # K-quant rows: device-synth in the loader's folded layouts
            params = synth_quant_llama(cfg, kind=name)
        else:
            params = _build(name)
        import jax.numpy as jnp

        cache_dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16,
                       "int8": "int8"}[args.cache_dtype]
        tok_s = _decode_tok_s(
            params, cfg, args.steps, args.batch, args.max_seq,
            args.prompt_len, cache_dtype=cache_dtype
        )
        _emit({
            "metric": f"tinyllama_1.1b_{name}_decode_tokens_per_s",
            "value": round(tok_s, 2),
            "unit": "tok/s",
            "vs_baseline": round(tok_s / REFERENCE_TOK_S, 2),
        })
        if not args.skip_ttft:
            ttft = _ttft_p50(
                params, cfg, args.prompt_len, args.max_seq, args.ttft_samples
            )
            _emit({
                "metric": f"tinyllama_1.1b_{name}_ttft_p50_prompt{args.prompt_len}",
                "value": round(ttft * 1000, 2),
                "unit": "ms",
                "vs_baseline": None,
            })
        del params
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
