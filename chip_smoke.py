#!/usr/bin/env python3
"""Bring-up check of the quantized decode and serving path on one GPU.

Everything runs in this one process (a JAX process reserves most of the
card's memory, so a second one could not start); the HTTP server runs on
a thread. Phases, in order:

1. device: JAX's platform, device kind and count, and the card's name and
   power limit from ``nvidia-smi``; anything but a GPU exits non-zero;
2. kernels: every GPU kernel compiled at TinyLlama-1.1B widths and
   compared with the plain reference (float32 under
   ``default_matmul_precision("highest")``), with its memory analysis;
3. kernel against plain XLA: both timed after a warm-up with
   ``block_until_ready``, per op and end to end;
4. end to end: a random-weight TinyLlama-1.1B Q4_0 GGUF made from
   ``--seed`` through ``llm`` (step loop and ``--scan``, ``--cache-dtype
   int8``, a prompt of over 2048 tokens over a bf16 and an int8 cache)
   and through ``llm-server``
   (dense and ``--paged`` engines, streamed and chat requests); then
   ``--dtype f32`` on the tiny test GGUF against the numpy oracle.

``--four`` runs only the four-GPU phase: TP=4 serving of the same model
through ``parallel.serving.shard_engine`` and the ``shard_map`` decode of
``parallel.tp_decode``, against one card.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; it is printed
only when every phase passed. Generated files go to ``.cache/smoke`` in
the checkout, which git ignores (override with ``--workdir``).

    python chip_smoke.py [--seed N] [--four]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


# -- phase 1: device -----------------------------------------------------

def device_info() -> dict:
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


# -- model file ----------------------------------------------------------

LETTERS = "abcdefghijklmnopqrstuvwxyz"


def synthetic_vocab(n: int):
    """SentencePiece-style vocabulary of ``n`` pieces: specials, the
    space marker, single letters and "▁x" words (scored so that each
    space-separated letter encodes to one piece), then filler words."""
    toks = ["<unk>", "<s>", "</s>", "▁"] + list(LETTERS)
    toks += ["▁" + c for c in LETTERS]
    toks += [f"▁w{i}" for i in range(n - len(toks))]
    scores = np.zeros((n,), np.float32)
    scores[4 + 26:4 + 52] = 10.0
    return toks[:n], scores


def write_llama_gguf(path: str, cfg, seed: int, context: int) -> None:
    """Random-weight llama GGUF at ``cfg``'s widths: Q4_0 projections
    packed as raw blocks straight from the seed, f16 embedding, f32
    norms."""
    from tpu_llm.io import gguf as gg

    rng = np.random.default_rng(seed)

    def q4(rows, cols):
        # weights (nibble - 8) * d with std ~ 1/sqrt(cols)
        nb = rows * cols // 32
        blk = np.empty((nb, 18), np.uint8)
        d = rng.uniform(0.7, 1.3, nb) / (4.61 * math.sqrt(cols))
        blk[:, :2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
        blk[:, 2:] = rng.integers(0, 256, (nb, 16), np.uint8)
        return (blk.reshape(-1), gg.GGML_Q4_0, (rows, cols))

    E, F, KV, V = cfg.dim, cfg.hidden_dim, cfg.kv_dim, cfg.vocab_size
    toks, scores = synthetic_vocab(V)
    meta = {
        "general.architecture": "llama",
        "llama.block_count": cfg.n_layers,
        "llama.embedding_length": E,
        "llama.feed_forward_length": F,
        "llama.attention.head_count": cfg.n_heads,
        "llama.attention.head_count_kv": cfg.n_kv_heads,
        "llama.context_length": context,
        "llama.rope.freq_base": 10000.0,
        "llama.attention.layer_norm_rms_epsilon": 1e-5,
        "tokenizer.ggml.tokens": toks,
        "tokenizer.ggml.scores": scores,
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
    }
    ones = lambda: (1.0 + 0.05 * rng.standard_normal(E)).astype(np.float32)  # noqa: E731
    tensors = {
        "token_embd.weight": (
            rng.standard_normal((V, E), np.float32), gg.GGML_F16),
        "output_norm.weight": ones(),
        "output.weight": q4(V, E),
    }
    for i in range(cfg.n_layers):
        tensors[f"blk.{i}.attn_norm.weight"] = ones()
        tensors[f"blk.{i}.ffn_norm.weight"] = ones()
        tensors[f"blk.{i}.attn_q.weight"] = q4(E, E)
        tensors[f"blk.{i}.attn_k.weight"] = q4(KV, E)
        tensors[f"blk.{i}.attn_v.weight"] = q4(KV, E)
        tensors[f"blk.{i}.attn_output.weight"] = q4(E, E)
        tensors[f"blk.{i}.ffn_gate.weight"] = q4(F, E)
        tensors[f"blk.{i}.ffn_up.weight"] = q4(F, E)
        tensors[f"blk.{i}.ffn_down.weight"] = q4(E, F)
    gg.write_gguf(path, meta, tensors)


def letters_prompt(n_words: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    return " ".join(LETTERS[i] for i in rng.integers(0, 26, n_words))


# -- phase 2 and 3: kernels -------------------------------------------------

def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "n/a"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return " ".join(f"{k.split('_size')[0]}={getattr(m, k, 0) / 2**20:.1f}MiB"
                    for k in keys)


def _rand_qtensor(key, kind: str, K: int, N: int):
    import jax
    import jax.numpy as jnp

    from tpu_llm.quant.qtensor import QTensor

    kq, ks = jax.random.split(key)
    if kind == "q4_0":
        q = jax.random.randint(kq, (K // 2, N), 0, 256, jnp.int32)
        q = q.astype(jnp.uint8)
    else:
        q = jax.random.randint(kq, (K, N), -127, 128, jnp.int32)
        q = q.astype(jnp.int8)
    s = jax.random.uniform(ks, (K // 32, N), jnp.float32, 0.5, 1.5)
    return QTensor(q, s / (5.0 * math.sqrt(K)), kind)


def _err(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert np.isfinite(got).all(), "non-finite kernel output"
    abs_err = float(np.max(np.abs(got - ref)))
    return abs_err, abs_err / max(float(np.max(np.abs(ref))), 1e-30)


def matmul_shapes(cfg):
    E, F, KV, V = cfg.dim, cfg.hidden_dim, cfg.kv_dim, cfg.vocab_size
    return {"wqkv": (E, E + 2 * KV), "wo": (E, E), "w13": (E, 2 * F),
            "w2": (F, E), "classifier": (E, V)}


def kernel_parity(cfg, seed: int, interpret: bool = False) -> list:
    """Phase 2: each kernel at ``cfg``'s widths against the plain
    float32 reference. Returns result rows; raises on a miss."""
    import jax
    import jax.numpy as jnp

    from tpu_llm.kernels import attention as KA
    from tpu_llm.kernels.qmatmul import qmatmul
    from tpu_llm.ops.attention import gqa_attention, update_kv_cache
    from tpu_llm.ops.kv_cache import QuantKV, dequantize_kv
    from tpu_llm.ops.paged_kv import PagedKV, paged_gather
    from tpu_llm.quant.qtensor import dequantize

    rows = []
    key = jax.random.PRNGKey(seed)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def check(name, fn, args, ref, tol, why, prec):
        compiled = jax.jit(fn).lower(*args).compile()
        got = compiled(*args)
        a, r = _err(got, ref)
        ok = r <= tol
        row = dict(kernel=name, max_abs_err=a, max_rel_err=r, tol=tol,
                   precision=prec, ok=ok)
        rows.append(row)
        log(f"  {name}: max_abs={a:.3e} max_rel={r:.3e} tol={tol} "
            f"({why}) precision={prec} {'OK' if ok else 'FAIL'}")
        log(f"    memory_analysis: {_mem(compiled)}")
        assert ok, f"{name} parity miss"

    why_mm = ("weights rounded once to bf16 in registers (2^-9 rel), "
              "f32 accumulation")
    for kind in ("q4_0", "q8_0"):
        for wname, (K, N) in matmul_shapes(cfg).items():
            key, kw, kx = jax.random.split(key, 3)
            w = _rand_qtensor(kw, kind, K, N)
            for M in (1, 32):
                x = jax.random.normal(kx, (M, K), jnp.bfloat16)
                with jax.default_matmul_precision("highest"):
                    ref = x.astype(jnp.float32) @ dequantize(w, jnp.float32)
                check(f"qmatmul {kind} {wname} {K}x{N} rows={M}",
                      lambda x, q, s: qmatmul(x, q, s, interpret=interpret),
                      (x, w.q, w.scales), ref, 1e-2, why_mm,
                      "bf16 operands, f32 accumulate")

    why_att = "bf16 q/k/v and probabilities, f32 softmax and accumulation"
    S = min(4096, cfg.seq_len * 2)
    for B in (1, 8):
        key, k1, k2, k3 = jax.random.split(key, 4)
        q = jax.random.normal(k1, (B, 1, H, D), jnp.bfloat16)
        kc = jax.random.normal(k2, (B, S, Hkv * D), jnp.bfloat16)
        vc = jax.random.normal(k3, (B, S, Hkv * D), jnp.bfloat16)
        pos = jnp.asarray(np.linspace(S // 10, S - 1, B).astype(np.int32))
        with jax.default_matmul_precision("highest"):
            ref = gqa_attention(q.astype(jnp.float32),
                                kc.astype(jnp.float32).reshape(B, S, Hkv, D),
                                vc.astype(jnp.float32).reshape(B, S, Hkv, D),
                                pos[:, None])
        check(f"decode_attention B={B} S={S}",
              lambda q, k, v, p: KA.decode_attention(q, k, v, p,
                                                     interpret=interpret),
              (q, kc, vc, pos), ref, 2e-2, why_att, "bf16 dot, f32 acc")

    for dtype, bs in (("bf16", 16), ("int8", 32)):
        B, MB = 8, S // bs
        N = 1 + B * MB
        key, k1, k2, k3, k4, k5 = jax.random.split(key, 6)
        q = jax.random.normal(k1, (B, 1, H, D), jnp.bfloat16)
        table = jnp.asarray(1 + np.random.default_rng(seed).permutation(
            B * MB).reshape(B, MB), jnp.int32)
        pos = jnp.asarray(np.linspace(S // 10, S - 1, B).astype(np.int32))
        if dtype == "bf16":
            kp = jax.random.normal(k2, (N, bs, Hkv * D), jnp.bfloat16)
            vp = jax.random.normal(k3, (N, bs, Hkv * D), jnp.bfloat16)
            ks = vs = None
            kd, vd = kp.astype(jnp.float32), vp.astype(jnp.float32)
        else:
            kp = jax.random.randint(k2, (N, bs, Hkv * D), -127, 128,
                                    jnp.int32).astype(jnp.int8)
            vp = jax.random.randint(k3, (N, bs, Hkv * D), -127, 128,
                                    jnp.int32).astype(jnp.int8)
            ks = jax.random.uniform(k4, (Hkv, N, bs), jnp.float32,
                                    0.005, 0.01)
            vs = jax.random.uniform(k5, (Hkv, N, bs), jnp.float32,
                                    0.005, 0.01)

            def deq(p, s):
                p = p.astype(jnp.float32).reshape(N, bs, Hkv, D)
                return (p * s.transpose(1, 2, 0)[..., None]).reshape(
                    N, bs, Hkv * D)

            kd, vd = deq(kp, ks), deq(vp, vs)
        kg, vg = paged_gather(PagedKV(kd, vd, table, pos + 1))
        with jax.default_matmul_precision("highest"):
            ref = gqa_attention(q.astype(jnp.float32),
                                kg.reshape(B, -1, Hkv, D),
                                vg.reshape(B, -1, Hkv, D), pos[:, None])
        check(f"paged_decode_attention {dtype} B={B} block={bs} S={S}",
              lambda q, k, v, t, p, a, b: KA.paged_decode_attention(
                  q, k, v, t, p, a, b, interpret=interpret),
              (q, kp, vp, table, pos, ks, vs), ref, 2e-2, why_att,
              "bf16 q.k, f32 p.v (TF32 in-kernel for int8)")

    # cuDNN has no CPU implementation: a rehearsal runs XLA's instead
    impl = "xla" if interpret else "cudnn"
    T = min(2048, S)
    key, k1, k2, k3 = jax.random.split(key, 4)
    q = jax.random.normal(k1, (1, T, H, D), jnp.bfloat16)
    kc = jax.random.normal(k2, (1, T, Hkv, D), jnp.bfloat16)
    vc = jax.random.normal(k3, (1, T, Hkv, D), jnp.bfloat16)
    kq, vq = QuantKV.zeros((1, T, Hkv, D), flat=True), \
        QuantKV.zeros((1, T, Hkv, D), flat=True)
    kq, vq = update_kv_cache(kq, vq, kc, vc, jnp.int32(0))
    for cache, (k, v), kd, vd in (
            ("bf16", (kc, vc), kc, vc),
            ("int8", (kq, vq), dequantize_kv(kq, jnp.float32, head_dim=D),
             dequantize_kv(vq, jnp.float32, head_dim=D))):
        with jax.default_matmul_precision("highest"):
            ref = gqa_attention(q.astype(jnp.float32),
                                kd.astype(jnp.float32),
                                vd.astype(jnp.float32),
                                jnp.arange(T, dtype=jnp.int32))
        check(f"prefill_attention {impl} {cache} cache T={T}",
              lambda q, k, v: KA.prefill_attention(q, k, v,
                                                   implementation=impl),
              (q, k, v), ref, 2e-2, why_att,
              f"bf16 {impl} flash" + (", cache dequantized to bf16"
                                      if cache == "int8" else ""))
    return rows


def _time_compiled(fn, args, reps: int = 7):
    """(median seconds per call, compile seconds), after one warm-up."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), compile_s


def kernel_timings(cfg, seed: int, copies: int = 32) -> list:
    """Phase 3, per op: each kernel and its plain XLA version over
    ``copies`` distinct weights or caches in one program (the shape of a
    decode step: many different operands, each read once). Per-op time
    is the program's time over ``copies``, so it includes the launches
    an op needs and 1/copies of one program dispatch."""
    import jax
    import jax.numpy as jnp

    from tpu_llm.kernels import attention as KA
    from tpu_llm.kernels.qmatmul import qmatmul
    from tpu_llm.ops.attention import gqa_attention
    from tpu_llm.ops.paged_kv import PagedKV, paged_gather
    from tpu_llm.quant.linear import _dot
    from tpu_llm.quant.qtensor import dequantize

    rows = []
    key = jax.random.PRNGKey(seed)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def pair(name, kernel_fn, plain_fn, args, n=copies):
        tk, ck = _time_compiled(kernel_fn, args)
        tp, cp = _time_compiled(plain_fn, args)
        row = dict(op=name, kernel_us=tk / n * 1e6,
                   plain_us=tp / n * 1e6, speedup=tp / tk,
                   kernel_compile_s=ck, plain_compile_s=cp)
        rows.append(row)
        log(f"  {name}: kernel {row['kernel_us']:.2f} us  plain "
            f"{row['plain_us']:.2f} us  plain/kernel {row['speedup']:.2f}x"
            f"  (compile {ck:.1f}s / {cp:.1f}s)")

    for wname, (K, N) in matmul_shapes(cfg).items():
        key, kw = jax.random.split(key)
        ws = [_rand_qtensor(k, "q4_0", K, N)
              for k in jax.random.split(kw, copies)]
        for M in (1, 8, 32, 512):
            key, kx = jax.random.split(key)
            x = jax.random.normal(kx, (M, K), jnp.bfloat16)
            kern = lambda x, ws: sum(qmatmul(x, w.q, w.scales) for w in ws)  # noqa: E731
            plain = lambda x, ws: sum(  # noqa: E731
                _dot(x, dequantize(w, jnp.bfloat16)) for w in ws)
            pair(f"qmatmul q4_0 {wname} {K}x{N} rows={M}", kern, plain,
                 (x, ws))

    def caches(key, B, S):
        ks = jax.random.split(key, 2 * copies)
        return ([jax.random.normal(k, (B, S, Hkv * D), jnp.bfloat16)
                 for k in ks[:copies]],
                [jax.random.normal(k, (B, S, Hkv * D), jnp.bfloat16)
                 for k in ks[copies:]])

    for B in (1, 32):
        for S in (1024, 4096):
            key, kc, kq = jax.random.split(key, 3)
            kcs, vcs = caches(kc, B, S)
            q = jax.random.normal(kq, (B, 1, H, D), jnp.bfloat16)
            for frac in (0.1, 0.9):
                pos = jnp.full((B,), int(S * frac), jnp.int32)
                kern = lambda q, kcs, vcs, pos: sum(  # noqa: E731
                    KA.decode_attention(q, k, v, pos)
                    for k, v in zip(kcs, vcs))
                plain = lambda q, kcs, vcs, pos: sum(  # noqa: E731
                    gqa_attention(q, k, v, pos[:, None])
                    for k, v in zip(kcs, vcs))
                pair(f"decode_attention B={B} S={S} pos={int(S * frac)}",
                     kern, plain, (q, kcs, vcs, pos))
            del kcs, vcs

    for dtype, bs in (("bf16", 16), ("int8", 32)):
        for B in (8, 32):
            S = 2048
            MB = S // bs
            N = 1 + B * MB
            key, k1, k2 = jax.random.split(key, 3)
            q = jax.random.normal(k1, (B, 1, H, D), jnp.bfloat16)
            table = jnp.asarray(1 + np.random.default_rng(seed).permutation(
                B * MB).reshape(B, MB), jnp.int32)
            pos = jnp.full((B,), S // 2, jnp.int32)
            pk = jax.random.split(k2, 2 * copies)
            if dtype == "bf16":
                pools = [jax.random.normal(k, (N, bs, Hkv * D), jnp.bfloat16)
                         for k in pk]
                scales = [None] * (2 * copies)
            else:
                pools = [jax.random.randint(k, (N, bs, Hkv * D), -127, 128,
                                            jnp.int32).astype(jnp.int8)
                         for k in pk]
                scales = [jnp.full((Hkv, N, bs), 0.01, jnp.float32)
                          for _ in pk]
            kvs = [PagedKV(pools[2 * i], pools[2 * i + 1], table, pos + 1,
                           scales[2 * i], scales[2 * i + 1])
                   for i in range(copies)]

            def kern(q, kvs, pos):
                return sum(KA.paged_decode_attention(
                    q, kv.k_pool, kv.v_pool, kv.block_table, pos,
                    kv.k_scale, kv.v_scale) for kv in kvs)

            def plain(q, kvs, pos):
                out = 0
                for kv in kvs:
                    k, v = paged_gather(kv)
                    if not kv.quantized:
                        k = k.reshape(B, -1, Hkv, D)
                        v = v.reshape(B, -1, Hkv, D)
                    out = out + gqa_attention(q, k, v, pos[:, None],
                                              kv_lengths=kv.lengths)
                return out

            pair(f"paged_decode_attention {dtype} B={B} block={bs} "
                 f"S={S} pos={S // 2}", kern, plain, (q, kvs, pos))
            del kvs, pools

    n_pre = 2
    for T in (512, 1024, 2048, 8192):
        key, k1, k2 = jax.random.split(key, 3)
        q = jax.random.normal(k1, (1, T, H, D), jnp.bfloat16)
        kv = [jax.random.normal(k, (1, T, Hkv, D), jnp.bfloat16)
              for k in jax.random.split(k2, 2 * n_pre)]
        pos = jnp.arange(T, dtype=jnp.int32)
        kern = lambda q, kv, pos: sum(  # noqa: E731
            KA.prefill_attention(q, kv[2 * i], kv[2 * i + 1])
            for i in range(n_pre))
        plain = lambda q, kv, pos: sum(  # noqa: E731
            gqa_attention(q, kv[2 * i], kv[2 * i + 1], pos)
            for i in range(n_pre))
        pair(f"prefill_attention T={T}", kern, plain, (q, kv, pos), n=n_pre)
        del kv
    return rows


@contextlib.contextmanager
def plain_path(*ops):
    """Trace with ``kernels.select``'s ``ops`` answering "plain" (every op
    when none is named)."""
    from tpu_llm.kernels import select

    if not ops:
        with select.kernels_disabled():
            yield
        return
    saved = {op: getattr(select, op) for op in ops}
    try:
        for op in ops:
            setattr(select, op, lambda *a, **k: False)
        yield
    finally:
        for op, fn in saved.items():
            setattr(select, op, fn)


def end_to_end_timings(cfg, seed: int, steps: int = 64) -> list:
    """Phase 3, end to end: TinyLlama-1.1B Q4_0 (random packed weights
    made on the device) decode tok/s, long-prompt prefill time and paged
    decode tok/s, each with every kernel and with one kernel family (or
    all) on the plain path. Each program is warmed up, then timed."""
    import jax
    import jax.numpy as jnp

    from bench import build_params, measure
    from tpu_llm.models import llama as M
    from tpu_llm.runtime.bench_cli import paged_decode_tok_s

    rows = []
    params, mcfg = build_params("q4_0", cfg, seed)

    def row(name, variant, value, unit):
        rows.append(dict(case=name, variant=variant, value=value, unit=unit))
        log(f"  {name} [{variant}]: {value:.2f} {unit}")

    # (label, ops on the plain path)
    variants = {1: [("kernels", None),
                    ("plain qmatmul", ("qmatmul",)),
                    ("plain decode attention", ("decode_attention",)),
                    ("all plain", ())],
                32: [("kernels", None), ("all plain", ())]}
    for B, vs in variants.items():
        for label, ops in vs:
            with (contextlib.nullcontext() if ops is None
                  else plain_path(*ops)):
                tok_s = measure(params, mcfg, steps, B, 1024, 128)
            row(f"decode B={B} S=1024 pos=128..{128 + steps}", label,
                tok_s, "tok/s")

    T = 2048
    tokens = jnp.asarray(np.random.default_rng(seed).integers(
        3, cfg.vocab_size, (1, T)), jnp.int32)

    def make_prefill(cache_dtype):
        # a new function per variant, so that each is traced afresh
        def prefill(params, tokens):
            # a static zero offset, as the engines pass it
            cache = M.init_cache(mcfg, 1, T, cache_dtype, stacked=False)
            hidden, _ = M.forward(params, mcfg, tokens, cache, np.int32(0))
            return M.lm_head(params, mcfg, hidden[:, -1:])
        return prefill

    for cache_name, cache_dtype in (("bf16", jnp.bfloat16), ("int8", "int8")):
        for label, ops in (("kernels", None), ("plain prefill attention",
                                               ("prefill_attention",))):
            with (contextlib.nullcontext() if ops is None
                  else plain_path(*ops)):
                t, _ = _time_compiled(make_prefill(cache_dtype),
                                      (params, tokens), reps=3)
            row(f"prefill T={T} {cache_name} cache", label, t * 1e3, "ms")

    for label, ops in (("kernels", None), ("plain paged attention",
                                           ("paged_decode_attention",))):
        with (contextlib.nullcontext() if ops is None
              else plain_path(*ops)):
            tok_s = paged_decode_tok_s(params, mcfg, 8, 16, steps, 128)
        row(f"paged decode B=8 block=16 pos=128..{128 + steps}", label,
            tok_s, "tok/s")
    return rows


# -- phase 4: end to end ----------------------------------------------------

@contextlib.contextmanager
def captured_stdout():
    """Collect what a CLI writes to stdout (text and raw bytes)."""
    buf = io.BytesIO()
    wrapper = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    old = sys.stdout
    sys.stdout = wrapper
    try:
        yield buf
    finally:
        wrapper.flush()
        wrapper.detach()        # keep buf open once the wrapper is gone
        sys.stdout = old


def run_llm(argv) -> dict:
    """``llm`` in-process; returns the generated bytes and its report."""
    from tpu_llm.runtime import cli

    t0 = time.perf_counter()
    with captured_stdout() as buf:
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    assert rc == 0, f"llm {argv} exited {rc}"
    text, _, report = out.partition(b"\n Inference time:")
    tok_s = ttft = float("nan")
    for line in report.decode(errors="replace").splitlines():
        if "tokens/second" in line:
            tok_s = float(line.split()[0])
        if line.strip().startswith("TTFT:"):
            ttft = float(line.split()[1])
    assert math.isfinite(tok_s), f"no rate in llm output: {out[-300:]!r}"
    return dict(text=text, tok_s=tok_s, ttft_ms=ttft, wall_s=wall)


def _post(port: int, path: str, body: dict, stream: bool = False):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=900) as r:
        assert r.status == 200, r.status
        raw = r.read().decode()
    if not stream:
        return json.loads(raw)
    events = [ln[len("data: "):] for ln in raw.splitlines()
              if ln.startswith("data: ")]
    assert events and events[-1] == "[DONE]", raw[-200:]
    return [json.loads(e) for e in events[:-1]]


@contextlib.contextmanager
def running_server(engine, tokenizer, max_seq: int):
    from tpu_llm.runtime import server as srv

    httpd, loop = srv.serve(engine, tokenizer, "127.0.0.1", 0,
                            max_new_cap=max_seq - 2)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        loop.shutdown()
        t.join(timeout=60)


def serve_requests(gguf: str, extra_args, requests, max_seq: int):
    """Build the engine with ``serve_cli.make_engine`` from server flags,
    serve it on a thread, send ``requests`` ((path, body, stream)
    triples, concurrently), and return the answers."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu_llm.runtime import serve_cli
    from tpu_llm.runtime import server as srv

    args = srv.build_parser().parse_args(
        ["-m", gguf, "--max-seq", str(max_seq)] + list(extra_args))
    params, cfg, tok = serve_cli._load(args)
    engine = serve_cli.make_engine(args, params, cfg, tok, max_seq)
    with running_server(engine, tok, max_seq) as port:
        with ThreadPoolExecutor(len(requests)) as ex:
            futs = [ex.submit(_post, port, p, b, s) for p, b, s in requests]
            answers = [f.result() for f in futs]
    return answers, engine


def _completion_tokens(answer, stream: bool) -> int:
    if stream:
        text = "".join(c["choices"][0].get("text", "") for c in answer)
        assert text, "empty stream"
        return len(answer)
    ch = answer["choices"][0]
    assert ch.get("finish_reason") in ("length", "stop"), ch
    return int(answer["usage"]["completion_tokens"])


def end_to_end(gguf: str, seed: int, long_words: int, max_new: int = 16,
               long_ctx: int = 4096) -> dict:
    """Phase 4 on the model file ``gguf`` (llama, Q4_0)."""
    res = {}
    base = ["-m", gguf, "--dtype", "native", "--seed", str(seed),
            "-t", "0"]
    prompt = letters_prompt(12, seed)
    n_total = 13 + max_new

    step = run_llm(base + ["--cache-dtype", "bf16", "-p", prompt,
                           "-n", str(n_total), "--max-seq", "256"])
    scan = run_llm(base + ["--cache-dtype", "bf16", "-p", prompt,
                           "-n", str(n_total), "--max-seq", "256",
                           "--scan"])
    log(f"  llm step loop: {step['tok_s']:.1f} tok/s, TTFT "
        f"{step['ttft_ms']:.1f} ms; --scan {scan['tok_s']:.1f} tok/s "
        f"(first run of each program: compile time included)")
    assert step["text"] == scan["text"], (
        f"step loop and --scan disagree:\n{step['text']!r}\n"
        f"{scan['text']!r}")
    assert len(step["text"]) > len(prompt), "nothing generated"
    res["llm_step"], res["llm_scan"] = step, scan

    int8 = run_llm(base + ["--cache-dtype", "int8", "-p", prompt,
                           "-n", str(n_total), "--max-seq", "256"])
    log(f"  llm --cache-dtype int8: {int8['tok_s']:.1f} tok/s")
    res["llm_int8"] = int8

    from tpu_llm.io.gguf import GGUFFile
    from tpu_llm.tokenizers.bpe import BPETokenizer

    tok = BPETokenizer.from_gguf(GGUFFile(gguf))
    long_prompt = letters_prompt(long_words, seed + 1)
    n_long = len(tok.encode(long_prompt))
    assert n_long >= min(2048, long_words), n_long
    long = run_llm(base + ["--cache-dtype", "bf16", "-p", long_prompt,
                           "-n", str(n_long + max_new),
                           "--max-seq", str(long_ctx)])
    log(f"  llm long prompt ({n_long} tokens): TTFT "
        f"{long['ttft_ms']:.1f} ms, {long['tok_s']:.1f} tok/s")
    res["llm_long"] = dict(long, prompt_tokens=n_long)
    long8 = run_llm(base + ["--cache-dtype", "int8", "-p", long_prompt,
                            "-n", str(n_long + max_new),
                            "--max-seq", str(long_ctx)])
    assert len(long8["text"]) > len(long_prompt), "nothing generated"
    log(f"  llm long prompt, --cache-dtype int8: TTFT "
        f"{long8['ttft_ms']:.1f} ms, {long8['tok_s']:.1f} tok/s")
    res["llm_long_int8"] = long8

    body = lambda p, **kw: dict(prompt=p, max_tokens=max_new,  # noqa: E731
                                temperature=0, **kw)
    requests = [
        ("/v1/completions", body(letters_prompt(8, seed + 2)), False),
        ("/v1/completions", body(letters_prompt(20, seed + 3)), False),
        ("/v1/completions", body(letters_prompt(5, seed + 4),
                                 stream=True), True),
        ("/v1/chat/completions",
         dict(messages=[{"role": "user", "content": "a b c"}],
              max_tokens=max_new, temperature=0), False),
    ]
    t0 = time.perf_counter()
    answers, eng = serve_requests(
        gguf, ["--dtype", "native", "--cache-dtype", "bf16", "--batch", "4"],
        requests, max_seq=512)
    wall = time.perf_counter() - t0
    counts = [_completion_tokens(a, s) for a, (_, _, s) in zip(answers,
                                                                requests)]
    assert all(c > 0 for c in counts), counts
    log(f"  llm-server dense: {len(answers)} requests answered "
        f"(completion tokens {counts}) in {wall:.1f}s incl. load+compile")
    del eng
    res["server_dense"] = counts

    for cache in ("bf16", "int8"):
        answers, eng = serve_requests(
            gguf, ["--dtype", "native", "--cache-dtype", cache,
                   "--batch", "4", "--paged"],
            [("/v1/completions", body(letters_prompt(30, seed + 5)), False)],
            max_seq=512)
        c = _completion_tokens(answers[0], False)
        assert c > 0
        log(f"  llm-server --paged --cache-dtype {cache}: answered "
            f"({c} completion tokens, engine {type(eng).__name__})")
        del eng
        res[f"server_paged_{cache}"] = c
    return res


def _load_test_module(name: str):
    """A helper module of tests/, loaded from its file (a ``tests``
    package installed elsewhere must not shadow it)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_smoke_{name}", os.path.join(REPO, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def f32_against_oracle(workdir: str, n_new: int = 8) -> list:
    """``llm --dtype f32`` on the tiny test GGUF: its greedy tokens must
    be the numpy oracle's (tests/reference_impl.py)."""
    build = _load_test_module("make_tiny_gguf").build
    RefLlama = _load_test_module("reference_impl").RefLlama

    from tpu_llm.io.gguf import GGUFFile
    from tpu_llm.tokenizers.bpe import BPETokenizer

    path = os.path.join(workdir, "tiny.gguf")
    with contextlib.redirect_stdout(io.StringIO()):
        build(path)
    g = GGUFFile(path)
    tok = BPETokenizer.from_gguf(g)
    L = g.hparam("llama.block_count")
    w = {"tok_emb": g.dequantized("token_embd.weight"),
         "final_norm": g.dequantized("output_norm.weight"),
         "wcls": g.dequantized("output.weight")}
    names = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v",
             "wo": "attn_output", "w1": "ffn_gate", "w3": "ffn_up",
             "w2": "ffn_down", "attn_norm": "attn_norm",
             "ffn_norm": "ffn_norm"}
    for k, n in names.items():
        w[k] = np.stack([g.dequantized(f"blk.{i}.{n}.weight")
                         for i in range(L)])
    dim = g.hparam("llama.embedding_length")
    H = g.hparam("llama.attention.head_count")
    Hkv = g.hparam("llama.attention.head_count_kv")
    prompt = "abc"
    ids = [1] + tok.encode(prompt)
    ref = RefLlama(w, dict(n_layers=L, seq_len=len(ids) + n_new + 1,
                           dim=dim, n_heads=H, n_kv_heads=Hkv,
                           kv_dim=dim // H * Hkv), rope="interleaved")
    seq = list(ids)
    for pos in range(len(ids) + n_new - 1):
        logits = ref.step(seq[pos], pos)
        if pos >= len(ids) - 1:
            seq.append(int(np.argmax(logits)))
    want = b"".join(tok.token_bytes(t) for t in seq[1:])
    got = run_llm(["-m", path, "--dtype", "f32", "-t", "0", "-p", prompt,
                   "-n", str(len(ids) - 1 + n_new)])["text"]
    log(f"  llm --dtype f32 tiny GGUF: {got!r} vs oracle {want!r}")
    assert got == want, "f32 greedy tokens differ from the oracle"
    return seq


# -- four cards --------------------------------------------------------------

def four_card(gguf: str, seed: int, max_new: int = 16) -> dict:
    """TP=4 serving and shard_map decode against one card."""
    import jax
    import jax.numpy as jnp

    from tpu_llm.models import llama as M
    from tpu_llm.parallel import make_mesh
    from tpu_llm.parallel.tp_decode import (init_tp_cache,
                                            make_tp_decode_step,
                                            shard_tp_params)
    from tpu_llm.runtime import serve_cli
    from tpu_llm.runtime import server as srv
    from tpu_llm.runtime.batching import Request

    devs = jax.devices()
    assert len(devs) >= 4, f"--four needs 4 devices, found {len(devs)}"
    prompts = [letters_prompt(n, seed + n) for n in (6, 11, 17, 24)]

    def serve(tp: int):
        args = srv.build_parser().parse_args(
            ["-m", gguf, "--dtype", "native", "--cache-dtype", "bf16",
             "--batch", "4", "--max-seq", "512", "--tp", str(tp)])
        params, cfg, tok = serve_cli._load(args)
        eng = serve_cli.make_engine(args, params, cfg, tok, 512)
        reqs = [eng.submit(Request(prompt=tok.encode(p), max_new=max_new))
                for p in prompts]
        t0 = time.perf_counter()
        eng.run()
        return [r.tokens for r in reqs], eng, params, cfg, \
            time.perf_counter() - t0

    one, eng1, params, cfg, t1 = serve(1)
    del eng1
    four, eng4, _, _, t4 = serve(4)
    assert all(len(t) == max_new for t in four), [len(t) for t in four]
    agree = [sum(a == b for a, b in zip(x, y)) for x, y in zip(one, four)]
    first = sum(x[0] == y[0] for x, y in zip(one, four))
    log(f"  served TP=4 (shard_engine, adapter "
        f"{type(eng4.adapter).__name__}): {len(four)} requests x "
        f"{max_new} tokens in {t4:.1f}s (one card {t1:.1f}s, both incl. "
        f"compile); tokens equal to one card: {agree}, first tokens "
        f"{first}/{len(four)}")
    per_dev = {d: 0 for d in devs[:4]}
    for leaf in jax.tree_util.tree_leaves(eng4.params):
        for sh in leaf.addressable_shards:
            per_dev[sh.device] += sh.data.nbytes
    total = sum(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a: a.nbytes, eng4.params)))
    for d in devs[:4]:
        st = d.memory_stats() or {}
        log(f"    {d}: TP weights {per_dev[d] / 2**20:.0f} MiB of "
            f"{total / 2**20:.0f} MiB; memory_stats bytes_in_use="
            f"{st.get('bytes_in_use', 0) / 2**30:.2f} GiB peak="
            f"{st.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB")
    assert max(per_dev.values()) < 0.5 * total, "weights not sharded"
    del eng4

    # shard_map decode (parallel.tp_decode), teacher-forced, logits
    # against the one-card decode step
    mesh = make_mesh(1, 4)
    u = M.unstack_layers(params)
    step = make_tp_decode_step(cfg, mesh)
    p4 = shard_tp_params(u, cfg, mesh)
    c4 = init_tp_cache(cfg, mesh, 1, 64)
    c1 = M.init_cache(cfg, 1, 64, jnp.bfloat16, stacked=False)
    one_step = jax.jit(lambda p, t, c, pos: M.decode_step(p, cfg, t, c, pos))
    worst = 0.0
    ids = [1] + list(range(30, 30 + 11))
    for pos, t in enumerate(ids):
        tok = jnp.asarray([t], jnp.int32)
        l4, c4 = step(p4, tok, c4, jnp.int32(pos))
        l1, c1 = one_step(u, tok, c1, jnp.int32(pos))
        a, r = _err(l4, l1)
        worst = max(worst, r)
    log(f"  tp_decode shard_map TP=4 vs one card, {len(ids)} teacher-forced"
        f" steps: max rel logit error {worst:.3e} (tol 3e-2: bf16 "
        f"activations, psum order differs)")
    assert worst <= 3e-2
    return dict(tokens_equal=agree, first_tokens_equal=first,
                tp_decode_rel_err=worst, serve_s=(t1, t4))


# -- main ----------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU TP=4 serving phase")
    ap.add_argument("--workdir", default=os.path.join(REPO, ".cache",
                                                      "smoke"))
    args = ap.parse_args(argv)

    import jax

    from tpu_llm.config import tinyllama_1_1b
    from tpu_llm.runtime.compile_cache import enable_compile_cache

    log("== phase 1: device")
    dev = device_info()
    log(f"  jax: platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']} (jax {jax.__version__})")
    if dev["platform"] != "gpu":
        log("  no GPU found: this check needs a CUDA device")
        return 1
    log(f"  nvidia-smi name, power.limit: {card_name_and_power()}")
    enable_compile_cache()
    os.makedirs(args.workdir, exist_ok=True)

    cfg = tinyllama_1_1b()
    gguf = os.path.join(args.workdir, f"tinyllama-q4_0-seed{args.seed}.gguf")
    t0 = time.perf_counter()
    write_llama_gguf(gguf, cfg, args.seed, context=4096)
    log(f"  wrote {gguf} ({os.path.getsize(gguf) / 2**20:.0f} MiB) in "
        f"{time.perf_counter() - t0:.1f}s")

    if args.four:
        log("== four cards: TP=4 serving against one card")
        four_card(gguf, args.seed)
        dev = device_info()
    else:
        log("== phase 2: kernels against the plain reference")
        kernel_parity(cfg, args.seed)
        log("== phase 3: kernel against plain XLA")
        kernel_timings(cfg, args.seed)
        end_to_end_timings(cfg, args.seed)
        log("== phase 4: end to end")
        end_to_end(gguf, args.seed, long_words=2100)
        f32_against_oracle(args.workdir)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
