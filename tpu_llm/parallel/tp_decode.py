"""Explicit tensor-parallel decode step (shard_map).

The GSPMD path (parallel/sharding.py) lets XLA partition the stacked-scan
forward — correct, but it keeps the lax.scan layer loop with its
per-layer weight slice copies, and GSPMD does not partition a
``pallas_call``. This module is the serving-grade alternative:

- params are UNSTACKED per-layer buffers (no scan, no slice copies);
- the whole decode step runs under ``shard_map``, so every kernel that
  ``kernels.select`` picks — the quantized matmul, decode attention —
  sees its LOCAL shard shape and runs exactly as it does on one device;
- collectives are explicit and Megatron-placed: one psum after ``wo``,
  one after ``w2`` (llama2.f90:603-620's two row-parallel matvecs), and
  one tiled all-gather for the vocab-sharded classifier.

Layout (per shard, tp = mesh "model" axis size, constraint tp | n_kv_heads):
  wq/wk/wv column-parallel -> local heads H/tp, KV heads Hkv/tp;
  wo row-parallel; w1/w3 column-parallel; w2 row-parallel;
  KV cache flat (B, S, (Hkv/tp)*D) local planes; wcls (E, V/tp).

Fused QKV / gate-up layouts compose with TP after a one-time column
permutation (``repack_fused_for_tp``): shard s owns columns
[q_s | k_s | v_s] (resp. [w1_s | w3_s]), so the fused matmul stays ONE
kernel per layer per shard and in-shard slicing recovers q/k/v.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_llm.config import LlamaConfig
from tpu_llm.models.llama import _attend
from tpu_llm.ops.attention import update_kv_cache
from tpu_llm.ops.norms import rmsnorm
from tpu_llm.ops.activations import silu
from tpu_llm.ops.rope import apply_rope
from tpu_llm.quant.linear import matmul
from tpu_llm.quant.qtensor import QTensor


def _gather_cols(w, idx: np.ndarray):
    """Permute the output (N) axis of a dense or QTensor weight."""
    if isinstance(w, QTensor):
        from tpu_llm.quant.qtensor import qmap
        return qmap(lambda p: p[..., idx], w)
    return w[..., idx]


def repack_fused_for_tp(layers, cfg: LlamaConfig, tp: int):
    """Permute fused wqkv / w13 columns so each TP shard's column block is
    [q_s | k_s | v_s] (resp. [w1_s | w3_s]). Run once at load time."""
    E, KV, F = cfg.dim, cfg.kv_dim, cfg.hidden_dim
    assert cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0
    assert F % tp == 0

    def seg(start, size, parts):
        return np.split(np.arange(start, start + size), parts)

    qs, ks, vs = seg(0, E, tp), seg(E, KV, tp), seg(E + KV, KV, tp)
    qkv_idx = np.concatenate([np.concatenate([qs[s], ks[s], vs[s]])
                              for s in range(tp)])
    w1s, w3s = seg(0, F, tp), seg(F, F, tp)
    w13_idx = np.concatenate([np.concatenate([w1s[s], w3s[s]])
                              for s in range(tp)])

    def one(lp):
        out = dict(lp)
        if "wqkv" in lp:
            out["wqkv"] = _gather_cols(lp["wqkv"], qkv_idx)
        if "w13" in lp:
            out["w13"] = _gather_cols(lp["w13"], w13_idx)
        return out

    if isinstance(layers, (list, tuple)):
        return [one(lp) for lp in layers]
    return one(layers)


def tp_param_specs(layers_keys, fused: bool) -> Dict[str, Any]:
    """Per-layer spec dict for the shard_map in_specs (one dict reused for
    every layer of the unstacked list)."""
    col = P(None, "model")
    row = P("model", None)
    rep = P(None)
    specs = {"attn_norm": rep, "ffn_norm": rep, "wo": row, "w2": row}
    if fused:
        specs["wqkv"] = col
        specs["w13"] = col
    else:
        specs.update(wq=col, wk=col, wv=col, w1=col, w3=col)
    unsupported = [k for k in layers_keys if k not in specs]
    if unsupported:
        raise NotImplementedError(
            f"shard_map TP decode supports the unbiased llama layout; "
            f"layer params {unsupported} (biased/phi-2 families) shard "
            f"through the GSPMD path (parallel.sharding.llama_param_specs)"
        )
    return {k: specs[k] for k in layers_keys}


def make_tp_decode_step(cfg: LlamaConfig, mesh: Mesh, fused: bool = False,
                        layers_keys=None):
    """Build a jitted shard_map decode step.

    step(params, token (B,), cache, pos scalar) -> (logits (B, V) f32,
    cache). ``params`` must be unstacked (list of per-layer dicts) with
    flat local KV cache planes; place them with ``shard_tp_params`` /
    ``init_tp_cache``."""
    from jax import shard_map

    tp = mesh.shape["model"]
    assert cfg.n_heads % tp == 0, (cfg.n_heads, tp)
    assert cfg.n_kv_heads % tp == 0, \
        f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads} (head-aligned TP)"
    assert cfg.hidden_dim % tp == 0 and cfg.vocab_size % tp == 0
    Hl, Hkvl, D = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim
    E, F, KVl = cfg.dim, cfg.hidden_dim, cfg.n_kv_heads // tp * cfg.head_dim
    Fl = F // tp

    if layers_keys is None:
        layers_keys = ("attn_norm", "ffn_norm", "wqkv", "wo", "w13", "w2") \
            if fused else ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo",
                           "w1", "w3", "w2")
    lspec = tp_param_specs(layers_keys, fused)
    pspec = {
        "tok_emb": P(None, None),
        "final_norm": P(None),
        "wcls": P(None, "model"),
        "layers": [lspec] * cfg.n_layers,
    }

    def body(params, token, cache_k, cache_v, pos):
        B = token.shape[0]
        x = jnp.take(params["tok_emb"], token[:, None], axis=0)   # (B,1,E)
        positions = pos + jnp.arange(1, dtype=jnp.int32)
        new_k, new_v = [], []
        for i, lp in enumerate(params["layers"]):
            h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
            if "wqkv" in lp:
                qkv = matmul(h, lp["wqkv"])                       # (B,1,(E+2KV)/tp)
                El = Hl * D
                q = qkv[..., :El]
                k = qkv[..., El:El + KVl]
                v = qkv[..., El + KVl:]
            else:
                q = matmul(h, lp["wq"])
                k = matmul(h, lp["wk"])
                v = matmul(h, lp["wv"])
            q = q.reshape(B, 1, Hl, D)
            k = k.reshape(B, 1, Hkvl, D)
            v = v.reshape(B, 1, Hkvl, D)
            q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_variant,
                           cfg.rope_dims, cfg.rope_scaling)
            k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_variant,
                           cfg.rope_dims, cfg.rope_scaling)
            kc, vc = update_kv_cache(cache_k[i], cache_v[i], k, v, pos)
            new_k.append(kc)
            new_v.append(vc)
            attn = _attend(q, kc, vc, positions, pos)             # local heads
            attn_out = matmul(attn.reshape(B, 1, Hl * D), lp["wo"])
            attn_out = jax.lax.psum(attn_out, "model")            # row-parallel
            x = x + attn_out
            m = rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
            if "w13" in lp:
                h13 = matmul(m, lp["w13"])                        # (B,1,2F/tp)
                mid = silu(h13[..., :Fl]) * h13[..., Fl:]
            else:
                mid = silu(matmul(m, lp["w1"])) * matmul(m, lp["w3"])
            mlp = jax.lax.psum(matmul(mid, lp["w2"]), "model")    # row-parallel
            x = x + mlp
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = matmul(x, params["wcls"], out_dtype=jnp.float32)  # (B,1,V/tp)
        logits = jax.lax.all_gather(
            logits[:, 0, :], "model", axis=-1, tiled=True)         # (B, V)
        return logits, new_k, new_v

    cache_spec = P("data", None, "model")     # flat (B, S, Hkv*D/tp) planes
    cspecs = [cache_spec] * cfg.n_layers
    step = shard_map(
        body, mesh=mesh,
        in_specs=(pspec, P("data"), cspecs, cspecs, P()),
        out_specs=(P("data", None), cspecs, cspecs),
        check_vma=False,
    )

    @jax.jit
    def decode_step(params, token, cache, pos):
        logits, k, v = step(params, token, cache["k"], cache["v"], pos)
        return logits, {"k": k, "v": v}

    return decode_step


def shard_tp_params(params, cfg: LlamaConfig, mesh: Mesh, fused: bool = False):
    """device_put unstacked params under the TP layout (column/row specs as
    in the module docstring). Fused layouts must already be repacked with
    ``repack_fused_for_tp``."""
    layers = params["layers"]
    assert isinstance(layers, (list, tuple)), "TP decode needs unstacked params"
    lspec = tp_param_specs(tuple(layers[0].keys()), fused)

    def put(leaf, spec):
        sh = NamedSharding(mesh, spec)
        if isinstance(leaf, QTensor):
            from tpu_llm.quant.qtensor import qmap
            return qmap(lambda p: jax.device_put(p, sh), leaf)
        return jax.device_put(leaf, sh)

    out = {
        "tok_emb": put(params["tok_emb"], P(None, None)),
        "final_norm": put(params["final_norm"], P(None)),
        "wcls": put(params["wcls"], P(None, "model")),
        "layers": [
            {k: put(v, lspec[k]) for k, v in lp.items()} for lp in layers
        ],
    }
    return out


def init_tp_cache(cfg: LlamaConfig, mesh: Mesh, batch: int, max_seq: int,
                  dtype=jnp.bfloat16):
    """Unstacked flat KV planes placed under the TP cache sharding."""
    sh = NamedSharding(mesh, P("data", None, "model"))
    flat = (batch, max_seq, cfg.kv_dim)
    mk = lambda: jax.device_put(jnp.zeros(flat, dtype), sh)  # noqa: E731
    return {"k": [mk() for _ in range(cfg.n_layers)],
            "v": [mk() for _ in range(cfg.n_layers)]}
