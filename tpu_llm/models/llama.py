"""Llama-family transformer (TinyLlama-1.1B, Llama-2, phi-2 variants).

Functional core: ``forward(params, cfg, tokens, cache, offset)`` — a pure,
jittable step that serves both prefill (T > 1) and decode (T = 1), with the
KV cache as an explicit donated pytree. Layers run under ``lax.scan`` over
parameters stacked on a leading L axis (one compiled block, fast
compiles), replacing the reference's per-layer Fortran loop
(``llama2.f90:523-624``).

Numerics parity with the reference (pinned by tests/test_llama.py and
tests/test_ops.py against the tests/reference_impl.py oracle):
RMSNorm eps-inside-mean (llama2.f90:454), interleaved RoPE (llama2.f90:543-
559; exact 1-based variant available as rope_variant="llmf90"), correct GQA
kv-head mapping h // kv_groups (the INTENT of llama2.f90:581 — the literal
Fortran slice is buggy, SURVEY.md §2 #13), SwiGLU (llama2.f90:610-620),
full-vocab classifier (llama2.f90:634-636).

Weights may be dense ``jax.Array``s or packed ``QTensor``s (Q4_0/Q8_0) —
projection matmuls dispatch through ``tpu_llm.quant.linear.matmul``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_llm.config import LlamaConfig
from tpu_llm.ops.activations import gelu, silu
from tpu_llm.ops.attention import gqa_attention, update_kv_cache
from tpu_llm.ops.norms import layernorm, rmsnorm
from tpu_llm.ops.rope import _rotate, apply_rope, rope_angles
from tpu_llm.quant.linear import matmul

Params = Dict[str, Any]
Cache = Dict[str, jax.Array]


# -- KV cache ----------------------------------------------------------------

def init_cache(
    cfg: LlamaConfig, batch: int = 1, max_seq: Optional[int] = None, dtype=jnp.float32,
    stacked: bool = True,
) -> Cache:
    """Preallocated static-shape KV cache.

    ``stacked=True``: one (L, B, S, Hkv, D) array per plane — required by
    the lax.scan layer loop and the sharding specs. ``stacked=False``:
    a list of per-layer (B, S, Hkv, D) arrays matching unstacked params
    (see ``unstack_layers``) — the python layer loop reads/writes each
    buffer directly, no per-layer slice copies.

    The reference allocates (kv_head_size, seq_len, n_layers) per-stream
    f32 (llama2.f90:311-313); here batch is first-class and dtype is a
    policy knob: f32 / bf16 / the string "int8" (QuantKV planes — int8
    values + per-(token, head) f32 scales, tpu_llm.ops.kv_cache)."""
    s = max_seq or cfg.seq_len
    quant = dtype == "int8"
    if stacked:
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
        if quant:
            from tpu_llm.ops.kv_cache import QuantKV

            return {"k": QuantKV.zeros(shape), "v": QuantKV.zeros(shape)}
        return {"k": jnp.zeros(shape, dtype), "v": jnp.zeros(shape, dtype)}
    # unstacked planes store FLAT (B, S, Hkv*D): a token's write is one
    # contiguous row, updated in place in the donated buffer
    shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
    if quant:
        from tpu_llm.ops.kv_cache import QuantKV

        mk = lambda: QuantKV.zeros(shape, flat=True)  # noqa: E731
    else:
        flat = (batch, s, cfg.n_kv_heads * cfg.head_dim)
        mk = lambda: jnp.zeros(flat, dtype)  # noqa: E731
    return {
        "k": [mk() for _ in range(cfg.n_layers)],
        "v": [mk() for _ in range(cfg.n_layers)],
    }


def unstack_layers(params: Params) -> Params:
    """Stacked (L, ...) layer params -> list of per-layer dicts.

    The lax.scan layer loop dynamic-slices every layer's weights out of
    the stacked buffers each step — for quantized decode a slice COPY
    can double the weight bytes read in front of each kernel. Unstacked
    params are separate buffers the kernels read in place; ``forward``
    python-loops over them."""
    from tpu_llm.quant.qtensor import QTensor

    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        return params
    any_leaf = next(iter(layers.values()))
    L = any_leaf.q.shape[0] if isinstance(any_leaf, QTensor) else any_leaf.shape[0]

    def take(leaf, i):
        if isinstance(leaf, QTensor):
            from tpu_llm.quant.qtensor import qmap

            return qmap(lambda p: p[i], leaf)
        return leaf[i]

    out = dict(params)
    out["layers"] = [
        {k: take(v, i) for k, v in layers.items()} for i in range(L)
    ]
    return out


# -- forward -----------------------------------------------------------------

def _attend(q, kc, vc, positions, offset):
    """Attention over the dense cache. ``kernels.select`` picks the GPU
    flash-decode kernel for one-token decode (it reads each row's cache
    only up to that row's position; the einsum path streams all S slots)
    and cuDNN flash attention for long prefill from position 0, over a
    bf16 or int8 cache (the einsum path materialises (B, T, H, S) f32
    scores). Everything else — int8 decode, float32, vector offsets,
    CPU — takes the einsum path."""
    from tpu_llm.kernels import attention as gpu_attention
    from tpu_llm.kernels import select

    if select.decode_attention(q, kc):
        return gpu_attention.decode_attention(q, kc, vc, positions)
    if select.prefill_attention(q, kc, offset):
        return gpu_attention.prefill_attention(q, kc, vc)
    return gqa_attention(q, kc, vc, positions)


def _norm(cfg: LlamaConfig, x, lp, prefix: str):
    if cfg.use_layernorm:
        return layernorm(x, lp[f"{prefix}_norm"], lp[f"{prefix}_norm_b"], cfg.norm_eps)
    return rmsnorm(x, lp[f"{prefix}_norm"], cfg.norm_eps)


def _expert_slice(w, e):
    """Expert ``e``'s (K, N) weight out of the stacked (Ex, K, N) planes.
    ``e`` may be a traced scalar (decode's gathered-expert path) or a
    python int (the unrolled all-experts loop)."""
    from tpu_llm.quant.qtensor import QTensor, qmap

    take = lambda p: (p[e] if isinstance(e, int)
                      else jax.lax.dynamic_index_in_dim(p, e, 0, False))
    if isinstance(w, QTensor):
        return qmap(take, w)
    return take(w)


def _moe_ffn(cfg: LlamaConfig, x, lp):
    """Mixture-of-experts FFN (Mixtral family, SURVEY scope extension).

    Router: softmax over all experts, top-k, selected weights
    renormalized to sum 1 (llama.cpp build_moe_ffn norm_w semantics for
    LLM_ARCH_LLAMA; HF Mixtral does the same).

    Three compute strategies, chosen by token count (all static-shape):
    - single-token decode: GATHER the k selected experts' stacked weight
      planes by traced index and run k FFNs — HBM reads scale with k,
      not n_experts (llama.cpp's per-token expert dispatch).
    - small-batch decode (1 < B*T and B*T*k < n_experts): gather the
      UNION of selected experts (worst-case B*T*k uniques) and run each
      over the whole batch — expert HBM reads scale with the union, not
      n_experts. Single-chip path; under EP sharding the traced-index
      gather would cross shards, so meshed runs use the dense form.
    - prefill / large-batch: the dense-masked form — every expert
      processes every token, outputs combined by the (B, T, Ex) gate
      matrix. With tokens >> experts all experts are live anyway, the
      all-expert einsum keeps the matmuls large, and the stacked
      expert weights shard over the mesh "expert" axis (EP) with GSPMD
      inserting the combine psum.
    """
    B, T, E = x.shape
    k = cfg.n_experts_used
    act = gelu if cfg.act == "gelu" else silu
    logits = matmul(x, lp["router"], out_dtype=jnp.float32)  # (B, T, Ex)
    probs = jax.nn.softmax(logits, axis=-1)
    topw, topi = jax.lax.top_k(probs, k)                  # (B, T, k)
    topw = topw / jnp.sum(topw, axis=-1, keepdims=True)

    def expert_ffn(w1, w3, w2, xin):
        g = matmul(xin, w1)
        u = matmul(xin, w3)
        return matmul(act(g) * u, w2)

    if B * T == 1:
        out = jnp.zeros((B, T, E), jnp.float32)
        for j in range(k):
            e = topi.reshape(-1)[j]
            y = expert_ffn(_expert_slice(lp["w1e"], e),
                           _expert_slice(lp["w3e"], e),
                           _expert_slice(lp["w2e"], e), x)
            out = out + y.astype(jnp.float32) * topw.reshape(-1)[j]
        return out.astype(x.dtype)

    gates = jnp.sum(
        jax.nn.one_hot(topi, cfg.n_experts, dtype=jnp.float32)
        * topw[..., None], axis=-2)                       # (B, T, Ex)

    import os

    if (1 < B * T and B * T * k < cfg.n_experts
            and not os.environ.get("TPU_LLM_MOE_DENSE")):
        # small-batch decode: gather the UNION of selected experts
        # (U = B*T*k worst-case uniques < n_experts) by traced index and
        # run each over the whole batch — HBM expert reads scale with
        # the union size, not n_experts (llama.cpp's per-token dispatch,
        # batched). Unused-order slots carry all-zero gate columns, so
        # processing them is numerically inert; static shapes throughout.
        flat = topi.reshape(-1)
        used = jnp.zeros((cfg.n_experts,), bool).at[flat].set(True)
        order = jnp.argsort(~used, stable=True)           # used ids first
        out = jnp.zeros((B, T, E), jnp.float32)
        for u in range(B * T * k):
            e = order[u]
            y = expert_ffn(_expert_slice(lp["w1e"], e),
                           _expert_slice(lp["w3e"], e),
                           _expert_slice(lp["w2e"], e), x)
            g = jax.lax.dynamic_index_in_dim(gates, e, axis=-1,
                                             keepdims=False)
            out = out + y.astype(jnp.float32) * g[..., None]
        return out.astype(x.dtype)

    out = jnp.zeros((B, T, E), jnp.float32)
    for e in range(cfg.n_experts):
        y = expert_ffn(_expert_slice(lp["w1e"], e),
                       _expert_slice(lp["w3e"], e),
                       _expert_slice(lp["w2e"], e), x)
        out = out + y.astype(jnp.float32) * gates[..., e][..., None]
    return out.astype(x.dtype)


def _kv_window(cache, w: int):
    """Static window view of the first ``w`` cache slots (token axis).
    Attention over the window equals full-cache attention whenever every
    attended position < w: masked slots past the window carry exactly
    zero softmax weight, so dropping them changes nothing — but the
    attention einsums stop streaming the tail of the plane, which at
    early positions is most of its bytes."""
    from tpu_llm.ops.kv_cache import QuantKV

    if isinstance(cache, QuantKV):
        if cache.q.ndim == 3:  # flat (B, S, Hkv*D), scales (B, Hkv, S)
            return QuantKV(q=cache.q[:, :w], s=cache.s[..., :w])
        return QuantKV(q=cache.q[:, :w], s=cache.s[:, :w])
    return cache[:, :w]


def _block(cfg: LlamaConfig, x, lp, kc, vc, positions, offset,
           attn_fn=None, kv_offset=None, update_fn=None, rope_cs=None,
           kv_window=None, reduce_fn=None):
    # ``reduce_fn`` (tensor parallelism under shard_map): applied to the
    # row-parallel partial sums right after the wo and w2 matmuls —
    # Megatron's two psums per layer — BEFORE the replicated bo/b2 bias
    # adds, so biased models stay exact. cfg must carry the LOCAL
    # (per-shard) head/ffn dims.
    # named scopes reproduce the reference's five timing buckets
    # (llama2.f90:538,561,599,622,638) as XProf trace annotations
    B, T, E = x.shape
    h = _norm(cfg, x, lp, "attn")

    with jax.named_scope("qkv"):
        if "wqkv" in lp:
            # fused QKV — ONE kernel (the reference's layout,
            # read_ggml.f90:265; call count sets the decode floor)
            KV = cfg.kv_dim
            Q = cfg.q_dim
            qkv = matmul(h, lp["wqkv"])
            q = qkv[..., :Q]
            k = qkv[..., Q : Q + KV]
            v = qkv[..., Q + KV :]
        else:
            q = matmul(h, lp["wq"])
            k = matmul(h, lp["wk"])
            v = matmul(h, lp["wv"])
            if "bq" in lp:
                q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]

    q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)

    with jax.named_scope("rope"):
        # angles are position-only — computed ONCE per step by forward()
        # and shared by every layer. Neutral in the unstacked path (XLA
        # CSEs the duplicate sin/cos), but inside lax.scan the angle
        # computation would otherwise rerun every layer iteration.
        if rope_cs is None:
            rope_cs = rope_angles(positions, cfg.head_dim, cfg.rope_theta,
                                  cfg.rope_variant, cfg.rope_dims,
                                  cfg.rope_scaling)
        cos, sin = rope_cs
        q = _rotate(q, cos, sin, cfg.rope_variant, cfg.rope_dims)
        k = _rotate(k, cos, sin, cfg.rope_variant, cfg.rope_dims)

    with jax.named_scope("attention"):
        kc, vc = (update_fn or update_kv_cache)(
            kc, vc, k, v, offset if kv_offset is None else kv_offset
        )
        ka, va = ((kc, vc) if kv_window is None else
                  (_kv_window(kc, kv_window), _kv_window(vc, kv_window)))
        attn = (attn_fn or _attend)(q, ka, va, positions, offset)
        attn = attn.reshape(B, T, cfg.q_dim)
        attn_out = matmul(attn, lp["wo"])
        if reduce_fn is not None:
            attn_out = reduce_fn(attn_out)
        if "bo" in lp:
            attn_out = attn_out + lp["bo"]

    if cfg.parallel_block:
        mlp_in = h                      # attn and MLP share the input norm
    else:
        x = x + attn_out
        mlp_in = _norm(cfg, x, lp, "ffn")

    with jax.named_scope("ffn"):
        if cfg.n_experts:
            assert reduce_fn is None, \
                "shard_map TP reduce is not wired for MoE layers (EP/TP " \
                "MoE shards through the GSPMD path)"
            mlp_out = _moe_ffn(cfg, mlp_in, lp)
            if cfg.parallel_block:
                return x + attn_out + mlp_out, kc, vc
            return x + mlp_out, kc, vc
        gate_act = gelu if cfg.act == "gelu" else silu
        if cfg.gated_mlp and "w13" in lp:
            F = cfg.hidden_dim
            # fused gate|up (read_ggml.f90:340)
            h13 = matmul(mlp_in, lp["w13"])
            mid = gate_act(h13[..., :F]) * h13[..., F:]
        elif cfg.gated_mlp:
            gate = matmul(mlp_in, lp["w1"])
            up = matmul(mlp_in, lp["w3"])
            mid = gate_act(gate) * up
        else:
            mid = matmul(mlp_in, lp["w3"])
            if "b3" in lp:
                mid = mid + lp["b3"]
            mid = gelu(mid) if cfg.act == "gelu" else silu(mid)
        mlp_out = matmul(mid, lp["w2"])
        if reduce_fn is not None:
            mlp_out = reduce_fn(mlp_out)
        if "b2" in lp:
            mlp_out = mlp_out + lp["b2"]

    if cfg.parallel_block:
        x = x + attn_out + mlp_out
    else:
        x = x + mlp_out
    return x, kc, vc


def run_layers(
    layer_params,
    cfg: LlamaConfig,
    x: jax.Array,            # (B, T, E)
    kc: jax.Array,           # (L', B, S, Hkv, D) — any contiguous layer range
    vc: jax.Array,
    positions: jax.Array,
    offset: jax.Array,
    attn_fn=None,
    kv_offset=None,
    act_constraint=None,
    update_fn=None,
    rope_cs=None,
    kv_window=None,
    reduce_fn=None,
):
    """Run a stacked layer range under lax.scan. Factored out of ``forward``
    so pipeline stages (tpu_llm.parallel.pipeline) can run their local layer
    slice on the same code path. Returns (x, new kc, new vc)."""

    def body(carry, xs):
        x = carry
        lp, kc, vc = xs
        x, kc, vc = _block(cfg, x, lp, kc, vc, positions, offset,
                           attn_fn=attn_fn, kv_offset=kv_offset,
                           update_fn=update_fn, rope_cs=rope_cs,
                           kv_window=kv_window, reduce_fn=reduce_fn)
        if act_constraint is not None:
            x = act_constraint(x)
        return x, (kc, vc)

    x, (k_new, v_new) = jax.lax.scan(body, x, (layer_params, kc, vc))
    return x, k_new, v_new


def forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: jax.Array,       # (B, T) int32
    cache: Cache,
    offset: jax.Array,       # scalar OR (B,) int32: position of tokens[:, 0]
    *,
    attn_fn=None,            # override attention (ring/ulysses harnesses)
    kv_offset=None,          # cache write position when it differs from the
                             # rope position (sequence-sharded caches)
    act_constraint=None,     # residual-stream sharding constraint (SP prefill)
    update_fn=None,          # override the cache write (CP decode's
                             # ownership-masked write)
    kv_window=None,          # static int: attend only to cache slots [0, w)
                             # — exact when all positions < w (_kv_window)
    reduce_fn=None,          # TP partial-sum reduce (psum) after wo / w2 —
                             # see _block; cfg must be the LOCAL shard cfg
) -> Tuple[jax.Array, Cache]:
    """Run the transformer trunk. Returns (hidden (B, T, E), new cache).

    A vector ``offset`` gives each batch row its own absolute position —
    the substrate for continuous batching (slots at different depths in
    their sequences share one decode step)."""
    B, T = tokens.shape
    x = jnp.take(params["tok_emb"], tokens, axis=0)
    if cfg.emb_scale != 1.0:
        # gemma scales hidden states by sqrt(dim) after the embedding
        x = (x.astype(jnp.float32) * cfg.emb_scale).astype(x.dtype)
    if act_constraint is not None:
        x = act_constraint(x)
    if offset.ndim == 0:
        positions = offset + jnp.arange(T, dtype=jnp.int32)          # (T,)
    else:
        positions = offset[:, None] + jnp.arange(T, dtype=jnp.int32)  # (B, T)

    rope_cs = rope_angles(positions, cfg.head_dim, cfg.rope_theta,
                          cfg.rope_variant, cfg.rope_dims, cfg.rope_scaling)
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        # unstacked fast path: direct per-layer buffers, no slice copies
        k_new, v_new = [], []
        for i, lp in enumerate(layers):
            x, kc, vc = _block(cfg, x, lp, cache["k"][i], cache["v"][i],
                               positions, offset,
                               attn_fn=attn_fn, kv_offset=kv_offset,
                               update_fn=update_fn, rope_cs=rope_cs,
                               kv_window=kv_window, reduce_fn=reduce_fn)
            if act_constraint is not None:
                x = act_constraint(x)
            k_new.append(kc)
            v_new.append(vc)
    else:
        x, k_new, v_new = run_layers(
            layers, cfg, x, cache["k"], cache["v"], positions, offset,
            attn_fn=attn_fn, kv_offset=kv_offset, act_constraint=act_constraint,
            update_fn=update_fn, rope_cs=rope_cs, kv_window=kv_window,
            reduce_fn=reduce_fn,
        )

    x = apply_final_norm(params, cfg, x)
    return x, {"k": k_new, "v": v_new}


def apply_final_norm(params: Params, cfg: LlamaConfig, x: jax.Array) -> jax.Array:
    """The final pre-classifier norm (llama2.f90:627). Exposed for harnesses
    (pipeline parallelism) that run the trunk outside ``forward``."""
    if cfg.use_layernorm:
        return layernorm(x, params["final_norm"], params["final_norm_b"], cfg.norm_eps)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def lm_head(params: Params, cfg: LlamaConfig, x: jax.Array) -> jax.Array:
    """Hidden states (B, T, E) -> logits (B, T, V), always f32.

    Kept separate from ``forward`` so prefill can project only the last
    position (the reference pays the full 2048x32000 classifier matvec on
    every prompt token, llama2.f90:634-636 — we don't)."""
    with jax.named_scope("classifier"):
        if params.get("wcls") is not None:
            # the classifier matmul runs in x's dtype: f32 activations keep
            # the exact reference numerics; bf16 serving gets one bf16
            # pass with f32 accumulation. out_dtype=f32 hands back the
            # accumulator un-rounded.
            logits = matmul(x, params["wcls"], out_dtype=jnp.float32)
        else:  # tied embeddings
            logits = jnp.matmul(
                x.astype(jnp.float32),
                params["tok_emb"].T.astype(jnp.float32),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )
        if "bcls" in params:
            logits = logits + params["bcls"]
        return logits.astype(jnp.float32)


def decode_step(
    params: Params,
    cfg: LlamaConfig,
    token: jax.Array,        # (B,) int32
    cache: Cache,
    pos: jax.Array,          # scalar int32
    kv_window=None,
) -> Tuple[jax.Array, Cache]:
    """One decode step: (B,) token ids at position ``pos`` -> (B, V) logits."""
    x, cache = forward(params, cfg, token[:, None], cache, pos,
                       kv_window=kv_window)
    logits = lm_head(params, cfg, x)[:, 0, :]
    return logits, cache


# -- loading -----------------------------------------------------------------

_LAYER_TENSORS = {
    "wq": "blk.{i}.attn_q.weight",
    "wk": "blk.{i}.attn_k.weight",
    "wv": "blk.{i}.attn_v.weight",
    "wo": "blk.{i}.attn_output.weight",
    "w1": "blk.{i}.ffn_gate.weight",
    "w3": "blk.{i}.ffn_up.weight",
    "w2": "blk.{i}.ffn_down.weight",
}


def config_from_gguf(gguf) -> LlamaConfig:
    """Build the config from GGUF metadata — the reference's key set
    (read_ggml.f90:133-152) plus rope.freq_base.

    Handles the llama-family arches that share the blk.N.* tensor layout:
    "llama" (the reference's scope) and "qwen2" (NeoX rope, QKV biases,
    tied embeddings on the small models) — ggml rotates qwen2 with
    ROPE_TYPE_NEOX while converted llama checkpoints use the pair-
    interleaved NORM form."""
    arch = gguf.hparam("general.architecture", default="llama")
    g = lambda k, d=None: gguf.hparam(f"{arch}.{k}", default=d)
    n_heads = g("attention.head_count")
    dim = g("embedding_length")
    gemma = arch.startswith("gemma")
    head_dim = g("attention.key_length") if gemma else None
    if head_dim is not None and head_dim == dim // n_heads:
        head_dim = None
    # RoPE context-extension metadata: modern <arch>.rope.scaling.* keys,
    # with the legacy <arch>.rope.scale_linear spelling as fallback.
    # Long-context GGUFs (Llama-2 32k, Qwen2 YaRN) mis-rotate silently if
    # these are dropped. "yarn" maps to ggml's rope_yarn defaults (ops/rope).
    scaling_type = g("rope.scaling.type", "none") or "none"
    scaling_factor = float(g("rope.scaling.factor", 1.0))
    orig_ctx = int(g("rope.scaling.original_context_length", 0) or 0)
    legacy_linear = g("rope.scale_linear")
    if scaling_type == "none" and legacy_linear is not None \
            and float(legacy_linear) != 1.0:
        scaling_type, scaling_factor = "linear", float(legacy_linear)
    if scaling_type not in ("none", "linear", "yarn"):
        raise ValueError(
            f"unsupported rope scaling type {scaling_type!r} in {arch} GGUF")
    n_experts = int(g("expert_count", 0) or 0)
    return LlamaConfig(
        n_experts=n_experts,
        n_experts_used=int(g("expert_used_count", 2) or 2) if n_experts else 2,
        dim=dim,
        hidden_dim=g("feed_forward_length"),
        n_layers=g("block_count"),
        n_heads=n_heads,
        n_kv_heads=g("attention.head_count_kv", n_heads),
        vocab_size=len(gguf.metadata.get("tokenizer.ggml.tokens", []))
        or g("vocab_size", 32000),
        seq_len=g("context_length", 2048),
        rope_theta=float(g("rope.freq_base", 10000.0)),
        norm_eps=float(
            g("attention.layer_norm_rms_epsilon", g("attention.layer_norm_epsilon", 1e-5))
        ),
        rope_variant="neox" if (arch == "qwen2" or gemma) else "interleaved",
        use_bias="blk.0.attn_q.bias" in gguf,
        tie_embeddings="output.weight" not in gguf,
        # gemma: GeGLU mlp, sqrt(dim)-scaled embeddings, explicit head_dim
        act="gelu" if gemma else "silu",
        head_dim_=head_dim,
        emb_scale=float(dim) ** 0.5 if gemma else 1.0,
        rope_scaling_type=scaling_type,
        rope_scaling_factor=scaling_factor,
        rope_orig_ctx=orig_ctx,
    )


def _load_weight(gguf, name: str, dtype_policy: str, transpose: bool = True):
    """Load one 2D tensor as x@W-oriented (in, out) — dense or packed."""
    from tpu_llm.io import gguf as gg
    from tpu_llm.quant.qtensor import qtensor_from_ggml

    t = gguf.tensors[name]
    if dtype_policy == "native" and t.ggml_type in (
        gg.GGML_Q4_0, gg.GGML_Q4_1, gg.GGML_Q5_0, gg.GGML_Q5_1, gg.GGML_Q8_0,
        gg.GGML_Q2_K, gg.GGML_Q3_K, gg.GGML_Q4_K, gg.GGML_Q5_K, gg.GGML_Q6_K,
    ):
        rows, row_len = t.shape[0], t.dims[0]
        return qtensor_from_ggml(t.ggml_type, gguf.raw(name), rows, row_len)
    if dtype_policy == "native" and t.ggml_type == gg.GGML_F16:
        w = gguf.array(name)
    else:
        w = gguf.dequantized(name, np.float32)
    arr = np.ascontiguousarray(w.T) if transpose else w
    out = jnp.asarray(arr)
    if dtype_policy == "bf16" or (
        dtype_policy == "native"
        and t.ggml_type not in (gg.GGML_F32, gg.GGML_F16)
    ):
        # 'native' for quantized kinds outside the QTensor list above
        # (e.g. iq-series): dequantize to bf16, not f32 — half the device
        # memory, and the matmuls take bf16 operands anyway
        out = out.astype(jnp.bfloat16)
    return out


def _load_expert_weight(gguf, name: str, dtype_policy: str):
    """Stacked expert tensor ``blk.N.ffn_*_exps.weight`` (ggml 3D: one
    quantized 2D weight per expert, expert-major) -> (Ex, K, N) dense
    array or QTensor with a leading expert axis. Falls back to the legacy
    per-expert split names (``blk.N.ffn_*.{e}.weight``, early Mixtral
    GGUFs) when the stacked tensor is absent."""
    from tpu_llm.io import gguf as gg
    from tpu_llm.quant.qtensor import QTensor, qmap, qtensor_from_ggml

    if name in gguf:
        t = gguf.tensors[name]
        n_exp, rows, row_len = t.shape  # numpy shape (Ex, N_out, K)
        if dtype_policy == "native" and t.ggml_type in (
            gg.GGML_Q4_0, gg.GGML_Q4_1, gg.GGML_Q5_0, gg.GGML_Q5_1,
            gg.GGML_Q8_0, gg.GGML_Q2_K, gg.GGML_Q3_K, gg.GGML_Q4_K,
            gg.GGML_Q5_K, gg.GGML_Q6_K,
        ):
            raw = gguf.raw(name).reshape(n_exp, -1)
            qts = [qtensor_from_ggml(t.ggml_type, raw[e], rows, row_len)
                   for e in range(n_exp)]
            return qmap(lambda *ps: jnp.stack(ps), *qts)
        w = gguf.dequantized(name, np.float32)        # (Ex, N, K)
        out = jnp.asarray(np.ascontiguousarray(w.transpose(0, 2, 1)))
        if dtype_policy in ("bf16", "native"):
            out = out.astype(jnp.bfloat16)
        return out
    # legacy split names
    base = name.replace("_exps.weight", "")
    parts = []
    e = 0
    while f"{base}.{e}.weight" in gguf:
        parts.append(_load_weight(gguf, f"{base}.{e}.weight", dtype_policy))
        e += 1
    if not parts:
        raise KeyError(f"missing expert tensor {name}")
    if isinstance(parts[0], QTensor):
        return qmap(lambda *ps: jnp.stack(ps), *parts)
    return jnp.stack(parts)


def _stack(ws):
    from tpu_llm.quant.qtensor import QTensor

    if isinstance(ws[0], QTensor):
        from tpu_llm.quant.qtensor import qmap

        return qmap(lambda *ps: jnp.stack(ps), *ws)
    return jnp.stack(ws)


def load_gguf(
    path_or_gguf, dtype_policy: str = "f32", fuse: bool = False
) -> Tuple[Params, LlamaConfig]:
    """Load llama-family weights from a GGUF file.

    dtype_policy:
      - "f32": everything dense float32 (reference master-branch parity)
      - "bf16": dense bfloat16 weights (f32 norms)
      - "native": keep storage dtypes — f16 stays f16, Q4_0/Q8_0 stay
        packed as QTensors (fused dequant in the matmul kernels)

    ``fuse=True`` concatenates QKV and gate/up into single matmuls (the
    reference's fused layout, read_ggml.f90:265,340) — fastest decode,
    incompatible with the TP sharding specs.

    Tensor names follow the 11 groups the reference maps
    (read_ggml.f90:238-414).
    """
    from tpu_llm.io.gguf import GGUFFile

    gguf = path_or_gguf if not isinstance(path_or_gguf, str) else GGUFFile(path_or_gguf)
    cfg = config_from_gguf(gguf)

    # gemma stores RMSNorm weights as (w - 1): the applied scale is 1 + w.
    # Folding the +1 at load keeps the runtime norm unchanged.
    arch = gguf.hparam("general.architecture", default="llama")
    norm_off = 1.0 if arch.startswith("gemma") else 0.0

    norm_dtype = jnp.float32
    emb = gguf.dequantized("token_embd.weight", np.float32)
    emb_dtype = jnp.bfloat16 if dtype_policy in ("bf16", "native") else jnp.float32
    params: Params = {
        "tok_emb": jnp.asarray(emb).astype(emb_dtype),
        "final_norm": jnp.asarray(
            norm_off + gguf.dequantized("output_norm.weight", np.float32)
        ).astype(norm_dtype),
    }
    if "output.weight" in gguf:
        params["wcls"] = _load_weight(gguf, "output.weight", dtype_policy)
    else:
        params["wcls"] = None  # tied embeddings (lm_head falls back)

    tensor_map = dict(_LAYER_TENSORS)
    if cfg.n_experts:
        # Mixtral-family MoE: router + stacked expert FFNs replace the
        # dense gate/up/down
        for k in ("w1", "w3", "w2"):
            tensor_map.pop(k)
    layers: Dict[str, list] = {k: [] for k in tensor_map}
    layers["attn_norm"] = []
    layers["ffn_norm"] = []
    if cfg.n_experts:
        layers.update(router=[], w1e=[], w3e=[], w2e=[])
    for i in range(cfg.n_layers):
        layers["attn_norm"].append(jnp.asarray(
            norm_off + gguf.dequantized(f"blk.{i}.attn_norm.weight",
                                        np.float32)))
        layers["ffn_norm"].append(jnp.asarray(
            norm_off + gguf.dequantized(f"blk.{i}.ffn_norm.weight",
                                        np.float32)))
        for key, pat in tensor_map.items():
            layers[key].append(_load_weight(gguf, pat.format(i=i), dtype_policy))
        if cfg.n_experts:
            layers["router"].append(_load_weight(
                gguf, f"blk.{i}.ffn_gate_inp.weight", dtype_policy))
            layers["w1e"].append(_load_expert_weight(
                gguf, f"blk.{i}.ffn_gate_exps.weight", dtype_policy))
            layers["w3e"].append(_load_expert_weight(
                gguf, f"blk.{i}.ffn_up_exps.weight", dtype_policy))
            layers["w2e"].append(_load_expert_weight(
                gguf, f"blk.{i}.ffn_down_exps.weight", dtype_policy))
        # QKV biases (qwen2): 1D, dense f32, additive in the block
        if f"blk.{i}.attn_q.bias" in gguf:
            for bk, name in (("bq", "attn_q"), ("bk", "attn_k"),
                             ("bv", "attn_v")):
                layers.setdefault(bk, []).append(jnp.asarray(
                    gguf.dequantized(f"blk.{i}.{name}.bias", np.float32)))

    params["layers"] = {k: _stack(v) for k, v in layers.items()}
    if fuse:
        from tpu_llm.quant.convert_params import fuse_llama_layers

        params["layers"] = fuse_llama_layers(params["layers"])
    return params, cfg
