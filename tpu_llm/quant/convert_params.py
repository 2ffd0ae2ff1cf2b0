"""Quantize loaded parameter pytrees to packed QTensors (weight-only).

Used by benchmarks and by converters when the source checkpoint is f32/f16
but serving should run Q4_0/Q8_0 (the reference's four_bit_dev capability:
quantize offline, decode from packed blocks).
"""

from __future__ import annotations

from typing import Dict, Sequence

import jax.numpy as jnp
import numpy as np

from tpu_llm.quant.qtensor import QTensor, qmap, quantize_tensor

LLAMA_PROJ_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def _quantize_stacked(w, kind: str) -> QTensor:
    """(L, K, N) dense -> stacked QTensor."""
    w = np.asarray(w, np.float32)
    qts = [quantize_tensor(w[l], kind) for l in range(w.shape[0])]
    return qmap(lambda *xs: jnp.stack(xs), *qts)


def quantize_llama_params(
    params: Dict,
    kind: str = "q4_0",
    layer_keys: Sequence[str] = LLAMA_PROJ_KEYS,
    quantize_cls: bool = True,
    fuse: bool = False,
) -> Dict:
    """Replace projection weights with packed QTensors. Norms and the
    embedding stay dense (tiny, and gathers want dense rows).

    ``fuse=True`` additionally concatenates wq|wk|wv -> wqkv and
    w1|w3 -> w13 along the output axis (the reference's fused layout,
    read_ggml.f90:265,340): 7 -> 4 projection kernels per layer — wider
    N per kernel and fewer launches. Fused params are NOT compatible
    with the TP sharding specs (head-aligned column split); use unfused
    for tensor parallelism."""
    out = dict(params)
    out["layers"] = dict(params["layers"])
    for key in layer_keys:
        if key in out["layers"] and not isinstance(out["layers"][key], QTensor):
            out["layers"][key] = _quantize_stacked(out["layers"][key], kind)
    if quantize_cls and params.get("wcls") is not None:
        if not isinstance(params["wcls"], QTensor):
            out["wcls"] = quantize_tensor(np.asarray(params["wcls"], np.float32), kind)
    if fuse:
        out["layers"] = fuse_llama_layers(out["layers"])
    return out


def fold_rope_interleave(params: Dict, cfg):
    """Fold the interleaved-RoPE pairing into the wq/wk weight layout.

    Interleaved RoPE rotates dim pairs (2j, 2j+1), which costs a
    (B, T, H, D/2, 2) reshape relayout per q/k per layer. Permuting each
    head's wq/wk
    output columns to [evens, odds] makes the SAME rotation the neox
    half-split form — two contiguous lane-axis slices, no relayout:
    interleaved-rope(W x) == neox-rope(P W x) with identical angle tables
    (exponent 2j/D on pair j either way). The attention dot q.k is
    permutation-invariant, v/wo are untouched, so logits are unchanged
    (up to f32 summation order). Cache contents become head-dim-permuted.

    Returns (params', cfg') with cfg'.rope_variant == "neox". No-op for
    non-interleaved variants and partial-rope (rope_dims) models."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    if cfg.rope_variant != "interleaved" or cfg.rope_dims is not None:
        return params, cfg
    D = cfg.head_dim
    base = np.concatenate([np.arange(0, D, 2), np.arange(1, D, 2)])

    def head_perm(n_heads):
        return (np.arange(n_heads)[:, None] * D + base[None, :]).reshape(-1)

    qperm = head_perm(cfg.n_heads)                    # (E,)
    kperm = head_perm(cfg.n_kv_heads)                 # (KV,)
    KV = cfg.kv_dim

    def permute(w, perm):
        perm = jnp.asarray(perm, jnp.int32)
        if isinstance(w, QTensor):
            return qmap(lambda p: jnp.take(p, perm, axis=-1), w)
        return jnp.take(w, perm, axis=-1)

    def fold_layer(lp):
        lp = dict(lp)
        if "wqkv" in lp:
            E = cfg.dim
            full = np.concatenate(
                [qperm, E + kperm, E + KV + np.arange(KV)])
            lp["wqkv"] = permute(lp["wqkv"], full)
        else:
            lp["wq"] = permute(lp["wq"], qperm)
            lp["wk"] = permute(lp["wk"], kperm)
            if "bq" in lp:
                lp["bq"] = jnp.take(lp["bq"], jnp.asarray(qperm), axis=-1)
                lp["bk"] = jnp.take(lp["bk"], jnp.asarray(kperm), axis=-1)
        return lp

    out = dict(params)
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        out["layers"] = [fold_layer(lp) for lp in layers]
    else:
        out["layers"] = fold_layer(layers)
    return out, dataclasses.replace(cfg, rope_variant="neox")


def _concat_n(ws):
    """Concat weights along the output (N) axis; QTensor planes concat
    directly — packing is per-column independent in the (K/2, N) layout."""
    if isinstance(ws[0], QTensor):
        return qmap(lambda *ps: jnp.concatenate(ps, axis=-1), *ws)
    return jnp.concatenate(ws, axis=-1)


def fuse_llama_layers(layers: Dict) -> Dict:
    """wq|wk|wv -> wqkv, w1|w3 -> w13 (dense or QTensor, stacked or not).
    Biased variants (phi-2) are left unfused."""
    if "bq" in layers:
        return dict(layers)
    out = dict(layers)
    if "wq" in out:
        out["wqkv"] = _concat_n([out.pop("wq"), out.pop("wk"), out.pop("wv")])
    if "w1" in out:
        out["w13"] = _concat_n([out.pop("w1"), out.pop("w3")])
    return out


def _requant_row_scaled(qt: QTensor, w: np.ndarray) -> QTensor:
    """diag(w) @ dequantize(qt), requantized in qt's own kind. ONE extra
    quantization rounding — the error is one quant LSB of the scaled
    block, bounded by test_fold_norms_requant_numerics."""
    from tpu_llm.quant.qtensor import dequantize

    kind_map = {
        "q4_0": "q4_0", "q8_0": "q8_0", "q4_1": "q4_1",
        "q5_0": "q5_0", "q5_1": "q5_1",
        "q2_k": "q2_k", "q2_kp": "q2_k", "q3_k": "q3_k", "q3_kp": "q3_k",
        "q6_k": "q6_k", "q6_kp": "q6_k",
    }
    kind = kind_map.get(qt.kind)
    if kind is None:
        raise NotImplementedError(f"norm fold for kind {qt.kind}")
    dense = np.asarray(dequantize(qt, jnp.float32), np.float32)
    out = quantize_tensor(dense * w[:, None], kind)
    if qt.kind == "q6_kp":
        from tpu_llm.quant.qtensor import pack_q6_k

        out = pack_q6_k(out)
    return out


def fold_norms_requant(params: Dict, cfg) -> Dict:
    """Fold the per-layer rmsnorm WEIGHTS into the following projections
    so decode pays zero norm-weight reads: rmsnorm(x, w) @ W ==
    rmsnorm(x, None) @ (diag(w) W) — 2 x L small reads per step fewer.

    Dense weights fold EXACTLY. Quantized weights are dequantized,
    row-scaled, and REQUANTIZED in their own kind — one extra rounding
    (opt-in: ``llm --fold-norms``; exact-parity runs leave it off).
    Scope: rmsnorm llama-family (no layernorm biases, no parallel-block
    shared norms, no MoE routers), unstacked or stacked layer params;
    the folded norm entries become None (weightless rmsnorm)."""
    if getattr(cfg, "use_layernorm", False) or \
            getattr(cfg, "parallel_block", False) or \
            getattr(cfg, "n_experts", 0):
        raise NotImplementedError(
            "norm folding supports the rmsnorm llama family")

    def fold_into(w, weight):
        nw = np.asarray(w, np.float32)
        if isinstance(weight, QTensor):
            return _requant_row_scaled(weight, nw)
        return jnp.asarray(
            np.asarray(weight, np.float32) * nw[:, None]
        ).astype(weight.dtype)

    def fold_layer(lp):
        out = dict(lp)
        an, fn = lp["attn_norm"], lp["ffn_norm"]
        for k in ("wqkv", "wq", "wk", "wv"):
            if k in out:
                out[k] = fold_into(an, out[k])
        for k in ("w13", "w1", "w3"):
            if k in out:
                out[k] = fold_into(fn, out[k])
        out["attn_norm"] = None
        out["ffn_norm"] = None
        return out

    out = dict(params)
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        out["layers"] = [fold_layer(lp) for lp in layers]
    else:
        from tpu_llm.models.llama import unstack_layers

        unst = unstack_layers(params)["layers"]
        folded = [fold_layer(lp) for lp in unst]
        stacked = {}
        for k in folded[0]:
            leaves = [lp[k] for lp in folded]
            if leaves[0] is None:
                stacked[k] = None
            elif isinstance(leaves[0], QTensor):
                stacked[k] = qmap(lambda *ps: jnp.stack(ps), *leaves)
            else:
                stacked[k] = jnp.stack(leaves)
        out["layers"] = stacked
    # final_norm -> classifier (tied-embedding models keep the weight:
    # tok_emb is consumed by the gather too)
    if params.get("wcls") is not None and params.get("final_norm") is not None:
        out["wcls"] = fold_into(params["final_norm"], params["wcls"])
        out["final_norm"] = None
    return out
