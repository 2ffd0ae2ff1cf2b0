"""Sharding specs for model parameters and KV cache.

Megatron-style tensor parallelism expressed as NamedShardings over the
("data", "model") mesh (SURVEY.md §2.3 TP row):

- attention: wq/wk/wv column-parallel (output heads sharded on "model"),
  wo row-parallel (input sharded) — XLA inserts the psum after wo;
- MLP: w1/w3 column-parallel, w2 row-parallel (psum after w2);
- classifier: vocab-column sharded, logits all-gathered by the output
  sharding (sharded sampling is a later optimization);
- KV cache sharded over kv-heads on "model" and batch on "data";
- norms/embedding replicated (small).

``QTensor`` leaves shard like their logical weight: both the packed quants
and the scales carry the same (K-ish, N) axis order, so one spec serves
both planes.

With parameters and cache placed under these shardings, plain ``jax.jit``
partitions the whole decode step (GSPMD); no per-op collective calls
appear in model code.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_llm.config import LlamaConfig
from tpu_llm.quant.qtensor import QTensor


def llama_param_specs(cfg: LlamaConfig, pipe: bool = False,
                      params=None) -> Dict[str, Any]:
    """PartitionSpec pytree matching tpu_llm.models.llama params.

    Layer weights have a leading stacked-L axis; with ``pipe=True`` that
    axis is sharded over the "pipe" mesh axis (pipeline stages own
    contiguous layer ranges — SURVEY.md §2.3 PP row), otherwise it is
    unsharded. Pass ``params`` to prune the spec tree to the keys the
    model actually has (qwen2 carries bq/bk/bv but none of phi-2's
    other bias tensors; tree_map needs identical structures)."""
    lax_ = "pipe" if pipe else None
    col = P(lax_, None, "model")   # (L, in, out): shard outputs
    row = P(lax_, "model", None)   # (L, in, out): shard inputs
    rep1 = P(None)
    repL = P(lax_, None)
    specs: Dict[str, Any] = {
        "tok_emb": P(None, None),
        "final_norm": rep1,
        "wcls": P(None, "model"),
        "layers": {
            "attn_norm": repL,
            "ffn_norm": repL,
            "wq": col, "wk": col, "wv": col, "wo": row,
            "w1": col, "w3": col, "w2": row,
        },
    }
    if cfg.n_experts:
        # MoE (SURVEY §2.3 EP row, now exercised): stacked expert weights
        # shard their leading expert axis over "expert" — each device
        # group holds n_experts/ep experts; the all-expert combine sum
        # becomes the EP psum under GSPMD. TP composes on the inner axes.
        specs["layers"].pop("w1", None)
        specs["layers"].pop("w3", None)
        specs["layers"].pop("w2", None)
        specs["layers"].update(
            router=P(lax_, None, None),
            w1e=P(lax_, "expert", None, "model"),
            w3e=P(lax_, "expert", None, "model"),
            w2e=P(lax_, "expert", "model", None),
        )
    if cfg.use_layernorm:
        specs["final_norm_b"] = rep1
        specs["layers"]["attn_norm_b"] = repL
        if not cfg.parallel_block:
            specs["layers"]["ffn_norm_b"] = repL
    if cfg.use_bias:
        specs["layers"].update(
            bq=P(lax_, "model"), bk=P(lax_, "model"), bv=P(lax_, "model"),
            bo=repL, b3=P(lax_, "model"), b2=repL,
        )
        specs["bcls"] = P("model")
    if cfg.parallel_block:
        specs["layers"].pop("ffn_norm", None)
    if params is not None:
        layer_keys = (set(params["layers"][0].keys())
                      if isinstance(params["layers"], (list, tuple))
                      else set(params["layers"].keys()))
        specs["layers"] = {k: v for k, v in specs["layers"].items()
                           if k in layer_keys}
        missing = layer_keys - set(specs["layers"])
        if missing:
            raise NotImplementedError(
                f"no TP sharding spec for layer params {sorted(missing)}")
        specs = {k: v for k, v in specs.items()
                 if k == "layers" or k in params}
    return specs


def unstack_param_specs(specs: Dict[str, Any], n_layers: int) -> Dict[str, Any]:
    """Stacked-layer spec dict -> the ``unstack_layers`` params structure:
    ``layers`` becomes a list of per-layer spec dicts with the leading
    stacked-L axis dropped from each P (the PagedEngine and the unstacked
    fast path hold per-layer (in, out) weights)."""
    def drop(p: P) -> P:
        return P(*tuple(p)[1:])

    lspec = {k: drop(v) for k, v in specs["layers"].items()}
    out = dict(specs)
    out["layers"] = [dict(lspec) for _ in range(n_layers)]
    return out


def llama_paged_state_spec(n_layers: int, quantized: bool = False) -> Dict[str, Any]:
    """Spec pytree for PagedEngine.state: per-layer (n_blocks, bs, Hkv*D)
    pools sharded on the head-dim axis over "model" (the paged-TP dryrun
    leg's layout); int8 (Hkv, n_blocks, bs) scale pools replicated (small,
    and the quantize/dequantize runs per shard anyway);
    block table + lengths replicated host-controlled metadata."""
    pool = P(None, None, "model")
    rep3 = P(None, None, None)
    return {
        "k": [pool] * n_layers,
        "v": [pool] * n_layers,
        "ks": [rep3] * n_layers if quantized else None,
        "vs": [rep3] * n_layers if quantized else None,
        "table": P(None, None),
        "lengths": P(None),
    }


def llama_cache_spec(quant: bool = False) -> Dict[str, Any]:
    # cache layout (L, B, S, Hkv, D): batch on "data", kv-heads on "model"
    spec = P(None, "data", None, "model", None)
    if quant:
        # int8 cache: scales plane (L, B, S, Hkv) shards the same axes
        from tpu_llm.ops.kv_cache import QuantKV

        leaf = QuantKV(q=spec, s=P(None, "data", None, "model"))
        return {"k": leaf, "v": leaf}
    return {"k": spec, "v": spec}


def shard_pytree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """device_put a params/cache pytree under the given spec pytree.

    QTensor leaves are sharded plane-wise: the packed quants and scales
    share the spec (their differing K extents both map to the same named
    axes)."""

    def place(leaf, spec):
        if leaf is None:
            return None
        if isinstance(leaf, QTensor):
            from tpu_llm.quant.qtensor import qmap

            return qmap(
                lambda p: jax.device_put(p, NamedSharding(mesh, spec)), leaf)
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(
        place, tree, specs,
        is_leaf=lambda x: x is None or isinstance(x, QTensor),
    )
