"""Mesh sharding for the serving engines (SURVEY.md §7 step 5).

The batch engines are host loops around jitted device steps, so putting a
serving workload on a mesh needs no engine-code changes: place the params
and KV state once and every jitted step (decode, prefill, verify)
partitions. Two constructions, chosen per engine:

- **shard_map TP adapter** (dense-cache llama BatchEngine): the engine's
  ``adapter.apply``/``lm_head`` run the generic model forward INSIDE
  ``jax.shard_map`` with Megatron col/row-parallel params, explicit psums
  after wo/w2 (``models.llama.forward(reduce_fn=...)``) and a tiled
  all-gather for the vocab-sharded classifier. Every projection and
  attention kernel that ``kernels.select`` picks sees its LOCAL shard
  shape and runs exactly as it does on one device (the construction
  ``parallel/tp_decode.py`` proves, applied to the serving steps).
- **GSPMD path** (paged pools, int8 KV, MoE/EP): params/state under
  NamedShardings and XLA partitions the steps. GSPMD does not partition
  a Pallas call, so these engines' jitted bodies trace under the scoped
  ``kernels.select.kernels_disabled()`` context and keep to plain ops.

The reference has no serving stack at all (single-stream CLI,
llama2.f90:319-428); multi-device serving is a capability added on top.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from tpu_llm.config import LlamaConfig
from tpu_llm.parallel.sharding import (
    llama_cache_spec,
    llama_paged_state_spec,
    llama_param_specs,
    shard_pytree,
    unstack_param_specs,
)


def _tp_local_cfg(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """The per-shard view of the model: heads/ffn divided by tp, head_dim
    pinned explicitly (dim stays global, so the derived head_dim would be
    wrong), everything else unchanged."""
    return dataclasses.replace(
        cfg,
        n_heads=cfg.n_heads // tp,
        n_kv_heads=cfg.n_kv_heads // tp,
        hidden_dim=cfg.hidden_dim // tp,
        head_dim_=cfg.head_dim,
    )


def make_tp_llama_adapter(cfg: LlamaConfig, mesh: Mesh,
                          cache_dtype=jnp.float32, bos_id: int = 1):
    """A ModelAdapter whose apply/lm_head run under shard_map on ``mesh``.

    Params must be placed under ``llama_param_specs`` (unfused layout) and
    the KV state under ``llama_cache_spec`` — the same placement doubles
    as the shard_map in_specs. Batch rides "data" when divisible (the
    batched decode step); batch-1 prefill rows run replicated across
    "data" and scatter into the sharded state outside the shard_map.
    """
    from jax import shard_map

    from tpu_llm.models import llama as M

    tp = mesh.shape.get("model", 1)
    dp = mesh.shape.get("data", 1)
    lcfg = _tp_local_cfg(cfg, tp)
    psum = lambda y: jax.lax.psum(y, "model")  # noqa: E731

    def param_specs(params):
        specs = llama_param_specs(cfg, params=params)
        if isinstance(params.get("layers"), (list, tuple)):
            specs = unstack_param_specs(specs, len(params["layers"]))
        return specs

    def batch_axis(B: int) -> Optional[str]:
        return "data" if (dp > 1 and B >= dp and B % dp == 0) else None

    def apply(params, tokens, state, offset, length=None):
        B, T = tokens.shape
        bax = batch_axis(B)
        cspec = P(None, bax, None, "model", None)
        ospec = P(bax) if getattr(offset, "ndim", 0) else P()

        def body(params, tokens, ck, cv, offset):
            hidden, cache = M.forward(
                params, lcfg, tokens, {"k": ck, "v": cv}, offset,
                reduce_fn=psum)
            return hidden, cache["k"], cache["v"]

        fn = shard_map(
            body, mesh=mesh,
            in_specs=(param_specs(params), P(bax, None), cspec, cspec,
                      ospec),
            out_specs=(P(bax, None, None), cspec, cspec),
            check_vma=False,
        )
        hidden, k, v = fn(params, tokens, state["k"], state["v"], offset)
        return hidden, {"k": k, "v": v}

    def lm_head(params, hidden):
        B = hidden.shape[0]
        bax = batch_axis(B)

        def head(params, hidden):
            logits = M.lm_head(params, lcfg, hidden)   # (B, T, V/tp)
            if params.get("wcls") is not None:
                logits = jax.lax.all_gather(logits, "model", axis=-1,
                                            tiled=True)
            return logits

        fn = shard_map(
            head, mesh=mesh,
            in_specs=(param_specs(params), P(bax, None, None)),
            out_specs=P(bax, None, None),
            check_vma=False,
        )
        return fn(params, hidden)

    def init_state(batch, max_seq):
        cache = M.init_cache(cfg, batch, max_seq, cache_dtype, stacked=True)
        return shard_pytree(cache, llama_cache_spec(quant=False), mesh)

    from tpu_llm.runtime.engine import ModelAdapter

    return ModelAdapter(
        apply=apply,
        lm_head=lm_head,
        init_state=init_state,
        bos_id=bos_id,
        state_batch_axis=1,
        vocab_size=cfg.vocab_size,
    )


def _tp_adapter_eligible(eng: Any, cfg: LlamaConfig) -> bool:
    """Dense stacked-KV llama BatchEngine with unfused projections —
    the shapes the shard_map TP adapter covers."""
    state = eng.state
    if not (isinstance(state, dict) and "k" in state):
        return False
    if isinstance(state["k"], (list, tuple)):
        return False
    if getattr(state["k"], "ndim", 0) != 5:        # QuantKV / flat layouts
        return False
    if cfg.n_experts:
        return False
    layers = eng.params.get("layers")
    lkeys = (set(layers[0].keys()) if isinstance(layers, (list, tuple))
             else set(layers.keys()))
    return "wqkv" not in lkeys and "w13" not in lkeys


def _wrap_kernels_off(eng: Any) -> None:
    """Route the engine's jitted bodies through the scoped kernel disable
    (GSPMD path: Pallas calls don't partition under auto-sharding). The
    flag only matters during the trace; compiled calls are unaffected."""
    from tpu_llm.kernels.select import kernels_disabled

    def wrap(fn):
        def wrapped(*a, **k):
            with kernels_disabled():
                return fn(*a, **k)
        return wrapped

    for name in ("_step", "_verify", "_prefill", "_prefill_part",
                 "_draft_scan", "_draft_prefill", "_decode", "_decode_scan",
                 "_draft_steps"):
        fn = getattr(eng, name, None)
        if fn is not None:
            setattr(eng, name, wrap(fn))


def shard_engine(eng: Any, cfg: LlamaConfig, mesh: Mesh,
                 draft_cfg: Optional[LlamaConfig] = None) -> Any:
    """Place a BatchEngine/PagedEngine's params and KV state on ``mesh``.

    Call right after construction, before the first step (the jitted
    bodies compile against the placed shardings on first call). Batch
    rows ride the "data" axis (dense cache) and attention heads / ffn
    columns the "model" axis; the paged pools shard their Hkv*D axis.

    Two-model speculation: pass ``draft_cfg`` (the draft model's config)
    and the draft params/state get their own placement; the draft must
    share the target's vocabulary and be loaded UNFUSED.
    """
    tp = mesh.shape.get("model", 1)
    if tp > 1 and cfg.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads} (the KV "
            f"cache shards whole kv heads; use Ulysses/CP for wider "
            f"degrees)")
    dp = mesh.shape.get("data", 1)
    if dp > 1 and eng.batch % dp:
        raise ValueError(f"dp={dp} must divide engine batch={eng.batch}")

    params = eng.params
    specs = llama_param_specs(cfg, params=params)
    unstacked = isinstance(params.get("layers"), (list, tuple))
    if unstacked:
        specs = unstack_param_specs(specs, len(params["layers"]))
    eng.params = shard_pytree(params, specs, mesh)

    state = eng.state
    paged = isinstance(state, dict) and "table" in state
    if paged:
        # PagedEngine pools
        spec = llama_paged_state_spec(
            len(params["layers"]), quantized=bool(getattr(eng, "quantized", False))
        )
    elif isinstance(state, dict) and "k" in state:
        from tpu_llm.ops.kv_cache import QuantKV

        quant = isinstance(state["k"], QuantKV)
        if isinstance(state["k"], (list, tuple)):
            raise NotImplementedError(
                "mesh serving needs a stacked KV cache "
                "(ModelAdapter.llama(stacked=True))")
        spec = llama_cache_spec(quant=quant)
    else:
        raise NotImplementedError(
            "mesh serving supports llama-family KV states only")
    eng.state = shard_pytree(state, spec, mesh)
    # reset() (crash recovery) re-places its fresh state the same way
    eng._place_state = lambda st, _spec=spec: shard_pytree(st, _spec, mesh)

    if getattr(eng, "_draft", None) is not None:
        if draft_cfg is None:
            raise NotImplementedError(
                "two-model speculation under a serving mesh needs "
                "shard_engine(..., draft_cfg=<draft LlamaConfig>) so the "
                "draft's params/state get their own placement")
        dparams, dadapter = eng._draft
        dspecs = llama_param_specs(draft_cfg, params=dparams)
        if isinstance(dparams.get("layers"), (list, tuple)):
            dspecs = unstack_param_specs(dspecs, len(dparams["layers"]))
        dparams = shard_pytree(dparams, dspecs, mesh)
        # the draft keeps a dense stacked cache mirroring the slots
        dstate = eng._draft_state
        if isinstance(dstate, dict) and "k" in dstate and \
                getattr(dstate["k"], "ndim", 0) == 5:
            eng._draft_state = shard_pytree(
                dstate, llama_cache_spec(quant=False), mesh)
            eng._place_draft_state = lambda st: shard_pytree(
                st, llama_cache_spec(quant=False), mesh)
            if draft_cfg.n_experts == 0 and not paged:
                dadapter = make_tp_llama_adapter(
                    draft_cfg, mesh, bos_id=dadapter.bos_id)
        eng._draft = (dparams, dadapter)

    if not paged and _tp_adapter_eligible(eng, cfg):
        # per-shard kernel path: swap the adapter before the first trace
        old = eng.adapter
        eng.adapter = make_tp_llama_adapter(
            cfg, mesh, cache_dtype=state["k"].dtype, bos_id=old.bos_id)
    else:
        _wrap_kernels_off(eng)
    eng.mesh = mesh
    return eng
