"""Per-phase decode timing: the reference's five buckets, on-device.

The reference wraps each phase of its decode step in wallclock
accumulators and prints per-token averages at exit (``llama2.f90:403-410``;
buckets updated at :538 qkv, :561 rope, :599 attention, :622 wo+ffn, :638
classifier). Under ``jax.jit`` the phases of one step fuse and overlap, so
they cannot be timed in situ without serializing the program — instead
each bucket is measured as its OWN jitted loop at the real decode shapes
with the real weights, all layers per step, timed after a warm-up run
with ``block_until_ready``.

Semantics match the reference's report: per-token cost of each phase
summed over layers, in ms. Caveat (inherent to any decomposition of a
fused program): buckets are measured in isolation, so their sum can
exceed the fused step time — XLA overlaps phases the Fortran runs
sequentially. The total fused step time is what ``tokens/second`` reports.

Params are jit ARGUMENTS, never closure captures — closure capture bakes
the weights into the HLO as constants (a 1.1B model becomes a ~600 MB
program that remote-compile rejects).
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

from tpu_llm.config import LlamaConfig
from tpu_llm.models.llama import _norm, unstack_layers
from tpu_llm.ops.attention import gqa_attention, update_kv_cache
from tpu_llm.ops.rope import apply_rope
from tpu_llm.ops.activations import gelu, silu
from tpu_llm.quant.linear import matmul

BUCKETS = ("qkv", "rope", "attention", "ffn", "classifier")

# carry mixing factor: keeps every phase output data-dependent on the next
# step's input (so XLA cannot hoist the work out of the loop) while the
# rmsnorm at each phase entry keeps magnitudes bounded
_MIX = 0.01


def _qkv_out(cfg: LlamaConfig, h, lp):
    if "wqkv" in lp:
        out = matmul(h, lp["wqkv"])
        E, KV = cfg.dim, cfg.kv_dim
        return out[..., :E], out[..., E:E + KV], out[..., E + KV:]
    q = matmul(h, lp["wq"])
    k = matmul(h, lp["wk"])
    v = matmul(h, lp["wv"])
    return q, k, v


def _phase_bodies(cfg: LlamaConfig, batch: int, pos: int):
    """[(bucket, body(params, layers, carry) -> carry)] at decode shapes.
    Bodies only read traced arguments — nothing is baked into the HLO."""
    from tpu_llm.models import llama as M

    B, E = batch, cfg.dim
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = jnp.full((1,), pos, jnp.int32)
    offset = jnp.int32(pos)

    # 1. qkv: attn-norm + QKV projection per layer (llama2.f90:527-538)
    def qkv_body(params, layers, x):
        acc = x
        for lp in layers:
            h = _norm(cfg, acc, lp, "attn")
            q, _, _ = _qkv_out(cfg, h, lp)
            acc = acc + _MIX * q
        return acc

    # 2. rope: rotate q and k per layer (llama2.f90:543-561)
    def rope_body(params, layers, x):
        q = x.reshape(B, 1, H, D)
        for _ in layers:
            qr = apply_rope(q, positions, cfg.rope_theta, cfg.rope_variant,
                            cfg.rope_dims, cfg.rope_scaling)
            kr = apply_rope(qr[:, :, :Hkv], positions, cfg.rope_theta,
                            cfg.rope_variant, cfg.rope_dims, cfg.rope_scaling)
            q = qr.at[:, :, :Hkv].add(_MIX * kr)
        return q.reshape(B, 1, E)

    # 3. attention: cache write + GQA attention per layer (llama2.f90:564-599)
    def attn_body(params, layers, carry):
        x, caches = carry
        q = x.reshape(B, 1, H, D)
        k = q[:, :, :Hkv]
        new_caches = []
        for (kc, vc) in caches:
            kc, vc = update_kv_cache(kc, vc, k, k, offset)
            out = gqa_attention(q, kc, vc, positions)
            q = q + _MIX * out
            new_caches.append((kc, vc))
        return (q.reshape(B, 1, E), new_caches)

    # 4. wo + ffn: output proj, residual, ffn-norm, gated MLP (llama2.f90:603-622)
    def ffn_body(params, layers, x):
        acc = x
        for lp in layers:
            attn_out = matmul(acc, lp["wo"])
            h = acc + attn_out
            m = _norm(cfg, h, lp, "ffn")
            if "w13" in lp:
                F = cfg.hidden_dim
                h13 = matmul(m, lp["w13"])
                mid = silu(h13[..., :F]) * h13[..., F:]
            elif "w1" in lp:
                mid = silu(matmul(m, lp["w1"])) * matmul(m, lp["w3"])
            else:
                mid = gelu(matmul(m, lp["w3"]))
            acc = h + matmul(mid, lp["w2"])
            acc = _MIX * acc + x
        return acc

    # 5. classifier: final norm + full-vocab logits (llama2.f90:627-638)
    def cls_body(params, layers, x):
        h = M.apply_final_norm(params, cfg, x)
        logits = M.lm_head(params, cfg, h)
        m = min(E, logits.shape[-1])
        return x.at[..., :m].add(
            _MIX * jnp.tanh(logits[..., :m]).astype(x.dtype))

    return [("qkv", qkv_body), ("rope", rope_body),
            ("attention", attn_body), ("ffn", ffn_body),
            ("classifier", cls_body)]


def measure_phase_times(
    params: Any,
    cfg: LlamaConfig,
    *,
    batch: int = 1,
    pos: int = 128,
    max_seq: int = 256,
    steps: int = 128,
) -> Dict[str, float]:
    """Per-token ms for each of the reference's five buckets, measured on
    device at decode shapes (B x 1) with the loaded weights, attention at
    cache position ``pos``, each over ``steps`` steps. Returns
    {bucket: ms_per_token}."""
    import time

    from tpu_llm.models import llama as M

    pos = min(pos, max_seq - 2)
    x0 = jnp.ones((batch, 1, cfg.dim), params["tok_emb"].dtype) * 0.02
    cache0 = M.init_cache(cfg, batch, max_seq, dtype=params["tok_emb"].dtype,
                          stacked=False)
    caches0 = list(zip(cache0["k"], cache0["v"]))

    out = {}
    for name, body in _phase_bodies(cfg, batch, pos):
        @jax.jit
        def run_n(params, carry, n, body=body):
            layers = unstack_layers(params)["layers"]
            return jax.lax.fori_loop(
                0, n, lambda _, c: body(params, layers, c), carry)

        init_carry = (x0, caches0) if name == "attention" else x0
        n = jnp.int32(steps)
        jax.block_until_ready(run_n(params, init_carry, n))   # compile, warm
        t0 = time.perf_counter()
        jax.block_until_ready(run_n(params, init_carry, n))
        out[name] = (time.perf_counter() - t0) / steps * 1000.0
    return out


def format_report(phase_times: Dict[str, float]) -> str:
    """The reference's exit report shape (llama2.f90:407-410): bucket index
    + per-token average, one line each."""
    lines = [" Timings (ms/token, per-phase on-device)"]
    for i, name in enumerate(BUCKETS, start=1):
        lines.append(f" {i:4d}  {name:<11s}{phase_times.get(name, float('nan')):10.4f}")
    return "\n".join(lines)
