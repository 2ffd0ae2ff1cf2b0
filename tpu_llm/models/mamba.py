"""Mamba selective-state-space model (Mamba-130M/790M — the reference's
``ssm/`` path).

Functional core mirrors the llama module: ``forward(params, cfg, tokens,
state, length)`` runs prefill (scan over time) or decode (T=1) as one
jitted program; the recurrent state (conv shift-register + SSM state) is
an explicit donated pytree — the reference's O(1)-memory property
(``ssm/weight_module.f90:46-54``) carries over, batched.

Numerics pinned to the reference step (``ssm/mamba.f90:511-665``):
fused add_norm residual stream (xb = rmsnorm(h+res); res = h+res), causal
depthwise conv as a shift register, softplus(dt @ dt_proj + bias),
A = -exp(A_log), dA = exp(dt ⊗ A), dB = dt ⊗ B, state = state·dA + x ⊗ dB,
y = Cᵀ·state + D·x, gate y·silu(z). Layer loop via lax.scan over stacked
params.

Prefill is time-parallel: the first-order linear recurrence
state_t = dA_t·state_{t-1} + dB_t·x_t is evaluated with
``jax.lax.associative_scan`` (combine (a1,b1)∘(a2,b2) = (a2·a1, a2·b1+b2)),
the causal depthwise conv as a sum of shifted slices, and every projection
as one full-sequence matmul — the batched answer to the reference's
token-at-a-time prefill (``ssm/mamba.f90:413-415``). The exact sequential
recurrence is kept (``forward(..., sequential=True)``) as the numerics
oracle and the T=1 decode step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_llm.config import MambaConfig
from tpu_llm.ops.activations import silu
from tpu_llm.ops.norms import rmsnorm

Params = Dict[str, Any]
State = Dict[str, jax.Array]


def init_state(cfg: MambaConfig, batch: int = 1, stacked: bool = True) -> State:
    """``stacked=False`` pairs with ``unstack_layers`` params: per-layer
    state buffers for the python layer loop (no scan slice copies)."""
    conv_shape = (batch, cfg.d_conv, cfg.d_inner)
    ssm_shape = (batch, cfg.d_state, cfg.d_inner)
    if stacked:
        return {
            "conv": jnp.zeros((cfg.n_layers,) + conv_shape, jnp.float32),
            "ssm": jnp.zeros((cfg.n_layers,) + ssm_shape, jnp.float32),
        }
    return {
        "conv": [jnp.zeros(conv_shape, jnp.float32) for _ in range(cfg.n_layers)],
        "ssm": [jnp.zeros(ssm_shape, jnp.float32) for _ in range(cfg.n_layers)],
    }


def cast_weights(params: Params, dtype=jnp.bfloat16) -> Params:
    """Weight-only dtype cast (serving mode): every f32 weight leaf ->
    ``dtype``; the recurrent state and all matmul accumulations stay f32
    (``preferred_element_type`` throughout the mixer), so this halves the
    weight bytes read per token at weight-rounding cost only. The
    f32 default remains the reference-parity path (ssm/mamba.f90 is
    f32)."""
    return jax.tree_util.tree_map(
        lambda x: x.astype(dtype) if x.dtype == jnp.float32 else x, params
    )


def unstack_layers(params: Params) -> Params:
    """Stacked (L, ...) layer params -> list of per-layer dicts.

    Same rationale as llama.unstack_layers: the lax.scan layer loop
    dynamic-slices every layer's weights out of the stacked buffers each
    decode step — a copy of every weight. Pair with
    ``init_state(..., stacked=False)``."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        return params
    L = next(iter(layers.values())).shape[0]
    out = dict(params)
    out["layers"] = [{k: v[i] for k, v in layers.items()} for i in range(L)]
    return out


def split_projections(params: Params) -> Params:
    """Split the fused in_proj / x_proj weights into their consumers:
    in_proj (E, 2di) -> in_proj_x + in_proj_z; x_proj (di, dr+2ds) ->
    xp_dt + xp_b + xp_c.

    Available as an opt-in layout transform; its effect on the GPU has
    not been measured. Works on stacked
    (L, ...) or unstacked layer params; _mixer_step/_mixer_scan accept
    either layout."""
    def split_layer(lp, di, dr, ds):
        lp = dict(lp)
        ip = lp.pop("in_proj")
        lp["in_proj_x"], lp["in_proj_z"] = ip[..., :di], ip[..., di:]
        xp = lp.pop("x_proj")
        lp["xp_dt"] = xp[..., :dr]
        lp["xp_b"] = xp[..., dr : dr + ds]
        lp["xp_c"] = xp[..., dr + ds :]
        return lp

    layers = params["layers"]
    out = dict(params)
    if isinstance(layers, (list, tuple)):
        if "in_proj" not in layers[0]:
            return params
        di = layers[0]["in_proj"].shape[-1] // 2
        ds = layers[0]["A_log"].shape[-2]
        dr = layers[0]["x_proj"].shape[-1] - 2 * ds
        out["layers"] = [split_layer(lp, di, dr, ds) for lp in layers]
        return out
    if "in_proj" not in layers:
        return params
    di = layers["in_proj"].shape[-1] // 2
    ds = layers["A_log"].shape[-2]
    dr = layers["x_proj"].shape[-1] - 2 * ds
    out["layers"] = split_layer(layers, di, dr, ds)
    return out


def _in_proj(lp, xb):
    """(x, z) halves — pre-split weights when available."""
    if "in_proj_x" in lp:
        x = jnp.matmul(xb, lp["in_proj_x"], preferred_element_type=jnp.float32)
        z = jnp.matmul(xb, lp["in_proj_z"], preferred_element_type=jnp.float32)
        return x, z
    d_inner = lp["in_proj"].shape[-1] // 2
    xz = jnp.matmul(xb, lp["in_proj"], preferred_element_type=jnp.float32)
    return xz[..., :d_inner], xz[..., d_inner:]


def _x_proj(lp, x, dt_rank, d_state):
    """(dt, B, C) — pre-split weights when available."""
    if "xp_dt" in lp:
        dt = jnp.matmul(x, lp["xp_dt"], preferred_element_type=jnp.float32)
        Bv = jnp.matmul(x, lp["xp_b"], preferred_element_type=jnp.float32)
        Cv = jnp.matmul(x, lp["xp_c"], preferred_element_type=jnp.float32)
        return dt, Bv, Cv
    x_db = jnp.matmul(x, lp["x_proj"], preferred_element_type=jnp.float32)
    return (x_db[..., :dt_rank], x_db[..., dt_rank : dt_rank + d_state],
            x_db[..., dt_rank + d_state :])


def _mixer_step(cfg: MambaConfig, lp, xb, conv_state, ssm_state):
    """One token through one Mamba mixer. xb: (B, E)."""
    d_inner, d_state, dt_rank = cfg.d_inner, cfg.d_state, cfg.dt_rank_

    x, z = _in_proj(lp, xb)

    # causal depthwise conv as shift register (ssm/mamba.f90:616-621)
    conv_state = jnp.concatenate([conv_state[:, 1:], x[:, None, :]], axis=1)
    x = jnp.sum(conv_state * lp["conv_w"][None], axis=1) + lp["conv_b"]
    x = silu(x)

    dt, Bv, Cv = _x_proj(lp, x, dt_rank, d_state)

    dt = jnp.matmul(dt, lp["dt_proj"], preferred_element_type=jnp.float32)
    dt = jax.nn.softplus(dt + lp["dt_bias"])          # (B, d_inner)
    A = -jnp.exp(lp["A_log"])                          # (d_state, d_inner)
    dA = jnp.exp(dt[:, None, :] * A[None])             # (B, d_state, d_inner)
    dB = dt[:, None, :] * Bv[:, :, None]
    ssm_state = ssm_state * dA + x[:, None, :] * dB

    y = jnp.sum(ssm_state * Cv[:, :, None], axis=1)    # (B, d_inner)
    y = y + lp["d"] * x
    y = y * silu(z)
    out = jnp.matmul(y, lp["out_proj"], preferred_element_type=jnp.float32)
    return out, conv_state, ssm_state


def _token_step(params, cfg, tok_emb_row, state_slices):
    """All layers for one token. Returns (hidden, new per-layer states).

    Unstacked params (list of per-layer dicts) take a python layer loop —
    each layer's buffers are read in place, no scan slice copies."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        hidden = tok_emb_row
        residual = jnp.zeros_like(tok_emb_row)
        conv_new, ssm_new = [], []
        for i, lp in enumerate(layers):
            xb = rmsnorm(hidden + residual, lp["norm"], cfg.norm_eps)
            residual = hidden + residual
            hidden, c, s = _mixer_step(
                cfg, lp, xb, state_slices["conv"][i], state_slices["ssm"][i]
            )
            conv_new.append(c)
            ssm_new.append(s)
        hidden = rmsnorm(hidden + residual, params["norm_f"], cfg.norm_eps)
        return hidden, {"conv": conv_new, "ssm": ssm_new}

    def layer_body(carry, xs):
        hidden, residual = carry
        lp, conv_s, ssm_s = xs
        xb = rmsnorm(hidden + residual, lp["norm"], cfg.norm_eps)
        residual = hidden + residual
        hidden, conv_s, ssm_s = _mixer_step(cfg, lp, xb, conv_s, ssm_s)
        return (hidden, residual), (conv_s, ssm_s)

    residual = jnp.zeros_like(tok_emb_row)
    (hidden, residual), (conv_new, ssm_new) = jax.lax.scan(
        layer_body, (tok_emb_row, residual),
        (params["layers"], state_slices["conv"], state_slices["ssm"]),
    )
    hidden = rmsnorm(hidden + residual, params["norm_f"], cfg.norm_eps)
    return hidden, {"conv": conv_new, "ssm": ssm_new}


def _mixer_scan(cfg: MambaConfig, lp, xb, conv_state, ssm_state, length):
    """Full-sequence mixer, time-parallel. xb: (B, T, E).

    Returns (out (B, T, E), final conv_state, final ssm_state). Positions
    t >= length are frozen out of the recurrence by substituting the
    identity element (dA=1, dBx=0), so the scan's LAST element is the
    state after exactly ``length`` real tokens.
    """
    B, T, _ = xb.shape
    d_inner, d_state, dt_rank = cfg.d_inner, cfg.d_state, cfg.dt_rank_

    x, z = _in_proj(lp, xb)                              # (B, T, d_inner)

    # causal depthwise conv (width d_conv) as a sum of shifted slices;
    # the incoming shift register provides the left context
    # (ssm/mamba.f90:616-621, vectorized over T)
    padded = jnp.concatenate([conv_state[:, 1:].astype(x.dtype), x], axis=1)
    x_conv = sum(
        padded[:, j : j + T] * lp["conv_w"][None, None, j]
        for j in range(cfg.d_conv)
    )
    conv_state = jax.lax.dynamic_slice_in_dim(padded, length - 1, cfg.d_conv, axis=1)
    x = silu(x_conv + lp["conv_b"])

    dt, Bv, Cv = _x_proj(lp, x, dt_rank, d_state)        # Bv/Cv: (B, T, d_state)

    dt = jnp.matmul(dt, lp["dt_proj"], preferred_element_type=jnp.float32)
    dt = jax.nn.softplus(dt + lp["dt_bias"])             # (B, T, d_inner)
    A = -jnp.exp(lp["A_log"])                            # (d_state, d_inner)
    dA = jnp.exp(dt[:, :, None, :] * A[None, None])      # (B, T, d_state, d_inner)
    dBx = dt[:, :, None, :] * Bv[..., None] * x[:, :, None, :]

    valid = (jnp.arange(T, dtype=jnp.int32) < length)[None, :, None, None]
    dA = jnp.where(valid, dA, 1.0)
    dBx = jnp.where(valid, dBx, 0.0)

    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return a2 * a1, a2 * b1 + b2

    pA, pB = jax.lax.associative_scan(combine, (dA, dBx), axis=1)
    states = pA * ssm_state[:, None] + pB                # (B, T, d_state, d_inner)

    y = jnp.einsum("btsd,bts->btd", states, Cv)
    y = y + lp["d"] * x
    y = y * silu(z)
    out = jnp.matmul(y, lp["out_proj"], preferred_element_type=jnp.float32)
    return out, conv_state, states[:, -1]


def _forward_parallel(params, cfg, emb, state, length):
    """Layer loop over the time-parallel mixer. emb: (B, T, E)."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        hidden = emb
        residual = jnp.zeros_like(emb)
        conv_new, ssm_new = [], []
        for i, lp in enumerate(layers):
            xb = rmsnorm(hidden + residual, lp["norm"], cfg.norm_eps)
            residual = hidden + residual
            hidden, c, s = _mixer_scan(
                cfg, lp, xb, state["conv"][i], state["ssm"][i], length
            )
            conv_new.append(c)
            ssm_new.append(s)
        hidden = rmsnorm(hidden + residual, params["norm_f"], cfg.norm_eps)
        return hidden, {"conv": conv_new, "ssm": ssm_new}

    def layer_body(carry, xs):
        hidden, residual = carry
        lp, conv_s, ssm_s = xs
        xb = rmsnorm(hidden + residual, lp["norm"], cfg.norm_eps)
        residual = hidden + residual
        hidden, conv_s, ssm_s = _mixer_scan(cfg, lp, xb, conv_s, ssm_s, length)
        return (hidden, residual), (conv_s, ssm_s)

    residual = jnp.zeros_like(emb)
    (hidden, residual), (conv_new, ssm_new) = jax.lax.scan(
        layer_body, (emb, residual),
        (params["layers"], state["conv"], state["ssm"]),
    )
    hidden = rmsnorm(hidden + residual, params["norm_f"], cfg.norm_eps)
    return hidden, {"conv": conv_new, "ssm": ssm_new}


def forward(
    params: Params,
    cfg: MambaConfig,
    tokens: jax.Array,           # (B, T)
    state: State,
    length: Optional[jax.Array] = None,  # scalar: valid prefix length (masks padding)
    sequential: bool = False,    # force the exact step-recurrence oracle path
) -> Tuple[jax.Array, State]:
    """Returns (hidden (B, T, E), new state). Recurrent, so right-padded
    positions (t >= length) must not advance the state — frozen via the
    identity element in the parallel path / a select in the sequential
    path, unlike the attention path where padding is naturally
    overwritten."""
    B, T = tokens.shape
    emb = jnp.take(params["tok_emb"], tokens, axis=0)  # (B, T, E)

    if T == 1:
        hidden, state = _token_step(params, cfg, emb[:, 0], state)
        return hidden[:, None, :], state

    if not sequential:
        len_ = jnp.int32(T) if length is None else jnp.asarray(length, jnp.int32)
        return _forward_parallel(params, cfg, emb, state, len_)

    def time_body(state, xs):
        x_t, t = xs
        hidden, new_state = _token_step(params, cfg, x_t, state)
        if length is not None:
            keep = t < length
            new_state = jax.tree_util.tree_map(
                lambda new, old: jnp.where(keep, new, old), new_state, state
            )
        return new_state, hidden

    state, hiddens = jax.lax.scan(
        time_body, state,
        (jnp.moveaxis(emb, 1, 0), jnp.arange(T, dtype=jnp.int32)),
    )
    return jnp.moveaxis(hiddens, 0, 1), state


def lm_head(params: Params, cfg: MambaConfig, x: jax.Array) -> jax.Array:
    return jnp.matmul(
        x.astype(jnp.float32), params["wcls"], preferred_element_type=jnp.float32
    )


# -- loading -----------------------------------------------------------------

def load_packed(path: str) -> Tuple[Params, MambaConfig]:
    """Load the reference's packed Mamba checkpoint (format pinned by the
    reader at ssm/mamba.f90:172-325 / writer ssm/savemodel.py:44-102)."""
    from tpu_llm.io.mamba_ckpt import read_packed

    return read_packed(path)
