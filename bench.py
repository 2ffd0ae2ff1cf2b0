"""Decode-throughput benchmark: prints ONE JSON line.

TinyLlama-1.1B greedy decode tokens/s on one GPU, measured with the
all-on-device scan loop (no host round trips). Weights are random,
made on the device from a seed: packed Q4_0/Q8_0 QTensors, or dense bf16
(throughput is weight-content independent). The scan runs once to
compile and warm up, then once more under the clock, ending in
``block_until_ready``.

The line names the device it ran on; a run that finds no GPU exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp


def build_params(quant: str, cfg, seed: int = 0):
    """Fused, unstacked random weights at ``cfg``'s widths. Random
    weights need no RoPE column permutation, so the config runs the
    relayout-free neox rotation that ``fold_rope_interleave`` produces
    for real checkpoints."""
    import dataclasses

    from tpu_llm.models.llama import unstack_layers
    from tpu_llm.quant.convert_params import fuse_llama_layers
    from tpu_llm.runtime.bench_cli import random_llama_params, synth_quant_llama

    cfg = dataclasses.replace(cfg, rope_variant="neox")
    if quant in ("q4_0", "q8_0"):
        return synth_quant_llama(cfg, kind=quant, seed=seed), cfg
    params = random_llama_params(cfg, seed=seed)
    params = dict(params, layers=fuse_llama_layers(params["layers"]))
    return unstack_layers(params), cfg


def measure(params, cfg, steps: int, batch: int, max_seq: int,
            prompt_len: int, cache_dtype=jnp.bfloat16) -> float:
    """Decode tokens/s of a ``steps``-token scan from ``prompt_len``."""
    from tpu_llm.models import llama as M

    cache = M.init_cache(cfg, batch, max_seq, dtype=cache_dtype,
                         stacked=False)
    token = jnp.ones((batch,), jnp.int32)
    steps = min(steps, max_seq - prompt_len - 1)

    @jax.jit
    def decode_n(params, token, cache, pos0):
        def body(carry, _):
            token, cache, pos = carry
            logits, cache = M.decode_step(params, cfg, token, cache, pos)
            token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            return (token, cache, pos + 1), token

        (_, cache, _), toks = jax.lax.scan(
            body, (token, cache, pos0), None, length=steps)
        return toks, cache

    pos0 = jnp.int32(prompt_len)
    jax.block_until_ready(decode_n(params, token, cache, pos0))
    t0 = time.perf_counter()
    jax.block_until_ready(decode_n(params, token, cache, pos0))
    return batch * steps / (time.perf_counter() - t0)


def main() -> int:
    from tpu_llm.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--quant", default="q4_0", choices=["none", "q4_0", "q8_0"])
    ap.add_argument("--cache-dtype", default="bf16",
                    choices=["f32", "bf16", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench.py measures a GPU; found {devices[0].platform}",
              file=sys.stderr)
        return 1

    from tpu_llm.config import tinyllama_1_1b

    params, cfg = build_params(args.quant, tinyllama_1_1b(), args.seed)
    cache_dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16,
                   "int8": "int8"}[args.cache_dtype]
    tok_s = measure(params, cfg, args.steps, args.batch, args.max_seq,
                    args.prompt_len, cache_dtype=cache_dtype)

    name = "bf16" if args.quant == "none" else args.quant
    print(json.dumps({
        "metric": f"tinyllama_1.1b_{name}_decode_tokens_per_s",
        "value": tok_s,
        "unit": "tok/s",
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
