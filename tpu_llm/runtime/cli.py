"""`llm` CLI — the reference's executable surface (llama2.f90:4-83).

Flags kept byte-compatible with the reference: -m/--model, -p/--prompt,
-s/--tokenizer, -t/--temperature, -n/--num_tokens (total incl. prompt
echo), -v/--verbose, --ak (legacy packed format). Defaults match
(temperature 0, n 256). Output contract: streamed raw token bytes, then an
inference-time / tokens-per-second / per-phase timing report
(llama2.f90:403-410).

Extensions: --dtype f32|bf16|native (native keeps f16/Q4_0
packed), --seed, --scan (all-on-device decode loop), --max-seq.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llm", description=__doc__)
    p.add_argument("-m", "--model", default="stories15M.bin",
                   help="model file (GGUF, or packed 'ak' with --ak)")
    p.add_argument("-p", "--prompt", default="")
    p.add_argument("-s", "--tokenizer", default="",
                   help="external tokenizer.bin (overrides GGUF vocab)")
    p.add_argument("-t", "--temperature", type=float, default=0.0)
    p.add_argument("-n", "--num_tokens", type=int, default=256,
                   help="total tokens incl. prompt echo (reference -n)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--ak", action="store_true", help="legacy llama2.c packed format")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16", "native"])
    p.add_argument("--cache-dtype", default="f32",
                   choices=["f32", "bf16", "int8"],
                   help="KV cache storage; int8 = per-(token, head) scaled "
                        "planes (tpu_llm.ops.kv_cache), half the HBM "
                        "traffic of bf16 at <0.5%% score error")
    p.add_argument("--top-k", type=int, default=0,
                   help="top-k sampling filter (0 = off; framework "
                        "extension, the reference has neither)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling filter (1.0 = off)")
    p.add_argument("--repeat-penalty", type=float, default=1.0,
                   help="HF/llama.cpp-style repetition penalty over the "
                        "text so far (1.0 = off)")
    p.add_argument("--frequency-penalty", type=float, default=0.0,
                   help="OpenAI frequency penalty (per-count logit "
                        "subtraction; 0 = off)")
    p.add_argument("--presence-penalty", type=float, default=0.0,
                   help="OpenAI presence penalty (seen-token logit "
                        "subtraction; 0 = off)")
    p.add_argument("--seed", type=int, default=None,
                   help="PRNG seed (default: time-based, like Fortran random_number)")
    p.add_argument("--scan", action="store_true",
                   help="all-on-device decode loop (no streaming)")
    p.add_argument("--spec", type=int, default=0, metavar="K",
                   help="speculative decoding: verify K drafted tokens "
                        "per forward (greedy only; output is exactly the "
                        "plain greedy stream). Drafts come from prompt "
                        "lookup, or from --draft when given")
    p.add_argument("--draft", default=None, metavar="GGUF",
                   help="small same-vocabulary draft model for two-model "
                        "speculation (needs --spec K)")
    p.add_argument("--min-p", type=float, default=0.0,
                   help="llama.cpp min_p filter (0 = off)")
    p.add_argument("--fold-norms", action="store_true",
                   help="fold rmsnorm weights into the projections "
                        "(quantized weights REQUANTIZE — one extra "
                        "rounding; removes the per-layer norm-weight "
                        "reads)")
    p.add_argument("--lora", default=None, metavar="GGUF",
                   help="LoRA adapter GGUF (llama.cpp convert_lora format) "
                        "merged into the base weights at load")
    p.add_argument("--max-seq", type=int, default=None)
    p.add_argument("--rope", default="interleaved",
                   choices=["interleaved", "neox", "llmf90"],
                   help="rope variant; 'llmf90' reproduces the Fortran bit-for-bit")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: shard projections by "
                        "heads/ffn/vocab over the mesh 'model' axis")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel degree (batch axis of the mesh)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host bring-up: process 0's coordinator "
                        "address (jax.distributed.initialize); or set "
                        "TPU_LLM_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--timings", action="store_true",
                   help="after generation, measure and print the reference's "
                        "five per-token timing buckets (qkv/rope/attention/"
                        "ffn/classifier, llama2.f90:403-410) — each bucket "
                        "timed on device at the run's decode shapes")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="capture an XProf trace of the run into DIR; the "
                        "reference's five timing buckets (qkv/rope/attention/"
                        "ffn/classifier, llama2.f90:538-638) appear as named "
                        "scopes in the trace")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # persistent XLA compile cache: first run pays the jit compile,
    # every later run starts in seconds
    import os

    from tpu_llm.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()

    # multi-host bring-up must precede any device use
    from tpu_llm.parallel.distributed import init_distributed

    proc_id, n_procs = init_distributed(
        args.coordinator, args.num_processes, args.process_id
    )
    if n_procs > 1 and args.verbose:
        print(f"distributed: process {proc_id}/{n_procs}", file=sys.stderr)

    import dataclasses

    import jax.numpy as jnp

    from tpu_llm.runtime.engine import Engine, ModelAdapter
    from tpu_llm.tokenizers.bpe import BPETokenizer

    t_load = time.perf_counter()
    if args.model.endswith(".npz"):
        # fast-reload weight cache (llm-load --cache-out): the finished
        # parameter pytree, no GGUF parsing
        from tpu_llm.io.weight_cache import load_weight_cache

        params, cfg = load_weight_cache(args.model)
        tokenizer = None
    elif args.ak:
        from tpu_llm.io.ak import load_ak

        params, cfg = load_ak(args.model, dtype_policy=args.dtype)
        tokenizer = None
    else:
        from tpu_llm.io.gguf import GGUFFile

        gguf = GGUFFile(args.model)
        arch = gguf.hparam("general.architecture", default="llama")
        if arch == "phi2":
            from tpu_llm.models.phi2 import load_gguf

            params, cfg = load_gguf(gguf, dtype_policy=args.dtype)
        else:
            from tpu_llm.models.llama import load_gguf

            # fused QKV/gate-up halves kernel count (fastest single-chip
            # decode); TP sharding needs the unfused head-aligned layout.
            # LoRA merges against the unfused per-tensor layout first.
            fuse = args.tp == 1
            params, cfg = load_gguf(
                gguf, dtype_policy=args.dtype,
                fuse=fuse and not args.lora,
            )
            if args.lora:
                from tpu_llm.io.lora import apply_lora

                params = apply_lora(params, args.lora, verbose=args.verbose)
                if fuse:
                    from tpu_llm.quant.convert_params import fuse_llama_layers

                    params = dict(
                        params, layers=fuse_llama_layers(params["layers"]))
            if getattr(args, "fold_norms", False):
                from tpu_llm.quant.convert_params import fold_norms_requant

                params = fold_norms_requant(params, cfg)
        tokenizer = (
            BPETokenizer.from_gguf(gguf)
            if "tokenizer.ggml.tokens" in gguf.metadata
            else None
        )
    if args.rope != "interleaved" and args.rope != cfg.rope_variant:
        cfg = dataclasses.replace(cfg, rope_variant=args.rope)

    if args.tokenizer:
        tokenizer = BPETokenizer.from_tokenizer_bin(args.tokenizer)
    if tokenizer is None:
        print("no tokenizer available (use -s tokenizer.bin)", file=sys.stderr)
        return 1

    if args.verbose:
        # the reference's verbose load log (tensor groups + dims,
        # llama2.f90:169-297) as a structured summary
        print(f"config: {cfg}", file=sys.stderr)
        if not args.ak and not args.model.endswith(".npz"):
            from tpu_llm.io.gguf import GGML_TYPE_NAMES

            total = 0
            for name, t in gguf.tensors.items():
                total += t.nbytes
            print(f"tensors: {len(gguf.tensors)}, "
                  f"{total / 1e6:.1f} MB on disk", file=sys.stderr)
            for name in ("token_embd.weight", "blk.0.attn_q.weight",
                         "blk.0.ffn_gate.weight", "output.weight"):
                if name in gguf.tensors:
                    t = gguf.tensors[name]
                    print(f"  {name}: dims={t.dims} "
                          f"{GGML_TYPE_NAMES.get(t.ggml_type, t.ggml_type)}",
                          file=sys.stderr)
        print(f"loaded weights in {time.perf_counter() - t_load:.2f}s", file=sys.stderr)

    max_seq = args.max_seq or min(cfg.seq_len, max(args.num_tokens + 8, 64))
    cache_dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16,
                   "int8": "int8"}[args.cache_dtype]
    single_chip = args.tp * args.dp == 1
    if single_chip:
        from tpu_llm.models.llama import unstack_layers

        params = unstack_layers(params)
    bos_id = (tokenizer.bos_id
              if getattr(tokenizer, "add_bos", True) else -1)
    adapter = ModelAdapter.llama(
        cfg, cache_dtype=cache_dtype, bos_id=bos_id, stacked=not single_chip
    )

    if args.tp * args.dp > 1:
        from tpu_llm.parallel import (
            make_mesh, llama_param_specs, llama_cache_spec, shard_pytree,
        )

        mesh = make_mesh(args.dp, args.tp)
        params = shard_pytree(params, llama_param_specs(cfg, params=params),
                              mesh)
        if args.verbose:
            print(f"mesh: dp={args.dp} tp={args.tp}", file=sys.stderr)

    engine = Engine(params, adapter, max_seq=max_seq)

    draft_engine = None
    if args.draft:
        from tpu_llm.io.gguf import GGUFFile
        from tpu_llm.models.llama import load_gguf as _load_llama
        from tpu_llm.models.llama import unstack_layers as _unstack

        dg = GGUFFile(args.draft)
        dparams, dcfg = _load_llama(dg, dtype_policy=args.dtype, fuse=True)
        if args.rope != "interleaved" and args.rope != dcfg.rope_variant:
            dcfg = dataclasses.replace(dcfg, rope_variant=args.rope)
        dparams = _unstack(dparams)
        draft_engine = Engine(
            dparams,
            ModelAdapter.llama(dcfg, cache_dtype=cache_dtype,
                               bos_id=bos_id, stacked=False),
            max_seq=max_seq)

    prompt_ids = tokenizer.encode(args.prompt) if args.prompt else []
    n = args.num_tokens
    if n > cfg.seq_len:
        print(f" {n} greater than maximum sequence length", file=sys.stderr)
        print(f" set to {cfg.seq_len}", file=sys.stderr)
        n = cfg.seq_len

    out = sys.stdout.buffer

    def stream(tid: int):
        out.write(tokenizer.token_bytes(tid))
        out.flush()

    seed = args.seed if args.seed is not None else int(time.time_ns() % (2**31))

    import contextlib

    import jax

    profile_cm = (
        jax.profiler.trace(args.profile) if args.profile else contextlib.nullcontext()
    )
    with profile_cm:
        res = engine.generate(
            prompt_ids,
            n_total=n,
            temperature=args.temperature,
            seed=seed,
            stream=None if args.scan else stream,
            use_scan=args.scan,
            speculative_k=args.spec,
            draft=draft_engine,
            top_k=args.top_k,
            top_p=args.top_p,
            min_p=args.min_p,
            repetition_penalty=args.repeat_penalty,
            frequency_penalty=args.frequency_penalty,
            presence_penalty=args.presence_penalty,
        )
    if args.scan:
        out.write(tokenizer.decode(res.tokens))
        out.flush()

    # reference output contract (llama2.f90:403-410)
    print()
    print(f" Inference time: {res.total_s:10.4f} seconds")
    print(f" {res.tokens_per_s:10.4f} tokens/second (decode)")
    print(f" TTFT: {res.ttft_s * 1000:10.2f} ms")
    if args.timings:
        from tpu_llm.runtime.phase_timing import format_report, measure_phase_times

        res.phase_times = measure_phase_times(
            params, cfg, batch=1, pos=len(res.tokens), max_seq=max_seq
        )
        print(format_report(res.phase_times))
    if args.profile:
        print(f" Timings: XProf trace written to {args.profile}")
        print("  buckets qkv/rope/attention/ffn/classifier are named scopes")
    elif not args.timings:
        print(" Timings: pass --timings for the per-bucket report, or "
              "--profile DIR for an XProf trace")
    return 0


if __name__ == "__main__":
    sys.exit(main())
