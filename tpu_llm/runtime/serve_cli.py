"""`llm-serve` — offline batched serving over the continuous-batching
engines.

The reference is one prompt per process (llama2.f90:379-402). This front
end takes MANY prompts (a file with one per line, or repeated -p) and
drives them through iteration-level scheduling: requests are admitted
into slots as others finish, prompts prefill in one forward, and decode
runs one batched step for every live slot. Engine selection:

  --paged        paged-KV pool + block tables + automatic prefix caching
                 (repeated prompt prefixes cost zero prefill compute)
  --cache-dtype int8   halve KV HBM (dense planes or paged pools)
  --spec K       batched prompt-lookup speculative decoding (greedy):
                 up to K drafted tokens verified per slot per forward

Prints each completed request as JSON and an aggregate throughput line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llm-serve", description=__doc__)
    p.add_argument("-m", "--model", required=True,
                   help="GGUF or .npz weight-cache path")
    p.add_argument("-p", "--prompt", action="append", default=[],
                   help="prompt text (repeatable)")
    p.add_argument("-f", "--prompts-file",
                   help="file with one prompt per line")
    p.add_argument("-n", "--num-tokens", type=int, default=64,
                   help="max new tokens per request")
    p.add_argument("-t", "--temperature", type=float, default=0.0)
    p.add_argument("-s", "--tokenizer", help="external tokenizer.bin")
    p.add_argument("--dtype", default="native",
                   choices=["f32", "bf16", "native"])
    p.add_argument("--cache-dtype", default="bf16",
                   choices=["f32", "bf16", "int8"])
    p.add_argument("--batch", type=int, default=8, help="engine slots")
    p.add_argument("--max-seq", type=int, default=None)
    p.add_argument("--paged", action="store_true",
                   help="paged KV pool + prefix caching (llama only)")
    p.add_argument("--block-size", type=int, default=None,
                   help="paged block size (default 16; 32 for int8 pools)")
    p.add_argument("--n-blocks", type=int, default=None,
                   help="paged pool size (default: batch x max_seq worth)")
    p.add_argument("--draft", default=None, metavar="GGUF",
                   help="small same-vocabulary draft model for two-model "
                        "speculation (needs --spec K; llama family)")
    p.add_argument("--lora", default=None, metavar="GGUF",
                   help="LoRA adapter GGUF merged into the base weights "
                        "at load (llama.cpp convert_lora format)")
    p.add_argument("--spec", type=int, default=0, metavar="K",
                   help="speculative drafts per step (greedy slots)")
    p.add_argument("--tp", type=int, default=1, metavar="N",
                   help="tensor-parallel degree: shard the serving step "
                        "over an N-device model axis (GSPMD)")
    p.add_argument("--dp", type=int, default=1, metavar="N",
                   help="data-parallel degree: shard engine batch rows "
                        "over an N-device data axis (batch %% dp == 0)")
    p.add_argument("--stop-at-eos", action="store_true")
    p.add_argument("--top-k", type=int, default=0,
                   help="per-request top-k filter (0 = off)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="per-request nucleus filter (1.0 = off)")
    p.add_argument("--min-p", type=float, default=0.0,
                   help="llama.cpp min_p: drop tokens with prob < min_p * "
                        "max_prob (0 = off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _load(args):
    import dataclasses  # noqa: F401

    from tpu_llm.tokenizers.bpe import BPETokenizer

    if args.model.endswith(".bin"):
        # Mamba packed checkpoint (ssm/mamba.f90 format): recurrent
        # state, dense engine only (no KV to page, no draft rollback)
        from tpu_llm.io.mamba_ckpt import read_packed

        params, cfg = read_packed(args.model)
        tokenizer = None
    elif args.model.endswith(".npz"):
        from tpu_llm.io.weight_cache import load_weight_cache

        params, cfg = load_weight_cache(args.model)
        tokenizer = None
    else:
        from tpu_llm.io.gguf import GGUFFile

        gguf = GGUFFile(args.model)
        arch = gguf.hparam("general.architecture", default="llama")
        if arch == "phi2":
            from tpu_llm.models.phi2 import load_gguf
        else:
            from tpu_llm.models.llama import load_gguf
        params, cfg = load_gguf(gguf, dtype_policy=args.dtype)
        if getattr(args, "lora", None):
            if arch == "phi2":
                raise SystemExit("--lora supports the llama family")
            from tpu_llm.io.lora import apply_lora

            params = apply_lora(params, args.lora,
                                verbose=getattr(args, "verbose", False))
        tokenizer = (BPETokenizer.from_gguf(gguf)
                     if "tokenizer.ggml.tokens" in gguf.metadata else None)
    if args.tokenizer:
        tokenizer = BPETokenizer.from_tokenizer_bin(args.tokenizer)
    if tokenizer is None:
        raise SystemExit("no tokenizer available (use -s tokenizer.bin)")
    return params, cfg, tokenizer


def make_engine(args, params, cfg, tokenizer, max_seq, is_mamba=False):
    """Build the dense or paged engine from parsed serving flags — shared
    by the offline front end (below) and the HTTP server
    (tpu_llm.runtime.server)."""
    import jax.numpy as jnp

    from tpu_llm.runtime.batching import BatchEngine
    from tpu_llm.runtime.engine import ModelAdapter

    cache_dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16,
                   "int8": "int8"}[args.cache_dtype]
    # model-declared special tokens (GGUF tokenizer.ggml.*) — hardcoded
    # llama2 ids would make --stop-at-eos inert for other vocabs
    bos_id = (getattr(tokenizer, "bos_id", 1)
              if getattr(tokenizer, "add_bos", True) else -1)
    eos_id = getattr(tokenizer, "eos_id", 2)
    tp = getattr(args, "tp", 1)
    dp = getattr(args, "dp", 1)
    use_mesh = tp * dp > 1
    draft = None
    dcfg = None
    if getattr(args, "draft", None):
        if is_mamba:
            raise SystemExit("--draft requires a llama-family target")
        from tpu_llm.models.llama import load_gguf as _ld
        from tpu_llm.models.llama import unstack_layers as _us

        if use_mesh:
            # mesh serving: unfused + stacked so the draft shares the TP
            # param specs and the shard_map adapter (serving.shard_engine)
            dparams, dcfg = _ld(args.draft, dtype_policy=args.dtype,
                                fuse=False)
            draft = (dparams,
                     ModelAdapter.llama(dcfg, cache_dtype=jnp.bfloat16,
                                        bos_id=bos_id))
        else:
            dparams, dcfg = _ld(args.draft, dtype_policy=args.dtype,
                                fuse=True)
            draft = (_us(dparams),
                     ModelAdapter.llama(dcfg, cache_dtype=jnp.bfloat16,
                                        bos_id=bos_id, stacked=False))
    mesh = None
    if use_mesh:
        if is_mamba:
            raise SystemExit("--tp/--dp require a llama-family target")
        if args.batch % dp:
            raise SystemExit(f"--batch {args.batch} must divide by --dp {dp}")
        if dcfg is not None and tp > 1 and dcfg.n_kv_heads % tp:
            raise SystemExit(
                f"--tp {tp} must divide the draft model's n_kv_heads="
                f"{dcfg.n_kv_heads}")
        from tpu_llm.parallel import make_mesh

        mesh = make_mesh(data=dp, model=tp)
    if args.paged:
        if is_mamba:
            raise SystemExit(
                "--paged requires a KV-cache model (llama family)")
        from tpu_llm.runtime.paged_engine import PagedEngine

        bs = args.block_size or (32 if args.cache_dtype == "int8" else 16)
        n_blocks = args.n_blocks or (
            1 + args.batch * ((max_seq + bs - 1) // bs))
        eng = PagedEngine(
            params, cfg, batch=args.batch, n_blocks=n_blocks,
            block_size=bs, max_seq=max_seq, cache_dtype=cache_dtype,
            speculative_k=args.spec, bos_id=bos_id, eos_id=eos_id,
            draft=draft,
        )
    else:
        adapter = (ModelAdapter.mamba(cfg) if is_mamba else
                   ModelAdapter.llama(cfg, cache_dtype=cache_dtype,
                                      bos_id=bos_id))
        eng = BatchEngine(params, adapter, batch=args.batch,
                          max_seq=max_seq, speculative_k=args.spec,
                          eos_id=eos_id, draft=draft)
    if mesh is not None:
        from tpu_llm.parallel.serving import shard_engine

        eng = shard_engine(eng, cfg, mesh, draft_cfg=dcfg)
    return eng


def main(argv=None) -> int:
    import os

    from tpu_llm.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)

    prompts = list(args.prompt)
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts += [ln.rstrip("\n") for ln in f if ln.strip()]
    if not prompts:
        print("no prompts (-p or -f)", file=sys.stderr)
        return 1

    from tpu_llm.runtime.batching import Request

    params, cfg, tokenizer = _load(args)
    prompt_ids = [tokenizer.encode(t) for t in prompts]
    ctx_cap = getattr(cfg, "seq_len", 4096)   # Mamba: O(1) state, no cap
    # default context: the LONGEST submitted prompt (+BOS) + budget, not a
    # guess — a fixed default would reject valid long prompts at submit
    need = max(len(ids) for ids in prompt_ids) + 1 + args.num_tokens
    max_seq = args.max_seq or min(ctx_cap, max(need, 256))
    if args.paged and max_seq > 256 and max_seq % 256:
        # round the paged context to a 256-multiple so long-prompt
        # prefill stays eligible for the flash kernel (S % 256 gate)
        max_seq = min(-(-max_seq // 256) * 256, ctx_cap)
    is_mamba = args.model.endswith(".bin")
    try:
        engine = make_engine(args, params, cfg, tokenizer, max_seq,
                             is_mamba=is_mamba)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    first_tok_s = {}

    def _mark_first(rid):
        def cb(_tok):
            if rid not in first_tok_s:
                first_tok_s[rid] = time.perf_counter() - t0
        return cb

    reqs = []
    for i, (text, ids) in enumerate(zip(prompts, prompt_ids)):
        reqs.append(engine.submit(Request(
            prompt=ids, max_new=args.num_tokens,
            temperature=args.temperature, seed=args.seed + i,
            stop_at_eos=args.stop_at_eos, stream=_mark_first(i),
            top_k=getattr(args, "top_k", 0),
            top_p=getattr(args, "top_p", 1.0),
            min_p=getattr(args, "min_p", 0.0),
        )))

    steps = 0
    while engine._queue or engine.n_active:
        engine.step()
        steps += 1
    engine._collect()
    wall = time.perf_counter() - t0

    n_generated = 0
    for i, (req, text) in enumerate(zip(reqs, prompts)):
        n_generated += len(req.tokens)
        out = tokenizer.decode(req.tokens)
        if isinstance(out, bytes):  # byte-exact decode -> lossy str for JSON
            out = out.decode("utf-8", errors="replace")
        print(json.dumps({
            "prompt": text,
            "completion": out,
            "n_tokens": len(req.tokens),
            "ttft_s": round(first_tok_s.get(i, wall), 4),
        }), flush=True)
    ttfts = sorted(first_tok_s.values()) or [wall]
    summary = {
        "requests": len(reqs),
        "generated_tokens": n_generated,
        "wall_s": round(wall, 3),
        "tokens_per_s": round(n_generated / max(wall, 1e-9), 2),
        "ttft_p50_s": round(ttfts[len(ttfts) // 2], 4),
        "engine_steps": steps,
        "engine": "paged" if args.paged else "dense",
        "speculative_k": args.spec,
    }
    if args.spec and engine.stats["spec_forwards"]:
        summary["spec_tokens_per_forward"] = round(
            engine.stats["spec_tokens"] / engine.stats["spec_forwards"], 2)
    if args.paged and engine.prefix is not None and engine.prefix.queries:
        summary["prefix_cache_hit_rate"] = round(
            engine.prefix.hits / engine.prefix.queries, 3)
        summary["hbm_blocks_in_use"] = engine.hbm_blocks_in_use
    print(json.dumps(summary), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
