"""`llm-ssm` — the reference's ssm/llm executable (ssm/mamba.f90:90-443).

Decodes a Mamba model from a packed checkpoint with a tokenizer.bin
(GPT-NeoX vocab with converted merge-rank scores). Flag surface matches
the reference (-m -p -s -t -n -v; --ak accepted and implied since only the
packed format exists, ssm/mamba.f90:159-162). Also hosts the HF->packed
converter (--convert), the reference's ssm/savemodel.py.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    import os

    from tpu_llm.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="llm-ssm", description=__doc__)
    p.add_argument("-m", "--model", default="model.bin")
    p.add_argument("-p", "--prompt", default="")
    p.add_argument("-s", "--tokenizer", default="tokenizer.bin")
    p.add_argument("-t", "--temperature", type=float, default=0.0)
    p.add_argument("-n", "--num_tokens", type=int, default=100)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--ak", action="store_true",
                   help="packed format (always on; kept for flag parity)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                   help="f32 = reference-parity numerics (default); bf16 = "
                        "weight-only cast (half the weight bytes)")
    p.add_argument("--scan", action="store_true")
    p.add_argument("--convert", metavar="HF_DIR",
                   help="convert a HF Mamba dir to packed format at -m, then exit")
    p.add_argument("--convert-tokenizer", metavar="TOKENIZER_JSON",
                   help="convert a HF tokenizer.json (GPT-NeoX byte-level BPE) "
                        "to tokenizer.bin at -s, then exit — the reference's "
                        "ssm/convert_tokens.py (merge-rank scores, G-dot/C-dot "
                        "space/newline rewrite)")
    args = p.parse_args(argv)

    if args.convert:
        from tpu_llm.io.mamba_ckpt import convert_hf_mamba

        convert_hf_mamba(args.convert, args.model, verbose=True)
        return 0

    if args.convert_tokenizer:
        from tpu_llm.tokenizers.bpe import BPETokenizer
        from tpu_llm.tokenizers.tokenizer_bin import write_tokenizer_bin

        tok = BPETokenizer.from_hf_tokenizer_json(args.convert_tokenizer)
        write_tokenizer_bin(args.tokenizer, tok.tokens, tok.scores)
        print(f"wrote {args.tokenizer} ({tok.vocab_size} tokens)")
        return 0

    from tpu_llm.models.mamba import load_packed
    from tpu_llm.runtime.engine import Engine, ModelAdapter
    from tpu_llm.tokenizers.bpe import BPETokenizer

    t0 = time.perf_counter()
    params, cfg = load_packed(args.model)
    tokenizer = BPETokenizer.from_tokenizer_bin(args.tokenizer)
    if args.verbose:
        print(f"config: {cfg}", file=sys.stderr)
        print(f"loaded in {time.perf_counter() - t0:.2f}s", file=sys.stderr)

    from tpu_llm.models.mamba import cast_weights, unstack_layers

    if args.dtype == "bf16":
        params = cast_weights(params)
    params = unstack_layers(params)   # per-layer buffers: no scan slice copies
    adapter = ModelAdapter.mamba(cfg, stacked=False)
    engine = Engine(params, adapter, max_seq=max(args.num_tokens + 8, 64))

    prompt_ids = tokenizer.encode(args.prompt) if args.prompt else []
    if not prompt_ids:
        print("empty prompt (Mamba needs a first token; no BOS convention, "
              "ssm/mamba.f90:406)", file=sys.stderr)
        return 1

    out = sys.stdout.buffer

    def stream(tid: int):
        if tid < tokenizer.vocab_size:
            out.write(tokenizer.token_bytes(tid))
            out.flush()

    seed = args.seed if args.seed is not None else int(time.time_ns() % (2**31))
    res = engine.generate(
        prompt_ids,
        n_total=args.num_tokens,
        temperature=args.temperature,
        seed=seed,
        stream=None if args.scan else stream,
        add_bos=False,
        use_scan=args.scan,
    )
    if args.scan:
        out.write(tokenizer.decode([t for t in res.tokens if t < tokenizer.vocab_size]))
        out.flush()

    print()
    print(f" Inference time: {res.total_s:10.4f} seconds")
    print(f" {res.tokens_per_s:10.4f} tokens/second (decode)")
    print(f" TTFT: {res.ttft_s * 1000:10.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
