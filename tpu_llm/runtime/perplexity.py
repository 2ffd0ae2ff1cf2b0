"""Perplexity evaluation harness.

The reference has no ppl tool (validation was eyeballing generations,
SURVEY.md §4); BASELINE.json makes "ppl Δ vs reference at each bit width"
a first-class metric, so this provides it: teacher-forced NLL of a token
stream under any ModelAdapter, windowed to the model's max context.

ppl = exp(mean over positions of -log p(token_{t+1} | tokens_<=t)).
The first token of each window is never scored (no context).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tpu_llm.runtime.engine import ModelAdapter


@dataclasses.dataclass
class PplResult:
    ppl: float
    nll_sum: float
    n_tokens: int

    @property
    def mean_nll(self) -> float:
        return self.nll_sum / max(self.n_tokens, 1)


def compute_ppl(
    params: Any,
    adapter: ModelAdapter,
    ids: Sequence[int],
    window: int = 512,
    add_bos: bool = True,
) -> PplResult:
    """Windowed (non-overlapping) teacher-forced perplexity."""
    ids = list(ids)
    if add_bos and adapter.bos_id >= 0:
        ids = [adapter.bos_id] + ids
    if len(ids) < 2:
        raise ValueError("need at least 2 tokens to score")

    @jax.jit
    def window_nll(params, tokens, state, n_valid):
        # tokens (1, W); score predictions for positions 1..n_valid-1
        hidden, state = adapter.apply(
            params, tokens=tokens, state=state, offset=np.int32(0),
            length=n_valid,
        )
        logits = adapter.lm_head(params, hidden=hidden)  # (1, W, V)
        logp = jax.nn.log_softmax(logits[:, :-1, :], axis=-1)
        targets = tokens[:, 1:]
        tok_logp = jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
        idx = jnp.arange(tokens.shape[1] - 1)
        mask = idx < (n_valid - 1)
        return -jnp.sum(jnp.where(mask, tok_logp[0], 0.0)), jnp.sum(mask)

    nll_sum, count = 0.0, 0
    pos = 0
    while pos + 1 < len(ids):
        chunk = ids[pos : pos + window]
        n_valid = len(chunk)
        padded = chunk + [0] * (window - n_valid)
        state = adapter.init_state(1, window)
        nll, n = window_nll(
            params, jnp.asarray([padded], jnp.int32), state, jnp.int32(n_valid)
        )
        nll_sum += float(nll)
        count += int(n)
        pos += n_valid  # non-overlapping windows; last token of a window
        # re-scored as first (unscored) token of the next — windows restart
        # context, matching llama.cpp-style chunked ppl
        if n_valid < window:
            break

    return PplResult(ppl=math.exp(nll_sum / count), nll_sum=nll_sum, n_tokens=count)


_TABLE_FORMATS = ("f32", "f16", "bf16", "q8_0", "q4_1", "q4_0")


def eval_stream(n: int = 1024, vocab: int = 1024, seed: int = 11) -> List[int]:
    """Deterministic token stream with bigram structure for ppl evals when
    no text corpus is available (pure noise would make every model score
    near-uniform and hide quantization error)."""
    rng = np.random.default_rng(seed)
    ids = [int(rng.integers(3, vocab))]
    for _ in range(n - 1):
        if rng.random() < 0.5:           # half the stream is bigram-determined
            ids.append(3 + (ids[-1] * 7 + 1) % (vocab - 3))
        else:
            ids.append(int(rng.integers(3, vocab)))
    return ids


def model_sampled_stream(
    params, cfg, n: int = 512, seed: int = 0, temperature: float = 1.0,
) -> List[int]:
    """Sample a token stream FROM the model (temp 1.0). Scoring this
    stream under each quantized variant of the same model turns Δppl into
    a real divergence measure: the f32 model is optimal on its own
    distribution (ppl ≈ exp entropy), any quantization error shows up as
    Δppl >= 0 in expectation — meaningful even with synthetic weights,
    where ppl of an arbitrary stream is astronomically off-distribution."""
    from tpu_llm.runtime.engine import Engine

    adapter = ModelAdapter.llama(cfg)
    eng = Engine(params, adapter, max_seq=min(cfg.seq_len, n + 8))
    res = eng.generate([3], n_new=n, temperature=temperature, seed=seed)
    return res.tokens


def dtype_table(
    base_path: str,
    ids: Optional[Sequence[int]] = None,
    window: int = 256,
    formats: Sequence[str] = _TABLE_FORMATS,
) -> List[dict]:
    """Cross-dtype validation table (BASELINE "ppl Δ vs reference at each
    bit width"): round-trip a base f32 GGUF through the WRITER at each
    storage format, reload each with the native device path, and score
    (a) windowed ppl over ``ids`` and (b) logit deviation vs the f32 model
    on the first window. The quantization is the real on-disk block
    format, the load is the real serving path — an independent check of
    writer + loader + kernels together."""
    import os
    import tempfile

    from tpu_llm.io import gguf as gg
    from tpu_llm.io.gguf import GGUFFile, write_gguf
    from tpu_llm.models.llama import load_gguf

    base = GGUFFile(base_path)
    fmt_ids = {"f32": gg.GGML_F32, "f16": gg.GGML_F16, "bf16": gg.GGML_BF16,
               "q8_0": gg.GGML_Q8_0, "q5_0": gg.GGML_Q5_0,
               "q5_1": gg.GGML_Q5_1, "q4_0": gg.GGML_Q4_0,
               "q4_1": gg.GGML_Q4_1,
               "q2_k": gg.GGML_Q2_K, "q3_k": gg.GGML_Q3_K,
               "q4_k": gg.GGML_Q4_K, "q5_k": gg.GGML_Q5_K,
               "q6_k": gg.GGML_Q6_K}

    def variant(fmt: str, out_path: str):
        ttype = fmt_ids[fmt]
        tensors = {}
        for name, t in base.tensors.items():
            arr = base.dequantized(name, np.float32)
            # norms stay f32 (llama.cpp convention; the reference keeps
            # them f32 on every branch); rows that don't fill a whole
            # block (K-quant superblocks are 256 wide) also stay f32,
            # matching llama.cpp's per-tensor fallback behavior
            block = gg._TYPE_TRAITS[ttype][0]
            quantize = (arr.ndim == 2 and "norm" not in name
                        and arr.shape[-1] % block == 0)
            tensors[name] = (arr, ttype) if quantize else arr
        write_gguf(out_path, dict(base.metadata), tensors)

    if ids is None:
        params_f32, cfg_f32 = load_gguf(base_path, dtype_policy="f32")
        ids = model_sampled_stream(params_f32, cfg_f32,
                                   n=min(512, cfg_f32.seq_len - 8))
        del params_f32

    assert formats[0] == "f32", (
        "dtype_table computes every delta against the FIRST row; pass "
        "formats starting with 'f32' (got %r)" % (formats[0],))
    rows: List[dict] = []
    ref_logits = None
    with tempfile.TemporaryDirectory() as td:
        for fmt in formats:
            path = base_path
            if fmt != "f32" or base.tensors["output.weight"].ggml_type != gg.GGML_F32:
                path = os.path.join(td, f"{fmt}.gguf")
                variant(fmt, path)
            params, cfg = load_gguf(path, dtype_policy="native"
                                    if fmt != "f32" else "f32")
            adapter = ModelAdapter.llama(cfg)
            res = compute_ppl(params, adapter, ids,
                              window=min(window, cfg.seq_len))

            # logit deviation on the first window
            w = min(window, cfg.seq_len, len(ids))
            toks = jnp.asarray([list(ids[:w])], jnp.int32)
            state = adapter.init_state(1, w)
            hidden, _ = adapter.apply(params, tokens=toks, state=state,
                                      offset=np.int32(0), length=jnp.int32(w))
            logits = np.asarray(adapter.lm_head(params, hidden=hidden))
            if ref_logits is None:
                ref_logits = logits
                dmax = dmean = 0.0
            else:
                d = np.abs(logits - ref_logits)
                dmax, dmean = float(d.max()), float(d.mean())
            rows.append({
                "format": fmt, "ppl": res.ppl, "n_tokens": res.n_tokens,
                "ppl_delta_vs_f32": res.ppl - rows[0]["ppl"] if rows else 0.0,
                "logit_max_abs_delta": dmax, "logit_mean_abs_delta": dmean,
            })
    return rows


def format_table(rows: List[dict]) -> str:
    out = ["| format | ppl | Δppl vs f32 | max|Δlogit| | mean|Δlogit| |",
           "|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['format']} | {r['ppl']:.4f} | {r['ppl_delta_vs_f32']:+.4f} "
            f"| {r['logit_max_abs_delta']:.4g} | {r['logit_mean_abs_delta']:.4g} |"
        )
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="llm-ppl", description="perplexity of a text file under a GGUF model"
    )
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-f", "--file", default=None, help="UTF-8 text file")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16", "native"])
    p.add_argument("--window", type=int, default=512)
    p.add_argument("--max-tokens", type=int, default=0, help="truncate input")
    p.add_argument("--table", action="store_true",
                   help="cross-dtype ppl/logit-delta table: round-trip the "
                        "model through the GGUF writer at f32/f16/bf16/"
                        "q8_0/q4_0 and score each (uses -f text, or a "
                        "deterministic synthetic stream)")
    args = p.parse_args(argv)

    if args.table:
        if args.file:
            from tpu_llm.io.gguf import GGUFFile
            from tpu_llm.tokenizers.bpe import BPETokenizer

            tok = BPETokenizer.from_gguf(GGUFFile(args.model))
            with open(args.file, "rb") as fh:
                ids = tok.encode(fh.read().decode("utf-8", errors="replace"))
        else:
            ids = None   # dtype_table self-samples from the f32 model
        if ids is not None and args.max_tokens:
            ids = ids[: args.max_tokens]
        rows = dtype_table(args.model, ids, window=args.window)
        print(format_table(rows))
        return 0

    if not args.file:
        p.error("-f/--file is required unless --table")

    from tpu_llm.io.gguf import GGUFFile
    from tpu_llm.tokenizers.bpe import BPETokenizer

    gguf = GGUFFile(args.model)
    arch = gguf.hparam("general.architecture", default="llama")
    if arch == "phi2":
        from tpu_llm.models.phi2 import load_gguf
    else:
        from tpu_llm.models.llama import load_gguf
    params, cfg = load_gguf(gguf, dtype_policy=args.dtype)
    tokenizer = BPETokenizer.from_gguf(gguf)

    with open(args.file, "rb") as fh:
        text = fh.read().decode("utf-8", errors="replace")
    ids = tokenizer.encode(text)
    if args.max_tokens:
        ids = ids[: args.max_tokens]

    adapter = ModelAdapter.llama(cfg, bos_id=tokenizer.bos_id)
    res = compute_ppl(params, adapter, ids, window=min(args.window, cfg.seq_len))
    print(f"ppl = {res.ppl:.4f} over {res.n_tokens} tokens "
          f"(mean nll {res.mean_nll:.4f})")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
