"""Generation engine: batched prefill + jitted decode loop.

Replaces the reference's driver loop (``llama2.f90:379-402``), which
teacher-forces the prompt one token at a time through the full forward
pass, with a two-program split:

- PREFILL: the whole prompt in one jitted forward (large matmuls,
  causal-masked attention), padded to a shape bucket to bound recompiles.
  Padding is safe with pure causal masking: a padded cache slot s is only
  visible to queries at pos >= s, and the decode step that first reaches
  position s overwrites the slot before attending to it.
- DECODE: one jitted step per token — forward, lm_head on the single
  position, and sampling fused into the same program (the sampled token id
  is the only thing that leaves the device). An all-on-device ``lax.scan``
  variant (`generate_scan`) removes even the per-token host round-trip for
  benchmarking/batch use.

Sampling semantics match the reference (llama2.f90:386-393): temperature 0
-> argmax; else softmax(logits/T) + inverse-CDF draw, but driven by an
explicit JAX PRNG key so runs are reproducible at any world size.

The engine is model-agnostic: it drives any ``ModelAdapter`` (llama here,
Mamba in tpu_llm/models/mamba.py) whose state is an arbitrary pytree.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_llm.ops.sampling import greedy, _cdf_sample


@dataclasses.dataclass
class ModelAdapter:
    """Uniform model interface for the engine.

    apply(params, tokens (B, T), state, offset) -> (hidden (B, T, E), state)
    lm_head(params, hidden (B, T, E)) -> logits (B, T, V) float32
    init_state(batch, max_seq) -> state pytree
    """

    apply: Callable
    lm_head: Callable
    init_state: Callable
    bos_id: int = 1
    # batch axis of every state leaf: 1 for stacked layouts ((L, B, ...)
    # planes), 0 for unstacked per-layer buffer lists ((B, ...) leaves)
    state_batch_axis: int = 1
    # True when state rows are keyed by POSITION (KV cache): stale rows
    # past the current position are causally invisible, so speculative
    # verify can over-write ahead and partially accept. False for
    # recurrent state (Mamba) — a rejected draft would need rollback.
    positional_state: bool = True
    # vocab size (token-count buffers for repetition/frequency penalties)
    vocab_size: int = 0

    @classmethod
    def llama(cls, cfg, cache_dtype=jnp.float32, bos_id: int = 1,
              stacked: bool = True) -> "ModelAdapter":
        """``stacked=False`` pairs with ``llama.unstack_layers`` params —
        the no-copy python layer loop (fastest single-chip decode)."""
        from tpu_llm.models import llama as M

        return cls(
            apply=lambda params, tokens, state, offset, length=None: M.forward(
                params, cfg, tokens, state, offset
            ),
            lm_head=lambda params, hidden: M.lm_head(params, cfg, hidden),
            init_state=lambda batch, max_seq: M.init_cache(
                cfg, batch, max_seq, cache_dtype, stacked=stacked
            ),
            bos_id=bos_id,
            state_batch_axis=1 if stacked else 0,
            vocab_size=cfg.vocab_size,
        )

    @classmethod
    def mamba(cls, cfg, bos_id: Optional[int] = None,
              stacked: bool = True) -> "ModelAdapter":
        """``stacked=False`` pairs with ``mamba.unstack_layers`` params
        (per-layer buffers, no scan slice copies)."""
        from tpu_llm.models import mamba as M

        return cls(
            apply=lambda params, tokens, state, offset, length=None: M.forward(
                params, cfg, tokens, state, length=length
            ),
            lm_head=lambda params, hidden: M.lm_head(params, cfg, hidden),
            init_state=lambda batch, max_seq: M.init_state(
                cfg, batch, stacked=stacked
            ),
            bos_id=bos_id if bos_id is not None else -1,  # Mamba: no BOS (mamba.f90:406)
            state_batch_axis=1 if stacked else 0,
            positional_state=False,
            vocab_size=cfg.vocab_size,
        )


def _next_bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _lookup_draft(ctx: List[int], k: int, ngram: int = 2) -> List[int]:
    """Prompt-lookup drafting (self-speculation without a draft model):
    find the most recent PRIOR occurrence of the context's trailing
    ``ngram`` and propose the k tokens that followed it. Natural text
    repeats n-grams constantly (names, phrases, code identifiers), so
    accepted spans are common; a miss costs nothing — the verify forward
    still emits one correct token."""
    if k <= 0 or len(ctx) < ngram + 1:
        return []
    tail = ctx[-ngram:]
    for j in range(len(ctx) - ngram - 1, -1, -1):
        if ctx[j : j + ngram] == tail:
            return ctx[j + ngram : j + ngram + k]
    return []


def _select_token(logits, key, temperature, topk=None, topp=None,
                  minp=None):
    """Greedy vs CDF-sample, branch-free over a traced temperature.
    ``topk``/``topp``/``minp`` (traced scalars, or None for the cheap
    path — a separate jit cache entry) add per-request filtering."""
    if topk is not None:
        from tpu_llm.ops.sampling import filtered_sample

        keys = jax.random.split(key, logits.shape[0])
        return jax.vmap(filtered_sample,
                        in_axes=(0, 0, None, None, None, None))(
            logits, keys, temperature, topk, topp, minp)
    t = jnp.maximum(temperature, 1e-8)
    probs = jax.nn.softmax(logits.astype(jnp.float32) / t, axis=-1)
    sampled = _cdf_sample(key, probs)
    return jnp.where(temperature > 0, sampled, greedy(logits))


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]              # all emitted tokens (prompt echo + generated)
    n_prompt: int
    ttft_s: float                  # time to first sampled token (prefill + 1 step)
    decode_s: float                # wall time of the pure decode phase
    total_s: float
    tokens_per_s: float            # decode-phase throughput
    phase_times: Optional[dict] = None


class Engine:
    def __init__(
        self,
        params: Any,
        adapter: ModelAdapter,
        batch: int = 1,
        max_seq: int = 2048,
    ):
        self.params = params
        self.adapter = adapter
        self.batch = batch
        self.max_seq = max_seq

        self._prefill = jax.jit(self._prefill_impl)
        self._decode = jax.jit(self._decode_impl, donate_argnums=(2,))
        self._decode_scan = jax.jit(
            self._decode_scan_impl, donate_argnums=(2,), static_argnums=(6,)
        )
        self._verify = jax.jit(self._verify_impl, donate_argnums=(2,))
        self._draft_steps = jax.jit(self._draft_impl, donate_argnums=(2,),
                                    static_argnums=(4,))
        self._spec_scan = jax.jit(self._spec_scan_impl, donate_argnums=(2,),
                                  static_argnums=(5, 6))
        # device-spec observability (tokens per verify forward)
        self.stats = {"spec_forwards": 0, "spec_tokens": 0}

    # -- jitted bodies ----------------------------------------------------

    def _prefill_impl(self, params, tokens, last_idx):
        # the state is ALLOCATED INSIDE the program: an eager zeros()
        # dispatch is pure overhead (XLA fuses the in-program alloc into
        # the first cache write). The offset is a static numpy zero, not
        # a traced one, so kernel selection can see that prefill starts at
        # position 0 (cuDNN flash prefill, kernels.select)
        state = self.adapter.init_state(self.batch, self.max_seq)
        hidden, state = self.adapter.apply(
            params, tokens=tokens, state=state, offset=np.int32(0),
            length=last_idx + 1,
        )
        last = jax.lax.dynamic_slice_in_dim(hidden, last_idx, 1, axis=1)
        logits = self.adapter.lm_head(params, hidden=last)[:, 0, :]
        return logits, state

    def _decode_impl(self, params, token, state, pos, key, temperature,
                     topk=None, topp=None, minp=None, counts=None, fp=None,
                     pp=None, rp=None):
        hidden, state = self.adapter.apply(
            params, tokens=token[:, None], state=state, offset=pos
        )
        logits = self.adapter.lm_head(params, hidden=hidden)[:, 0, :]
        slog = logits
        if counts is not None:
            from tpu_llm.runtime.batching import _apply_penalties

            slog = _apply_penalties(logits, counts, fp, pp, rp)
        next_tok = _select_token(slog, key, temperature, topk, topp, minp)
        if counts is not None:
            counts = counts.at[jnp.arange(counts.shape[0]), next_tok].add(1)
        return next_tok, logits, state, counts

    def _draft_impl(self, params, token, state, pos, n):
        """Greedy-decode ``n`` tokens in one on-device scan — the DRAFT
        side of two-model speculation. Writes the fed tokens' KV at
        positions [pos, pos+n); rows past the verifier's acceptance
        point go stale but are causally invisible (the same
        write-then-attend argument as _verify_impl)."""
        key = jax.random.PRNGKey(0)          # greedy: key is unused

        def body(carry, _):
            token, state, pos = carry
            tok, _, state, _ = self._decode_impl(
                params, token, state, pos, key, jnp.float32(0.0))
            return (tok, state, pos + 1), tok

        (_, state, _), toks = jax.lax.scan(
            body, (token, state, pos), None, length=n)
        return toks[:, 0], state             # (n,) batch-1 draft ids

    def _verify_impl(self, params, tokens, state, pos):
        """Speculative verify: teacher-force ``tokens`` (B, K+1) at
        positions [pos, pos+K] and return the greedy next token AFTER
        each — one forward over a K+1-token window (one batched matmul) instead
        of K+1 sequential decode steps. Cache rows written past the
        accepted prefix are stale but causally invisible, and the next
        verify overwrites them before they can be attended (each step
        writes its slot before it attends)."""
        hidden, state = self.adapter.apply(
            params, tokens=tokens, state=state, offset=pos
        )
        logits = self.adapter.lm_head(params, hidden=hidden)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), state

    def _spec_scan_impl(self, params, ctx, state, n_ctx, pos, n_steps, k):
        """DEVICE-side speculative decoding (greedy, batch 1): draft,
        verify, accept and re-draft entirely inside one ``while_loop`` —
        the host fetches only the finished token buffer. The host-loop
        spec path pays a host round trip per verify; here speculation
        rides the same all-on-device loop as ``generate_scan``.

        Drafting is prompt-lookup (_lookup_draft) vectorized: the context
        ids live in a device buffer; the most recent PRIOR occurrence of
        the trailing 2-gram is a masked argmax over one compare of the
        whole buffer (O(S) VPU work, trivial next to the verify forward).
        Each iteration teacher-forces [last, d1..dk] at [pos, pos+k] —
        stale rows past the accepted prefix are causally invisible and
        overwritten before visibility, the _verify_impl argument.

        ctx: (max_seq + k + 1,) int32 token buffer holding the prompt +
        emitted tokens; n_ctx its fill; pos the next cache row (always
        n_ctx - 1 at entry). Returns (out buffer (n_steps + k,), n_out,
        n_forwards, state) — out[:min(n_out, n_steps)] is EXACTLY the
        plain greedy stream."""
        S = ctx.shape[0]
        out0 = jnp.zeros((n_steps + k,), jnp.int32)

        def cond(c):
            _, n_ctx, _, pos, _, n_out, _ = c
            return (n_out < n_steps) & (pos + k + 1 <= self.max_seq)

        def body(c):
            ctx, n_ctx, state, pos, out, n_out, n_fwd = c
            t_last = jax.lax.dynamic_index_in_dim(ctx, n_ctx - 1, 0, False)
            t_prev = jax.lax.dynamic_index_in_dim(ctx, n_ctx - 2, 0, False)
            idx = jnp.arange(S - 1, dtype=jnp.int32)
            match = ((ctx[:-1] == t_prev) & (ctx[1:] == t_last)
                     & (idx <= n_ctx - 3))
            # prefer the most recent match with a FULL k-token
            # continuation: on periodic/constant streams the nearest
            # match sits at the tail and truncates drafts to 1 token,
            # capping acceptance at 2 tokens/forward — an
            # earlier full-window match lifts it to k+1
            full = match & (idx <= n_ctx - 2 - k)
            jfull = jnp.max(jnp.where(full, idx, -1))
            jany = jnp.max(jnp.where(match, idx, -1))
            jstar = jnp.where(jfull >= 0, jfull, jany)
            drafts = jax.lax.dynamic_slice(
                ctx, (jnp.maximum(jstar, 0) + 2,), (k,))
            d_len = jnp.where(jstar >= 0,
                              jnp.clip(n_ctx - (jstar + 2), 0, k), 0)
            window = jnp.concatenate([t_last[None], drafts])[None, :]
            hidden, state = self.adapter.apply(
                params, tokens=window, state=state, offset=pos)
            logits = self.adapter.lm_head(params, hidden=hidden)
            chain = jnp.argmax(logits[0], axis=-1).astype(jnp.int32)
            ok = ((drafts == chain[:k])
                  & (jnp.arange(k) < d_len)).astype(jnp.int32)
            acc = jnp.sum(jnp.cumprod(ok))
            # emitted tokens ARE chain[:acc+1]; the DUS writes the whole
            # (k+1,) chain — entries past acc are overwritten by the next
            # iteration's write at the advanced n_out, or truncated by
            # the host's out[:n_out] slice
            out = jax.lax.dynamic_update_slice(out, chain, (n_out,))
            ctx = jax.lax.dynamic_update_slice(ctx, chain, (n_ctx,))
            step = acc + 1
            return (ctx, n_ctx + step, state, pos + step, out,
                    n_out + step, n_fwd + 1)

        (_, _, state, pos, out, n_out, n_fwd) = jax.lax.while_loop(
            cond, body,
            (ctx, n_ctx, state, pos, out0, jnp.int32(0), jnp.int32(0)))
        return out, n_out, n_fwd, pos, state

    def _decode_scan_impl(self, params, token, state, pos, key, temperature,
                          n_steps, topk=None, topp=None, minp=None):
        def body(carry, _):
            token, state, pos, key = carry
            key, sub = jax.random.split(key)
            next_tok, _, state, _ = self._decode_impl(
                params, token, state, pos, sub, temperature, topk, topp, minp
            )
            return (next_tok, state, pos + 1, key), next_tok

        (_, state, _, _), toks = jax.lax.scan(
            body, (token, state, pos, key), None, length=n_steps
        )
        return toks, state  # toks: (n_steps, B)

    # -- public API -------------------------------------------------------

    def generate(
        self,
        prompt_ids: Sequence[int],
        n_total: Optional[int] = None,
        n_new: Optional[int] = None,
        temperature: float = 0.0,
        seed: int = 0,
        stream: Optional[Callable[[int], None]] = None,
        add_bos: bool = True,
        use_scan: bool = False,
        speculative_k: int = 0,
        draft: Optional["Engine"] = None,
        top_k: int = 0,
        top_p: float = 1.0,
        min_p: float = 0.0,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
        repetition_penalty: float = 1.0,
    ) -> GenerationResult:
        """Single-stream generation with the reference's -n semantics:
        ``n_total`` counts prompt echo + generated tokens (llama2.f90:379);
        alternatively pass ``n_new``.

        ``speculative_k`` > 0 enables speculative decoding (greedy only,
        positional-state models only): each iteration verifies k drafted
        tokens in ONE forward and emits accepted+1 tokens — output is
        EXACTLY the plain greedy stream. Drafts come from prompt lookup
        (self-speculation) by default, or from ``draft`` — a second
        Engine over a smaller same-vocabulary model (llama.cpp's
        --model-draft): the draft greedy-decodes k tokens in one
        on-device scan, the target verifies them in one forward.
        With ``use_scan=True`` (prompt-lookup, batch 1) the whole
        draft/verify/accept loop runs ON DEVICE (_spec_scan_impl) — no
        host round trip per verify, so acceptance multiplies the scan
        throughput instead of competing with it."""
        prompt_ids = list(prompt_ids)
        if n_total is None:
            n_total = len(prompt_ids) + (n_new if n_new is not None else 128)
        n_total = min(n_total, self.max_seq - 1)

        bos = [self.adapter.bos_id] if add_bos and self.adapter.bos_id >= 0 else []
        if not bos and not prompt_ids:
            raise ValueError("empty prompt with no BOS")
        input_ids = bos + prompt_ids
        if len(input_ids) >= self.max_seq:
            raise ValueError(
                f"prompt ({len(input_ids)} tokens incl. BOS) does not fit "
                f"max_seq={self.max_seq}; raise --max-seq or shorten the "
                f"prompt")
        # positions fed through the model: input_ids then sampled tokens,
        # for n_total total emissions
        emitted: List[int] = []

        t0 = time.perf_counter()

        n_in = len(input_ids)
        pad_to = min(_next_bucket(n_in), self.max_seq)
        toks = np.zeros((self.batch, pad_to), np.int32)
        toks[:, :n_in] = np.asarray(input_ids, np.int32)
        logits, state = self._prefill(
            self.params, jnp.asarray(toks), jnp.int32(n_in - 1)
        )

        # echo the prompt (reference prints prompt tokens as it forces them)
        for t in prompt_ids[: n_total]:
            emitted.append(int(t))
            if stream:
                stream(int(t))

        key = jax.random.PRNGKey(seed)
        temp = jnp.float32(temperature)
        # (None, None) keeps the cheap sampler's jit cache entry
        filt = ((jnp.int32(top_k), jnp.float32(top_p), jnp.float32(min_p))
                if (top_k > 0 or top_p < 1.0 or min_p > 0.0)
                else (None, None, None))
        penalized = (frequency_penalty != 0.0 or presence_penalty != 0.0
                     or repetition_penalty != 1.0)
        counts = pen = None
        if penalized:
            v = self.adapter.vocab_size
            if v <= 0:
                raise ValueError("penalties need adapter.vocab_size")
            row = np.zeros((self.batch, v), np.int32)
            row[:] = np.bincount(input_ids, minlength=v)
            counts = jnp.asarray(row)
            pen = (jnp.float32(frequency_penalty),
                   jnp.float32(presence_penalty),
                   jnp.float32(repetition_penalty))
        n_gen = n_total - len(emitted)
        ttft_s = None

        if n_gen > 0:
            key, sub = jax.random.split(key)
            slog = logits
            if penalized:
                from tpu_llm.runtime.batching import _apply_penalties

                slog = _apply_penalties(logits, counts, *pen)
            first = _select_token(slog, sub, temp, *filt)
            if penalized:
                counts = counts.at[jnp.arange(self.batch), first].add(1)
            first_host = int(jax.device_get(first)[0])
            ttft_s = time.perf_counter() - t0
            emitted.append(first_host)
            if stream:
                stream(first_host)

        t_decode = time.perf_counter()
        pos = n_in  # next write position
        # spec + scan composes: the all-on-device speculative loop
        # (_spec_scan_impl — prompt-lookup only, greedy, batch 1)
        use_device_spec = (
            speculative_k > 0 and temperature == 0 and use_scan
            and not penalized and draft is None and self.batch == 1
            and getattr(self.adapter, "positional_state", True))
        use_spec = (speculative_k > 0 and temperature == 0 and not use_scan
                    and not penalized
                    and getattr(self.adapter, "positional_state", True))
        if penalized and use_scan:
            # the scan loop has no counts carry; penalties run the
            # pipelined step loop (same output, same device-side feed)
            use_scan = False
        if n_gen > 1:
            if use_device_spec:
                k = speculative_k
                steps = n_gen - 1
                bucket = min(_next_bucket(steps), self.max_seq - pos)
                assert bucket >= steps, (bucket, steps)
                ctx_ids = input_ids + [emitted[-1]]
                ctx0 = np.zeros((self.max_seq + k + 1,), np.int32)
                ctx0[: len(ctx_ids)] = np.asarray(ctx_ids, np.int32)
                out_d, n_out_d, n_fwd_d, pos_d, state = self._spec_scan(
                    self.params, jnp.asarray(ctx0), state,
                    jnp.int32(len(ctx_ids)), jnp.int32(pos), bucket, k)
                out_h, n_out, n_fwd, pos = jax.device_get(
                    (out_d, n_out_d, n_fwd_d, pos_d))
                n_emit = min(int(n_out), steps)
                for t in np.asarray(out_h)[:n_emit]:
                    emitted.append(int(t))
                    if stream:
                        stream(int(t))
                self.stats["spec_forwards"] += int(n_fwd)
                self.stats["spec_tokens"] += n_emit
                pos = int(pos)
                # context-window tail (pos + k + 1 would write past the
                # cache): finish with plain single-token steps
                token = jnp.full((self.batch,), emitted[-1], jnp.int32)
                for _ in range(steps - n_emit):
                    key, sub = jax.random.split(key)
                    token, _, state, _ = self._decode(
                        self.params, token, state, jnp.int32(pos), sub, temp
                    )
                    pos += 1
                    tid = int(jax.device_get(token)[0])
                    emitted.append(tid)
                    if stream:
                        stream(tid)
            elif use_spec:
                k = speculative_k
                ctx = list(input_ids) + [emitted[-1]]
                remaining = n_gen - 1

                def emit(t: int):
                    emitted.append(t)
                    ctx.append(t)
                    if stream:
                        stream(t)

                draft_state = None
                draft_pos = 0
                if draft is not None:
                    if draft.adapter.vocab_size != self.adapter.vocab_size:
                        raise ValueError(
                            "draft model must share the target vocabulary")
                    # the draft processes the same prompt once
                    _, draft_state = draft._prefill(
                        draft.params, jnp.asarray(toks),
                        jnp.int32(n_in - 1))
                    draft_pos = n_in

                while remaining > 0 and pos + k + 1 <= self.max_seq and (
                        draft is None or draft_pos + k <= draft.max_seq):
                    if draft is not None:
                        d_dev, draft_state = draft._draft_steps(
                            draft.params,
                            jnp.full((draft.batch,), ctx[-1], jnp.int32),
                            draft_state, jnp.int32(draft_pos), k)
                        drafts = [int(t) for t in
                                  np.asarray(jax.device_get(d_dev))]
                    else:
                        drafts = _lookup_draft(ctx, k)
                    inp = np.zeros((self.batch, k + 1), np.int32)
                    inp[:, 0] = ctx[-1]
                    inp[:, 1 : 1 + len(drafts)] = np.asarray(drafts, np.int32)
                    outs_dev, state = self._verify(
                        self.params, jnp.asarray(inp), state, jnp.int32(pos)
                    )
                    outs = np.asarray(jax.device_get(outs_dev))[0]
                    acc = 0
                    while (acc < len(drafts) and acc < remaining - 1
                           and drafts[acc] == int(outs[acc])):
                        acc += 1
                    for t in drafts[:acc] + [int(outs[acc])]:
                        emit(t)
                    pos += acc + 1
                    remaining -= acc + 1
                    # draft cache rows [draft_pos, draft_pos+acc] hold the
                    # accepted prefix (the fed token + accepted drafts);
                    # later rows are stale-but-invisible. Next round feeds
                    # the corrected token here.
                    draft_pos += acc + 1
                # context-window tail (pos + k + 1 would write past the
                # cache): finish with plain single-token steps
                token = jnp.full((self.batch,), emitted[-1], jnp.int32)
                for _ in range(remaining):
                    key, sub = jax.random.split(key)
                    token, _, state, _ = self._decode(
                        self.params, token, state, jnp.int32(pos), sub, temp
                    )
                    pos += 1
                    emit(int(jax.device_get(token)[0]))
            elif use_scan:
                key, sub = jax.random.split(key)
                # bucket the scan length so distinct -n values share a
                # compile (n_steps is a static argnum); extra steps decode
                # past the requested count into the slack the n_total
                # clamp guarantees, and their tokens are discarded
                steps = n_gen - 1
                bucket = min(_next_bucket(steps), self.max_seq - pos)
                assert bucket >= steps, (bucket, steps)
                toks_dev, state = self._decode_scan(
                    self.params,
                    jnp.full((self.batch,), emitted[-1], jnp.int32),
                    state,
                    jnp.int32(pos),
                    sub,
                    temp,
                    bucket,
                    *filt,
                )
                toks_host = np.asarray(jax.device_get(toks_dev))[:steps, 0]
                for t in toks_host:
                    emitted.append(int(t))
                    if stream:
                        stream(int(t))
            else:
                # one-step-deep emission pipeline: dispatch step i+1 before
                # fetching step i's token, so the host round-trip (which
                # dominates on remote links) overlaps the next device step.
                # The sampled token feeds the next step as a DEVICE array —
                # the host never sits on the critical path.
                token = jnp.full((self.batch,), emitted[-1], jnp.int32)
                pending = None
                parg = (counts, *pen) if penalized else (None, None, None, None)
                for _ in range(n_gen - 1):
                    key, sub = jax.random.split(key)
                    token, _, state, counts = self._decode(
                        self.params, token, state, jnp.int32(pos), sub, temp,
                        *filt, *parg
                    )
                    if penalized:
                        parg = (counts, *pen)
                    pos += 1
                    if pending is not None:
                        tid = int(jax.device_get(pending)[0])
                        emitted.append(tid)
                        if stream:
                            stream(tid)
                    pending = token
                if pending is not None:
                    tid = int(jax.device_get(pending)[0])
                    emitted.append(tid)
                    if stream:
                        stream(tid)
        jax.block_until_ready(jax.tree_util.tree_leaves(state)[0])
        t_end = time.perf_counter()

        decode_s = t_end - t_decode
        n_decoded = max(n_gen - 1, 0)
        return GenerationResult(
            tokens=emitted,
            n_prompt=len(prompt_ids),
            ttft_s=ttft_s if ttft_s is not None else t_end - t0,
            decode_s=decode_s,
            total_s=t_end - t0,
            tokens_per_s=(n_decoded / decode_s) if decode_s > 0 and n_decoded else 0.0,
        )
