"""Continuous batching engine (iteration-level scheduling).

The reference is strictly single-stream (one sequence, one token at a
time, llama2.f90:379-402). For accelerator throughput, decode must be batched —
but requests arrive and finish at different times, so the batch is a set
of SLOTS: each step runs ONE jitted decode for all slots at their own
positions (vector ``offset``), and the host scheduler admits/retires
requests between steps (Orca-style iteration-level scheduling).

Admission runs a DEDICATED PREFILL: the new request's whole prompt goes
through one jitted forward on a fresh batch-1 state slice (large
matmuls, bucketed padding), which is then scattered into the slot's rows
of the batch state — TTFT for a P-token prompt is one prefill pass, not P
batched decode steps. The prefill also resets the slot's state rows
(vital for recurrent models — stale Mamba state would leak).

The decode loop is pipelined one step deep, like the single-stream engine
(engine.py): step i+1 is dispatched with the DEVICE-side sampled tokens
before step i's tokens are fetched to host, so the host round-trip (which
dominates on remote links) overlaps the next device step. Bookkeeping
(append/EOS/completion) lags one step; a slot whose request just finished
decodes one garbage token into its own cache rows, which the next
admission's prefill overwrites.

Everything device-side is fixed-shape: one compiled step per (B, max_seq)
regardless of which slots are live (dead slots decode garbage into their
own cache rows and are ignored — their writes can't leak into other rows).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu_llm.ops.sampling import filtered_sample
from tpu_llm.runtime.engine import (ModelAdapter, _lookup_draft, _next_bucket,
                                    _select_token)


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new: int
    temperature: float = 0.0
    seed: int = 0
    stream: Optional[Callable[[int], None]] = None
    stop_at_eos: bool = False
    top_k: int = 0               # 0 = no top-k filter
    top_p: float = 1.0           # 1.0 = no nucleus filter
    min_p: float = 0.0           # llama.cpp min_p: drop tokens with
    #                              prob < min_p * max_prob (0 = off)
    logprobs: bool = False       # record log P(token) per generated token
    # also record the top-N alternatives per step (OpenAI completions
    # ``logprobs: N`` / chat ``top_logprobs``); capped at _TOPN
    top_logprobs: int = 0
    # OpenAI-style penalties over the text so far (prompt + generated):
    # logits -= frequency_penalty*count + presence_penalty*(count > 0);
    # repetition_penalty (HF convention, 1.0 = off) divides positive /
    # multiplies negative logits of seen tokens first
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    # OpenAI logit_bias: {token_id: bias} added to logits before
    # penalties/temperature (-100 effectively bans, +100 forces)
    logit_bias: Optional[dict] = None
    # extra end-of-generation token ids beyond the model EOS (llama-3's
    # <|eot_id|>, qwen's <|im_end|> — llama.cpp's EOG set); checked when
    # stop_at_eos is set
    stop_token_ids: Optional[List[int]] = None
    # filled by the engine:
    rid: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)  # generated only
    token_logprobs: List[float] = dataclasses.field(default_factory=list)
    # per generated token, top-N alternative (ids, logprobs) — filled
    # when top_logprobs > 0
    top_ids: List[List[int]] = dataclasses.field(default_factory=list)
    top_lps: List[List[float]] = dataclasses.field(default_factory=list)
    done: bool = False


def _bias_row(req: Request, vocab: int) -> np.ndarray:
    """Dense f32 bias row from the sparse OpenAI logit_bias mapping
    (keys may be int or str token ids; values clamped to +/-100)."""
    row = np.zeros((vocab,), np.float32)
    for k, v in (req.logit_bias or {}).items():
        t = int(k)
        if 0 <= t < vocab:
            row[t] = float(np.clip(float(v), -100.0, 100.0))
    return row


def _penalized(req: Request) -> bool:
    return (req.frequency_penalty != 0.0 or req.presence_penalty != 0.0
            or req.repetition_penalty != 1.0)


def _apply_penalties(logits, counts, fps, pps, rps):
    """Penalty-adjusted logits for SAMPLING (reported logprobs stay raw).

    logits (..., V) f32; counts (..., V) int32 token counts over the text
    so far; fps/pps/rps broadcastable penalty knobs ((B,) vectors for the
    batch step, scalars for prefill rows)."""
    c = counts.astype(jnp.float32)
    seen = c > 0
    x = logits.astype(jnp.float32)
    rp = jnp.where(seen, rps[..., None], 1.0)
    x = jnp.where(x > 0, x / rp, x * rp)
    return x - fps[..., None] * c - pps[..., None] * seen


def _prefill_extras(req: Request, vocab: int, input_ids):
    """Positional (crow, fp, pp, rp, brow, want_top) tail for the
    _prefill_impl dispatch — later knobs back-fill earlier None slots so
    the jit arg positions always line up (ONE shared ladder for both
    engines; the step path passes every slot explicitly via the *_args
    helpers). ``input_ids`` is BOS + prompt as fed at admission — the
    prompt-count row penalizes the first sampled token too."""
    pen = ()
    if _penalized(req):
        row = np.bincount(input_ids, minlength=vocab)
        pen = (jnp.asarray(row.astype(np.int32)),
               jnp.float32(req.frequency_penalty),
               jnp.float32(req.presence_penalty),
               jnp.float32(req.repetition_penalty))
    bias = ()
    if req.logit_bias:
        bias = (jnp.asarray(_bias_row(req, vocab)),)
    want = (jnp.int32(1),) if req.top_logprobs > 0 else ()
    if want and not bias:
        bias = (None,)
    if bias and not pen:
        pen = (None, None, None, None)
    return (*pen, *bias, *want)


def _req_filters(req: Request):
    """(top_k, top_p) device scalars for a filtered request, else
    (None, None) — None selects the cheap sampler's jit cache entry."""
    if req.top_k > 0 or req.top_p < 1.0 or req.min_p > 0.0:
        return (jnp.int32(req.top_k), jnp.float32(req.top_p),
                jnp.float32(req.min_p))
    return None, None, None


def _sample_rows(logits, keys, temps, topks, topps, minps=None):
    """Per-slot sampling: the cheap greedy/CDF path unless any request in
    the compiled variant carries a top-k/top-p/min-p filter (``topks is
    None`` distinguishes the two jit cache entries — filters cost two
    vocab sorts per slot, so the plain path must not pay for them)."""
    if topks is None:
        return jax.vmap(_select_token)(logits, keys, temps)
    return jax.vmap(filtered_sample)(logits, keys, temps, topks, topps,
                                     minps)


def _sample_step(logits, keys, temps, topks, topps, minps, counts, fps,
                 pps, rps, biases=None):
    """Batched decode-step sampling with optional logit biases and
    penalties: sample from adjusted logits, then bump the device-side
    per-slot token counts (no host sync in the loop). ``counts is None``
    / ``biases is None`` keep the plain path's compiled variant
    untouched."""
    slog = logits if biases is None else logits + biases
    if counts is not None:
        slog = _apply_penalties(slog, counts, fps, pps, rps)
    sampled = _sample_rows(slog, keys, temps, topks, topps, minps)
    if counts is not None:
        counts = counts.at[jnp.arange(counts.shape[0]), sampled].add(1)
    return sampled, counts


_TOPN = 20     # compiled top-k width for top_logprobs (host slices per
#                request; matches OpenAI's chat top_logprobs max of 20)


def _top_rows(logits):
    """(..., V) logits -> (vals (..., _TOPN) log-softmax, ids) for the
    OpenAI top_logprobs report."""
    x = logits.astype(jnp.float32)
    lse = jax.scipy.special.logsumexp(x, axis=-1, keepdims=True)
    vals, ids = jax.lax.top_k(x - lse, _TOPN)
    return vals, ids.astype(jnp.int32)


def _token_logprob(logits, toks):
    """log P(tok) under the raw (untempered, unfiltered) distribution —
    what OpenAI's ``logprobs`` reports. logits (..., V), toks (...)."""
    x = logits.astype(jnp.float32)
    lse = jax.scipy.special.logsumexp(x, axis=-1)
    chosen = jnp.take_along_axis(
        x, toks[..., None].astype(jnp.int32), axis=-1)[..., 0]
    return chosen - lse


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                 # next cache write position
    key: Any = None

    @property
    def free(self) -> bool:
        return self.req is None


class BatchEngine:
    def __init__(
        self,
        params: Any,
        adapter: ModelAdapter,
        batch: int = 8,
        max_seq: int = 1024,
        eos_id: int = 2,
        speculative_k: int = 0,
        draft=None,
    ):
        self.params = params
        self.adapter = adapter
        self.batch = batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        # batched prompt-lookup speculative decoding: each step verifies
        # up to k drafted tokens PER SLOT in one (B, k+1) forward and
        # emits accepted+1 tokens per greedy slot. Requires positional
        # state (KV cache rollback-by-overwrite); recurrent adapters
        # silently run the plain step. The spec step fetches tokens
        # synchronously (drafting needs the host context), trading the
        # pipelined step's hidden round-trip for multi-token emission.
        self.spec_k = (speculative_k
                       if getattr(adapter, "positional_state", True) else 0)
        # two-model speculation: ``draft`` = (params, adapter) of a
        # smaller same-vocabulary model. The draft keeps its OWN dense
        # batch state mirroring the slots (positions advance in lockstep
        # with slot.pos); each spec iteration greedy-decodes K tokens for
        # every slot in one batched on-device scan, replacing prompt
        # lookup. Works under the paged target too — the draft cache is
        # dense and independent of the target's paging.
        self._draft = None
        if draft is not None and self.spec_k:
            dparams, dadapter = draft
            if dadapter.vocab_size != adapter.vocab_size:
                raise ValueError(
                    "draft model must share the target vocabulary")
            self._draft = (dparams, dadapter)
            self._draft_state = dadapter.init_state(batch, max_seq)
            self._draft_scan = jax.jit(self._draft_scan_impl,
                                       donate_argnums=(2,),
                                       static_argnums=(4,))
            self._draft_prefill = jax.jit(self._draft_prefill_impl,
                                          donate_argnums=(2,))
        self.bos_id = adapter.bos_id
        self._vocab = adapter.vocab_size
        self.slots = [_Slot() for _ in range(batch)]
        self.state = adapter.init_state(batch, max_seq)
        self._baxis = adapter.state_batch_axis
        self._queue: List[Request] = []
        self._next_rid = 0
        self._step = jax.jit(self._step_impl, donate_argnums=(2,))
        self._prefill = jax.jit(self._prefill_impl, donate_argnums=(2,))
        self._verify = jax.jit(self._verify_impl, donate_argnums=(2,))
        # NOT donated: the in-flight snapshot may alias the current
        # token_dev — donating would invalidate the pending host fetch
        self._set_lane = jax.jit(lambda t, i, v: t.at[i].set(v))
        # device-resident sampled tokens: decode feeds on these directly,
        # the host only reads them one step behind
        self._token_dev = jnp.zeros((batch,), jnp.int32)
        self._lp_dev = jnp.zeros((batch,), jnp.float32)
        self._inflight = None        # (token_dev snapshot, [(slot_idx, req)])
        # penalty token counts (B, V) int32, device-resident while any
        # live request penalizes; rebuilt from host context on admission
        self._counts = None
        self._counts_dirty = False
        # static per-slot logit-bias rows (B, V) f32 while any live
        # request biases (OpenAI logit_bias); rebuilt on admission
        self._bias = None
        self._bias_dirty = False
        # observability: speculative acceptance (tokens emitted per
        # verify forward; 1.0 would mean zero accepted drafts)
        self.stats = {"spec_forwards": 0, "spec_tokens": 0}

    # -- jitted bodies ----------------------------------------------------

    def _step_impl(self, params, tokens, state, offsets, keys, temps,
                   topks=None, topps=None, minps=None, counts=None,
                   fps=None, pps=None, rps=None, biases=None,
                   want_top=None):
        hidden, state = self.adapter.apply(
            params, tokens=tokens[:, None], state=state, offset=offsets
        )
        logits = self.adapter.lm_head(params, hidden=hidden)[:, 0, :]
        sampled, counts = _sample_step(logits, keys, temps, topks, topps,
                                       minps, counts, fps, pps, rps, biases)
        tops = None if want_top is None else _top_rows(logits)
        return sampled, _token_logprob(logits, sampled), state, counts, tops

    def _verify_impl(self, params, tokens, state, offsets, keys, temps,
                     topks=None, topps=None, minps=None, want_top=None):
        """Speculative verify (tokens (B, K+1) at per-slot offsets):
        greedy next-token chain for every window position, plus a sampled
        token from position 0 for temperature>0 slots (which accept no
        drafts — their stream must match the plain sampled stream)."""
        hidden, state = self.adapter.apply(
            params, tokens=tokens, state=state, offset=offsets
        )
        logits = self.adapter.lm_head(params, hidden=hidden)  # (B, K+1, V)
        chain = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        sampled0 = _sample_rows(logits[:, 0], keys, temps, topks, topps,
                                minps)
        tops = None if want_top is None else _top_rows(logits)
        return (chain, _token_logprob(logits, chain),
                sampled0, _token_logprob(logits[:, 0], sampled0), state,
                tops)

    def _draft_scan_impl(self, params, tokens, state, offsets, k):
        """Greedy-decode ``k`` tokens for every slot at its own offset —
        the batched draft side of two-model speculation."""
        adapter = self._draft[1]

        def body(carry, _):
            tokens, state, offsets = carry
            hidden, state = adapter.apply(
                params, tokens=tokens[:, None], state=state, offset=offsets)
            logits = adapter.lm_head(params, hidden=hidden)[:, 0, :]
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            return (tok, state, offsets + 1), tok

        (_, state, _), toks = jax.lax.scan(
            body, (tokens, state, offsets), None, length=k)
        return toks, state                   # (k, B)

    def _draft_prefill_impl(self, params, tokens, state, slot, last_idx):
        """Prefill the prompt into the DRAFT state's rows for ``slot``
        (mirrors _prefill_impl without the sampling tail)."""
        adapter = self._draft[1]
        ax = adapter.state_batch_axis
        fresh = jax.tree_util.tree_map(
            lambda a: jnp.zeros_like(
                jax.lax.slice_in_dim(a, 0, 1, axis=ax)), state)
        _, sub = adapter.apply(params, tokens=tokens, state=fresh,
                               offset=np.int32(0), length=last_idx + 1)
        return jax.tree_util.tree_map(
            lambda a, b: jax.lax.dynamic_update_slice_in_dim(
                a, b.astype(a.dtype), slot, axis=ax), state, sub)

    def _prefill_impl(self, params, tokens, state, slot, last_idx, key, temp,
                      topk=None, topp=None, minp=None, crow=None, fp=None,
                      pp=None, rp=None, brow=None, want_top=None):
        """Prefill ``tokens`` (1, Tpad) into fresh batch-1 state rows, then
        scatter them into the batch state at ``slot``. Returns the first
        sampled token and the updated state."""
        ax = self._baxis
        fresh = jax.tree_util.tree_map(
            lambda a: jnp.zeros_like(
                jax.lax.slice_in_dim(a, 0, 1, axis=ax)), state
        )
        hidden, sub = self.adapter.apply(
            params, tokens=tokens, state=fresh, offset=np.int32(0),
            length=last_idx + 1,
        )
        last = jax.lax.dynamic_slice_in_dim(hidden, last_idx, 1, axis=1)
        logits = self.adapter.lm_head(params, hidden=last)[:, 0, :]
        slog = logits if brow is None else logits + brow[None]
        if crow is not None:
            slog = _apply_penalties(slog[0], crow, fp, pp, rp)[None]
        if topk is None:
            sampled = _select_token(slog, key, temp)[0]
        else:
            sampled = filtered_sample(slog[0], key, temp, topk, topp, minp)
        lp = _token_logprob(logits[0], sampled)
        state = jax.tree_util.tree_map(
            lambda a, b: jax.lax.dynamic_update_slice_in_dim(
                a, b.astype(a.dtype), slot, axis=ax),
            state, sub,
        )
        tops = None if want_top is None else _top_rows(logits[0])
        return sampled, lp, state, tops

    # -- public API -------------------------------------------------------

    def _reset_common(self):
        """Shared host-side bookkeeping reinit for ``reset``."""
        self.slots = [_Slot() for _ in range(self.batch)]
        self._queue = []
        self._token_dev = jnp.zeros((self.batch,), jnp.int32)
        self._lp_dev = jnp.zeros((self.batch,), jnp.float32)
        self._inflight = None
        self._counts = None
        self._counts_dirty = False
        self._bias = None
        self._bias_dirty = False
        if self._draft is not None:
            dstate = self._draft[1].init_state(self.batch, self.max_seq)
            placer = getattr(self, "_place_draft_state", None)
            self._draft_state = placer(dstate) if placer else dstate

    def reset(self) -> None:
        """Reinitialize ALL decode state from the (stateless) params —
        the serving loop's crash-recovery hook (SURVEY §5: health-checked
        decode loop, deterministic restart from the stateless weight
        store). Live slots and the queue are dropped; the caller fails
        their requests loudly. Mesh engines re-place the fresh state
        (``_place_state`` installed by parallel.serving.shard_engine)."""
        self._reset_common()
        state = self.adapter.init_state(self.batch, self.max_seq)
        placer = getattr(self, "_place_state", None)
        self.state = placer(state) if placer else state

    def submit(self, req: Request) -> Request:
        req.rid = self._next_rid
        self._next_rid += 1
        if not req.prompt:
            raise ValueError("empty prompt")
        if (_penalized(req) or req.logit_bias) and self._vocab <= 0:
            raise ValueError(
                "penalties/logit_bias need adapter.vocab_size for the "
                "count/bias buffers")
        n_bos = 1 if self.bos_id >= 0 else 0
        if len(req.prompt) + n_bos + req.max_new > self.max_seq:
            raise ValueError("prompt (+BOS) + max_new exceeds max_seq")
        self._queue.append(req)
        return req

    @property
    def n_active(self) -> int:
        return sum(0 if s.free else 1 for s in self.slots)

    def _admit(self):
        for idx, slot in enumerate(self.slots):
            if slot.free and self._queue:
                req = self._queue.pop(0)
                slot.req = req
                slot.key = jax.random.PRNGKey(req.seed)

                bos = [self.adapter.bos_id] if self.adapter.bos_id >= 0 else []
                input_ids = bos + req.prompt
                n_in = len(input_ids)
                pad_to = min(_next_bucket(n_in), self.max_seq)
                toks = np.zeros((1, pad_to), np.int32)
                toks[0, :n_in] = np.asarray(input_ids, np.int32)

                slot.key, sub = jax.random.split(slot.key)
                if _penalized(req) or self._counts is not None:
                    self._counts_dirty = True
                if req.logit_bias or self._bias is not None:
                    self._bias_dirty = True
                sampled, lp_d, self.state, tops_d = self._prefill(
                    self.params, jnp.asarray(toks), self.state,
                    jnp.int32(idx), jnp.int32(n_in - 1), sub,
                    jnp.float32(req.temperature), *_req_filters(req),
                    *_prefill_extras(req, self._vocab, input_ids),
                )
                # one host fetch per REQUEST (not per token): the prefill
                # token is the request's first generated token
                if self._draft is not None:
                    self._draft_state = self._draft_prefill(
                        self._draft[0], jnp.asarray(toks),
                        self._draft_state, jnp.int32(idx),
                        jnp.int32(n_in - 1))
                tok, lp, tops = jax.device_get((sampled, lp_d, tops_d))
                tok = int(tok)
                slot.pos = n_in
                self._token_dev = self._set_lane(
                    self._token_dev, jnp.int32(idx), jnp.int32(tok)
                )
                self._record(slot, tok, float(lp),
                             top=None if tops is None
                             else (tops[1], tops[0]))

    def _record(self, slot: _Slot, tok: int, lp: Optional[float] = None,
                top=None):
        """Append a fetched token to the slot's request; retire on EOS /
        budget / context exhaustion. ``top`` is an optional
        (ids (_TOPN,), logprobs (_TOPN,)) pair for top_logprobs."""
        req = slot.req
        if req is None or req.done:
            return
        req.tokens.append(tok)
        if (req.logprobs or req.top_logprobs > 0) and lp is not None:
            req.token_logprobs.append(lp)
        if req.top_logprobs > 0 and top is not None:
            n = min(req.top_logprobs, len(top[0]))
            req.top_ids.append([int(t) for t in top[0][:n]])
            req.top_lps.append([float(x) for x in top[1][:n]])
        if req.stream:
            req.stream(tok)
        ends = len(req.tokens) >= req.max_new or (
            req.stop_at_eos and (tok == self.eos_id
                                 or (req.stop_token_ids is not None
                                     and tok in req.stop_token_ids))
        )
        if ends or slot.pos >= self.max_seq:
            req.done = True
            slot.req = None

    def _filter_vecs(self, live):
        """Per-slot (top_k, top_p) vectors, or (None, None) when no live
        request filters — keeping the plain step's compiled variant."""
        if not any(r.top_k > 0 or r.top_p < 1.0 or r.min_p > 0.0
                   for _, r in live):
            return None, None, None
        topks = np.zeros((self.batch,), np.int32)
        topps = np.ones((self.batch,), np.float32)
        minps = np.zeros((self.batch,), np.float32)
        for i, r in live:
            topks[i] = r.top_k
            topps[i] = r.top_p
            minps[i] = r.min_p
        return jnp.asarray(topks), jnp.asarray(topps), jnp.asarray(minps)

    def _penalty_args(self, live):
        """(counts, fps, pps, rps) for the step dispatch — all None while
        no live request penalizes (the plain compiled variant). Counts
        rebuild from host context on admission events; between rebuilds
        the jitted step maintains them on device."""
        if not any(_penalized(r) for _, r in live):
            self._counts = None
            return None, None, None, None
        if self._counts is None or self._counts_dirty:
            # drain the pipelined fetch first: the in-flight token is not
            # in req.tokens yet and would be missed by the rebuild
            self._collect()
            v = self._vocab
            rows = np.zeros((self.batch, v), np.int32)
            bos = [self.bos_id] if self.bos_id >= 0 else []
            for i, r in live:
                ctx = bos + r.prompt + r.tokens
                rows[i] = np.bincount(
                    np.asarray(ctx, np.int64), minlength=v)
            self._counts = jnp.asarray(rows)
            self._counts_dirty = False
        fps = np.zeros((self.batch,), np.float32)
        pps = np.zeros((self.batch,), np.float32)
        rps = np.ones((self.batch,), np.float32)
        for i, r in live:
            fps[i] = r.frequency_penalty
            pps[i] = r.presence_penalty
            rps[i] = r.repetition_penalty
        return (self._counts, jnp.asarray(fps), jnp.asarray(pps),
                jnp.asarray(rps))

    def _want_top(self, live):
        return (jnp.int32(1),) if any(
            r.top_logprobs > 0 for _, r in live) else (None,)

    def _bias_args(self, live):
        """(biases,) for the step dispatch — (None,) while no live request
        biases. Static per request: rebuilt host-side on admission only."""
        if not any(r.logit_bias for _, r in live):
            self._bias = None
            return (None,)
        if self._bias is None or self._bias_dirty:
            rows = np.zeros((self.batch, self._vocab), np.float32)
            for i, r in live:
                if r.logit_bias:
                    rows[i] = _bias_row(r, self._vocab)
            self._bias = jnp.asarray(rows)
            self._bias_dirty = False
        return (self._bias,)

    def cancel(self, req: Request) -> bool:
        """Retire ``req`` immediately (client disconnect, stop-string
        match). Safe between steps: in-flight bookkeeping skips retired
        slots (``slot.req is not req``). Returns True if it was live."""
        if req.done:
            return False
        for slot in self.slots:
            if slot.req is req:
                req.done = True
                slot.req = None
                return True
        if req in self._queue:          # never admitted
            self._queue.remove(req)
            req.done = True
            return True
        return False

    _POP = object()        # sentinel: collect whatever is in flight

    def _collect(self, inflight=_POP):
        """Fetch a dispatched step's sampled tokens and update bookkeeping
        (one step behind the device)."""
        if inflight is BatchEngine._POP:
            inflight, self._inflight = self._inflight, None
        if inflight is None:
            return
        (token_snapshot, lp_snapshot, tops_snapshot), metas = inflight
        fetched, lps, tops = jax.device_get(
            (token_snapshot, lp_snapshot, tops_snapshot))
        fetched, lps = np.asarray(fetched), np.asarray(lps)
        for idx, req in metas:
            slot = self.slots[idx]
            if slot.req is not req or req.done:
                continue            # slot was retired/reused after dispatch
            top = (None if tops is None
                   else (tops[1][idx], tops[0][idx]))
            self._record(slot, int(fetched[idx]), float(lps[idx]), top=top)

    def _pre_dispatch(self, live) -> None:
        """Hook between admission and dispatch (PagedEngine grows block
        tables here). Base engine: nothing to do."""

    def _step_spec(self, live) -> int:
        """One speculative iteration: draft per slot (prompt lookup on the
        host context), verify all drafts in ONE (B, k+1) forward, emit
        accepted+1 tokens per greedy slot (sampled slots emit their one
        sampled token — identical stream to the plain path)."""
        k = self.spec_k
        toks = np.zeros((self.batch, k + 1), np.int32)
        offsets = np.zeros((self.batch,), np.int32)
        temps = np.zeros((self.batch,), np.float32)
        keys = []
        drafts_by_slot = {}
        bos = [self.bos_id] if self.bos_id >= 0 else []
        model_drafts = None
        if self._draft is not None:
            # one batched draft scan for every slot at its own offset
            feed = np.zeros((self.batch,), np.int32)
            offs = np.zeros((self.batch,), np.int32)
            for i, slot in enumerate(self.slots):
                if not slot.free:
                    ctx0 = bos + slot.req.prompt + slot.req.tokens
                    feed[i] = ctx0[-1]
                    offs[i] = slot.pos
            d_dev, self._draft_state = self._draft_scan(
                self._draft[0], jnp.asarray(feed), self._draft_state,
                jnp.asarray(offs), k)
            model_drafts = np.asarray(jax.device_get(d_dev))   # (k, B)
        for i, slot in enumerate(self.slots):
            if slot.free:
                keys.append(jax.random.PRNGKey(0))
                continue
            req = slot.req
            ctx = bos + req.prompt + req.tokens
            if req.temperature != 0:
                drafts = []
            elif model_drafts is not None:
                drafts = [int(t) for t in model_drafts[:, i]]
            else:
                drafts = _lookup_draft(ctx, k)
            drafts_by_slot[i] = drafts
            toks[i, 0] = ctx[-1]
            toks[i, 1 : 1 + len(drafts)] = np.asarray(drafts, np.int32)
            offsets[i] = slot.pos
            temps[i] = req.temperature
            slot.key, sub = jax.random.split(slot.key)
            keys.append(sub)

        chain_d, chain_lp_d, sampled0_d, s0lp_d, self.state, tops_d = \
            self._verify(
                self.params, jnp.asarray(toks), self.state,
                jnp.asarray(offsets), jnp.stack(keys), jnp.asarray(temps),
                *self._filter_vecs(live), *self._want_top(live))
        chain, chain_lp, sampled0, s0lp, tops = jax.device_get(
            (chain_d, chain_lp_d, sampled0_d, s0lp_d, tops_d))
        chain, chain_lp = np.asarray(chain), np.asarray(chain_lp)
        sampled0, s0lp = np.asarray(sampled0), np.asarray(s0lp)

        lanes, vals = [], []
        for i, req in live:
            slot = self.slots[i]
            drafts = drafts_by_slot[i]
            if req.temperature > 0:
                new = [int(sampled0[i])]
                lps = [float(s0lp[i])]
            else:
                acc = 0
                while acc < len(drafts) and drafts[acc] == int(chain[i, acc]):
                    acc += 1
                # emitted tokens ARE chain[:acc+1] (accepted drafts match
                # the greedy chain), so their logprobs line up with it
                new = drafts[:acc] + [int(chain[i, acc])]
                lps = [float(x) for x in chain_lp[i, : acc + 1]]
            slot.pos += len(new)
            self.stats["spec_forwards"] += 1
            self.stats["spec_tokens"] += len(new)
            for j, (t, lp) in enumerate(zip(new, lps)):
                # window position j's logits produced emitted token j
                # (temperature>0 slots emit only position 0)
                top = (None if tops is None
                       else (tops[1][i, j], tops[0][i, j]))
                self._record(slot, t, lp, top=top)
                if slot.req is not req or req.done:
                    break
            lanes.append(i)
            vals.append(new[-1])
        # keep the device-side token vector coherent: a later plain
        # (pipelined) step feeds from it
        self._token_dev = self._set_lane(
            self._token_dev, jnp.asarray(lanes, jnp.int32),
            jnp.asarray(vals, jnp.int32))
        return len(live)

    def step(self) -> int:
        """One engine iteration: admit (prefill), dispatch one batched
        decode, then fetch the PREVIOUS step's tokens. Returns the number
        of live slots the dispatch covered."""
        self._admit()
        if self.spec_k:
            # drain the pipelined fetch BEFORE snapshotting live slots:
            # its bookkeeping may retire a slot, and the spec step drafts
            # from (and indexes by) the post-collect state — a stale
            # snapshot would KeyError on a just-retired slot
            self._collect()
        live = [(i, s.req) for i, s in enumerate(self.slots) if not s.free]
        self._pre_dispatch(live)
        if not live:
            self._collect()
            return 0
        if self.spec_k and any(
            r.temperature == 0 for _, r in live
        ) and not any(
            _penalized(r) or r.logit_bias for _, r in live
        ) and all(
            self.slots[i].pos + self.spec_k + 1 <= self.max_seq
            for i, _ in live
        ):
            # near-cache-boundary batches fall through to the plain step
            # — a padded verify window would write past the cache.
            # Penalized slots also fall through: the greedy chain inside
            # verify would need per-position evolving counts.
            # All-sampled batches fall through too: only greedy slots can
            # accept drafts, so a temperature>0-only batch would pay the
            # (B, k+1) verify forward plus a synchronous host fetch to
            # emit exactly one token per slot — strictly worse than the
            # pipelined plain step.
            return self._step_spec(live)

        offsets = np.zeros((self.batch,), np.int32)
        temps = np.zeros((self.batch,), np.float32)
        keys = []
        for i, slot in enumerate(self.slots):
            if slot.free:
                keys.append(jax.random.PRNGKey(0))
                continue
            offsets[i] = min(slot.pos, self.max_seq - 1)
            temps[i] = slot.req.temperature
            slot.key, sub = jax.random.split(slot.key)
            keys.append(sub)
            slot.pos += 1

        (self._token_dev, self._lp_dev, self.state, self._counts,
         tops_dev) = self._step(
            self.params,
            self._token_dev,
            self.state,
            jnp.asarray(offsets),
            jnp.stack(keys),
            jnp.asarray(temps),
            *self._filter_vecs(live),
            *self._penalty_args(live),
            *self._bias_args(live),
            *self._want_top(live),
        )
        prev = self._inflight
        self._inflight = ((self._token_dev, self._lp_dev, tops_dev), live)
        self._collect(prev)
        return len(live)

    def run(self) -> None:
        """Drive until all submitted requests complete."""
        while self._queue or self.n_active:
            self.step()
        self._collect()
