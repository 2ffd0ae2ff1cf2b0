"""Paged-KV continuous-batching engine (vLLM-style serving memory).

`BatchEngine` preallocates a dense (B, max_seq) cache per layer — every
slot pays HBM for the longest context it might ever reach, the
reference's hard cap (llama2.f90:311-313) generalized to a batch. This
engine maps each slot's sequence onto fixed-size blocks from a shared
pool through an int32 block table (ops/paged_kv.py), so:

- HBM scales with tokens actually resident, not slots x max_seq;
- a slot can grow past any per-slot preallocation (blocks are allocated
  on demand as decode crosses block boundaries);
- full prompt-prefix blocks are SHARED between requests (automatic
  prefix caching): a repeated prefix costs zero prefill compute and zero
  new HBM — admission increfs the cached blocks and forwards only the
  tail. Cached blocks survive their owner's completion and are evicted
  LRU when the pool runs dry.

Scheduling (slot admission, block allocation/release, prefix matching)
is host-side between steps, exactly like the dense engine's slot logic;
everything device-side stays fixed-shape jitted programs: one decode
step per batch and one prefill per bucketed tail length.

Llama-family only: Mamba state is O(1) per slot (nothing to page), and
the dense engine already serves it.

Known cost cliff: with speculative decoding (speculative_k > 0) every
step is a (B, K+1) verify forward, and T>1 paged attention goes through
the GATHER path — the O(pos) paged decode kernel serves only T=1 steps.
Combine --paged with --spec when draft acceptance (repetitive workloads)
outweighs the per-step gather; the dense engine has no such cliff.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu_llm.config import LlamaConfig
from tpu_llm.ops.paged_kv import (
    BlockAllocator,
    PagedKV,
    PrefixCache,
    paged_gqa_attention,
    paged_update_tokens,
)
from tpu_llm.runtime.batching import BatchEngine, Request, _Slot
from tpu_llm.ops.sampling import filtered_sample
from tpu_llm.runtime.batching import (_apply_penalties, _penalized,
                                      _prefill_extras, _req_filters,
                                      _sample_rows, _sample_step,
                                      _token_logprob, _top_rows)
from tpu_llm.runtime.engine import _next_bucket, _select_token

__all__ = ["PagedEngine", "Request"]


def _paged_update_fn(kc: PagedKV, vc, k, v, offset):
    """forward() cache-write hook: kc carries BOTH pools (vc is None)."""
    return paged_update_tokens(kc, k, v, offset), None


def _paged_attn_fn(q, ka: PagedKV, va, positions, offset):
    return paged_gqa_attention(q, ka, positions, offset=offset)


class PagedEngine(BatchEngine):
    """Continuous batching over a paged KV cache with prefix caching.

    Same public surface as BatchEngine (submit/step/run/Request)."""

    def __init__(
        self,
        params: Any,
        cfg: LlamaConfig,
        batch: int = 8,
        n_blocks: int = 256,
        block_size: int = 16,
        max_seq: Optional[int] = None,
        eos_id: int = 2,
        bos_id: int = 1,
        cache_dtype=jnp.float32,
        prefix_caching: bool = True,
        prefill_chunk: Optional[int] = 512,
        speculative_k: int = 0,
        draft=None,
    ):
        from tpu_llm.models import llama as M

        if not isinstance(params.get("layers"), (list, tuple)):
            params = M.unstack_layers(params)
        self.params = params
        self.cfg = cfg
        self.batch = batch
        quantized = cache_dtype == "int8" or cache_dtype == jnp.int8
        self.block_size = block_size
        self.n_layers = len(params["layers"])
        mb = ((max_seq or cfg.seq_len) + block_size - 1) // block_size
        self.max_blocks = mb
        self.max_seq = mb * block_size
        self.eos_id = eos_id
        self.bos_id = bos_id
        self._vocab = cfg.vocab_size
        self._counts = None
        self._counts_dirty = False
        self._bias = None
        self._bias_dirty = False

        self.allocator = BlockAllocator(n_blocks)
        self.prefix = PrefixCache(self.allocator) if prefix_caching else None
        self._slot_blocks: List[List[int]] = [[] for _ in range(batch)]
        self._slot_reserved: List[int] = [0] * batch
        # last position whose KV must ever be real, per slot: the final
        # sampled token is never forwarded, so writes stop at
        # n_in + max_new - 2 (growth clamps here; later writes are
        # pipelined garbage routed to the null block)
        self._slot_span: List[int] = [0] * batch

        self.quantized = quantized
        self._n_blocks = n_blocks
        self._pool_dtype = jnp.int8 if self.quantized else cache_dtype
        self.state: Dict[str, Any] = self._fresh_state()

        self.slots = [_Slot() for _ in range(batch)]
        self._queue = []
        self._next_rid = 0
        self.prefill_chunk = prefill_chunk
        self.spec_k = speculative_k
        # two-model speculation: dense draft cache independent of the
        # target's paging (see BatchEngine)
        self._draft = None
        if draft is not None and self.spec_k:
            dparams, dadapter = draft
            if dadapter.vocab_size != cfg.vocab_size:
                raise ValueError(
                    "draft model must share the target vocabulary")
            self._draft = (dparams, dadapter)
            self._draft_state = dadapter.init_state(batch, self.max_seq)
            self._draft_scan = jax.jit(self._draft_scan_impl,
                                       donate_argnums=(2,),
                                       static_argnums=(4,))
            self._draft_prefill = jax.jit(self._draft_prefill_impl,
                                          donate_argnums=(2,))
        self._step = jax.jit(self._step_impl, donate_argnums=(2,))
        self._verify = jax.jit(self._verify_impl, donate_argnums=(2,))
        self._prefill = jax.jit(self._prefill_impl, donate_argnums=(2,))
        self._prefill_part = jax.jit(self._prefill_part_impl,
                                     donate_argnums=(2,))
        self._set_lane = jax.jit(lambda t, i, v: t.at[i].set(v))
        self._set_cells = jax.jit(lambda t, r, c, v: t.at[r, c].set(v))
        self._set_slot_meta = jax.jit(self._set_slot_meta_impl,
                                      donate_argnums=(0,))
        self._token_dev = jnp.zeros((batch,), jnp.int32)
        self._inflight = None
        self.stats = {"spec_forwards": 0, "spec_tokens": 0}

    def _fresh_state(self) -> Dict[str, Any]:
        kvd = self.cfg.kv_dim
        n_blocks, block_size = self._n_blocks, self.block_size
        scale_shape = (self.cfg.n_kv_heads, n_blocks, block_size)
        return {
            "k": [jnp.zeros((n_blocks, block_size, kvd), self._pool_dtype)
                  for _ in range(self.n_layers)],
            "v": [jnp.zeros((n_blocks, block_size, kvd), self._pool_dtype)
                  for _ in range(self.n_layers)],
            "ks": [jnp.zeros(scale_shape, jnp.float32)
                   for _ in range(self.n_layers)]
            if self.quantized else None,
            "vs": [jnp.zeros(scale_shape, jnp.float32)
                   for _ in range(self.n_layers)]
            if self.quantized else None,
            "table": jnp.zeros((self.batch, self.max_blocks), jnp.int32),
            "lengths": jnp.zeros((self.batch,), jnp.int32),
        }

    def reset(self) -> None:
        """Crash-recovery reinit (see BatchEngine.reset): fresh pools,
        allocator, prefix cache, and slot metadata from the stateless
        params."""
        self._reset_common()
        self.allocator = BlockAllocator(self._n_blocks)
        self.prefix = (PrefixCache(self.allocator)
                       if self.prefix is not None else None)
        self._slot_blocks = [[] for _ in range(self.batch)]
        self._slot_reserved = [0] * self.batch
        self._slot_span = [0] * self.batch
        state = self._fresh_state()
        placer = getattr(self, "_place_state", None)
        self.state = placer(state) if placer else state

    # -- jitted bodies ----------------------------------------------------

    def _layer_caches(self, state, table, lengths):
        q = state.get("ks") is not None
        return {
            "k": [PagedKV(state["k"][i], state["v"][i], table, lengths,
                          state["ks"][i] if q else None,
                          state["vs"][i] if q else None)
                  for i in range(self.n_layers)],
            "v": [None] * self.n_layers,
        }

    @staticmethod
    def _repack(state, new_cache, table, lengths):
        q = state.get("ks") is not None
        return {
            "k": [kv.k_pool for kv in new_cache["k"]],
            "v": [kv.v_pool for kv in new_cache["k"]],
            "ks": [kv.k_scale for kv in new_cache["k"]] if q else None,
            "vs": [kv.v_scale for kv in new_cache["k"]] if q else None,
            "table": table,
            "lengths": lengths,
        }

    def _step_impl(self, params, tokens, state, offsets, keys, temps,
                   topks=None, topps=None, minps=None, counts=None,
                   fps=None, pps=None,
                   rps=None, biases=None, want_top=None):
        from tpu_llm.models import llama as M

        cache = self._layer_caches(state, state["table"], state["lengths"])
        hidden, nc = M.forward(params, self.cfg, tokens[:, None], cache,
                               offsets, update_fn=_paged_update_fn,
                               attn_fn=_paged_attn_fn)
        logits = M.lm_head(params, self.cfg, hidden)[:, 0, :]
        sampled, counts = _sample_step(logits, keys, temps, topks, topps,
                                       minps, counts, fps, pps, rps, biases)
        tops = None if want_top is None else _top_rows(logits)
        return sampled, _token_logprob(logits, sampled), \
            self._repack(state, nc, state["table"], nc["k"][0].lengths), \
            counts, tops

    def _prefill_impl(self, params, tokens, state, slot, pos0, last_idx,
                      key, temp, topk=None, topp=None, minp=None, crow=None,
                      fp=None, pp=None, rp=None, brow=None, want_top=None):
        """Forward the prompt TAIL (tokens past the shared prefix) at
        positions [pos0, pos0+Tpad) through the slot's block-table row.
        Shared prefix blocks are already mapped, so attention sees the
        cached prefix KV without recomputing it."""
        from tpu_llm.models import llama as M

        table_row = jax.lax.dynamic_slice_in_dim(state["table"], slot, 1, 0)
        len_row = jax.lax.dynamic_slice_in_dim(state["lengths"], slot, 1, 0)
        cache = self._layer_caches(state, table_row, len_row)
        hidden, nc = M.forward(params, self.cfg, tokens, cache, pos0,
                               update_fn=_paged_update_fn,
                               attn_fn=_paged_attn_fn)
        last = jax.lax.dynamic_slice_in_dim(hidden, last_idx, 1, axis=1)
        logits = M.lm_head(params, self.cfg, last)[:, 0, :]
        slog = logits if brow is None else logits + brow[None]
        if crow is not None:
            slog = _apply_penalties(slog[0], crow, fp, pp, rp)[None]
        if topk is None:
            sampled = _select_token(slog, key, temp)[0]
        else:
            sampled = filtered_sample(slog[0], key, temp, topk, topp, minp)
        lengths = jax.lax.dynamic_update_slice(
            state["lengths"], nc["k"][0].lengths, (slot,))
        tops = None if want_top is None else _top_rows(logits[0])
        return sampled, _token_logprob(logits[0], sampled), \
            self._repack(state, nc, state["table"], lengths), tops

    def _verify_impl(self, params, tokens, state, offsets, keys, temps,
                     topks=None, topps=None, minps=None, want_top=None):
        """Speculative verify over the paged cache (see BatchEngine).
        Growth in _pre_dispatch maps blocks for every position a draft
        could be ACCEPTED at; rejected/padded window rows beyond the
        mapped region write into the null block, and no used chain entry
        ever attends them (entry j only attends rows <= pos+j, all
        mapped for j within the acceptance bound)."""
        from tpu_llm.models import llama as M

        cache = self._layer_caches(state, state["table"], state["lengths"])
        hidden, nc = M.forward(params, self.cfg, tokens, cache, offsets,
                               update_fn=_paged_update_fn,
                               attn_fn=_paged_attn_fn)
        logits = M.lm_head(params, self.cfg, hidden)        # (B, K+1, V)
        chain = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        sampled0 = _sample_rows(logits[:, 0], keys, temps, topks, topps,
                                minps)
        tops = None if want_top is None else _top_rows(logits)
        return (chain, _token_logprob(logits, chain),
                sampled0, _token_logprob(logits[:, 0], sampled0),
                self._repack(state, nc, state["table"],
                             nc["k"][0].lengths), tops)

    def _prefill_part_impl(self, params, tokens, state, slot, pos0):
        """One non-final CHUNK of a chunked prefill: forward + paged
        cache writes only — no logits, no sampling (chunked prefill
        bounds activation memory to chunk x dim and caps the number of
        compiled prefill programs at full-chunk + one bucketed tail)."""
        from tpu_llm.models import llama as M

        table_row = jax.lax.dynamic_slice_in_dim(state["table"], slot, 1, 0)
        len_row = jax.lax.dynamic_slice_in_dim(state["lengths"], slot, 1, 0)
        cache = self._layer_caches(state, table_row, len_row)
        _, nc = M.forward(params, self.cfg, tokens, cache, pos0,
                          update_fn=_paged_update_fn,
                          attn_fn=_paged_attn_fn)
        lengths = jax.lax.dynamic_update_slice(
            state["lengths"], nc["k"][0].lengths, (slot,))
        return self._repack(state, nc, state["table"], lengths)

    def _set_slot_meta_impl(self, state, slot, row, length):
        """Reset one slot's table row + valid length (admission). A full
        row write — stale entries from the previous occupant would
        otherwise map garbage blocks into the gather once causal masking
        lets positions past the old mapping become visible."""
        return dict(
            state,
            table=jax.lax.dynamic_update_slice(
                state["table"], row[None, :], (slot, jnp.int32(0))),
            lengths=state["lengths"].at[slot].set(length),
        )

    # -- scheduling -------------------------------------------------------

    def _admit(self):
        for idx, slot in enumerate(self.slots):
            if not (slot.free and self._queue):
                continue
            req = self._queue[0]
            bos = [self.bos_id] if self.bos_id >= 0 else []
            input_ids = bos + req.prompt
            n_in = len(input_ids)
            bs = self.block_size

            # hash the prompt's block chain ONCE per admission (match
            # and insert share it — SHA1 over long prompts is host
            # scheduling-path work)
            digs = (PrefixCache.digests(input_ids, bs)
                    if self.prefix is not None else [])
            shared = (self.prefix.match(input_ids, bs, digests=digs)
                      if self.prefix is not None else [])
            n_shared = len(shared) * bs
            n_tail_blocks = math.ceil((n_in - n_shared) / bs)
            # all-or-nothing admission: tail blocks now + a RESERVATION
            # covering worst-case decode growth (last REAL write is at
            # n_in + max_new - 2 — the final sampled token is never
            # forwarded), so growth can never fail mid-decode
            span = n_in + req.max_new - 2
            total_blocks = span // bs + 1
            growth = total_blocks - len(shared) - n_tail_blocks
            try:
                owned = self.allocator.alloc(n_tail_blocks)
                try:
                    self.allocator.reserve(growth)
                except MemoryError:
                    self.allocator.release(owned)
                    raise
            except MemoryError:
                # pool pressure: put the refs back and wait for running
                # requests to finish (their blocks free on completion)
                for b in shared:
                    self.allocator.decref(b)
                if self.n_active == 0:
                    raise MemoryError(
                        f"request needs {n_tail_blocks}+{growth} blocks "
                        f"(+{len(shared)} shared) but the pool can never "
                        f"serve it (free={self.allocator.n_free})")
                return
            self._slot_reserved[idx] = growth
            self._slot_span[idx] = span
            self._queue.pop(0)
            slot.req = req
            slot.key = jax.random.PRNGKey(req.seed)
            blocks = shared + owned
            self._slot_blocks[idx] = blocks

            row = np.zeros((self.max_blocks,), np.int32)
            row[: len(blocks)] = blocks
            self.state = self._set_slot_meta(
                self.state, jnp.int32(idx), jnp.asarray(row),
                jnp.int32(n_shared))

            tail = input_ids[n_shared:]
            off = n_shared
            ck = self.prefill_chunk
            while ck is not None and len(tail) > ck:
                self.state = self._prefill_part(
                    self.params,
                    jnp.asarray(np.asarray(tail[:ck], np.int32)[None, :]),
                    self.state, jnp.int32(idx), jnp.int32(off))
                tail, off = tail[ck:], off + ck
            n_shared = off
            pad_to = min(_next_bucket(len(tail)), self.max_seq)
            toks = np.zeros((1, pad_to), np.int32)
            toks[0, : len(tail)] = np.asarray(tail, np.int32)

            slot.key, sub = jax.random.split(slot.key)
            if _penalized(req) or self._counts is not None:
                self._counts_dirty = True
            if req.logit_bias or self._bias is not None:
                self._bias_dirty = True
            sampled, lp_d, self.state, tops_d = self._prefill(
                self.params, jnp.asarray(toks), self.state, jnp.int32(idx),
                jnp.int32(n_shared), jnp.int32(len(tail) - 1), sub,
                jnp.float32(req.temperature), *_req_filters(req),
                *_prefill_extras(req, self._vocab, input_ids),
            )
            if self._draft is not None:
                dpad = min(_next_bucket(n_in), self.max_seq)
                dtoks = np.zeros((1, dpad), np.int32)
                dtoks[0, :n_in] = np.asarray(input_ids, np.int32)
                self._draft_state = self._draft_prefill(
                    self._draft[0], jnp.asarray(dtoks), self._draft_state,
                    jnp.int32(idx), jnp.int32(n_in - 1))
            if self.prefix is not None:
                self.prefix.insert(input_ids, bs, blocks, digests=digs)
            tok, lp, tops = jax.device_get((sampled, lp_d, tops_d))
            tok = int(tok)
            slot.pos = n_in
            self._token_dev = self._set_lane(
                self._token_dev, jnp.int32(idx), jnp.int32(tok))
            self._record(slot, tok, float(lp),
                         top=None if tops is None else (tops[1], tops[0]))

    def _pre_dispatch(self, live) -> None:
        """Map a fresh block for any slot whose next write position
        crosses into unmapped territory (on-demand growth). With
        speculation, the mapped region must reach every position a draft
        could be accepted at — pos + min(k, remaining-1) — which stays
        within the admission reservation (last budgeted write is
        n_in + max_new - 1)."""
        rows, cols, vals = [], [], []
        for idx, req in live:
            slot = self.slots[idx]
            blocks = self._slot_blocks[idx]
            # clamp to the reserved span: draft-window rows past it are
            # rejected-by-construction (acceptance is budget-bounded) and
            # their writes go to the null block; a stale ``remaining``
            # from the pipelined lag can otherwise push reach past the
            # reservation and trip the allocator's accounting
            reach = min(slot.pos + self.spec_k, self._slot_span[idx])
            while reach // self.block_size >= len(blocks):
                (bid,) = self.allocator.alloc(1, reserved=True)
                self._slot_reserved[idx] -= 1
                rows.append(idx)
                cols.append(len(blocks))
                vals.append(bid)
                blocks.append(bid)
        if rows:
            self.state = dict(
                self.state,
                table=self._set_cells(
                    self.state["table"], jnp.asarray(rows, jnp.int32),
                    jnp.asarray(cols, jnp.int32),
                    jnp.asarray(vals, jnp.int32)),
            )

    def _record(self, slot: _Slot, tok: int, lp=None, top=None):
        req = slot.req
        super()._record(slot, tok, lp, top=top)
        if req is not None and req.done and slot.req is None:
            # identity search: _Slot is a dataclass whose == would compare
            # jax-array fields elementwise
            idx = next(i for i, s in enumerate(self.slots) if s is slot)
            self._release_slot(idx, req)

    def cancel(self, req) -> bool:
        """Retire a paged request immediately, releasing its blocks (and
        registering the KV written so far with the prefix cache — it is
        valid even for a cut-short generation)."""
        for idx, slot in enumerate(self.slots):
            if slot.req is req and not req.done:
                req.done = True
                slot.req = None
                self._release_slot(idx, req)
                return True
        return super().cancel(req)

    def _release_slot(self, idx: int, req) -> None:
        if self.prefix is not None:
            # register the COMPLETED sequence's full blocks (not just
            # the prompt's): a follow-up whose prompt extends this
            # conversation (prompt + completion + ...) reuses the
            # whole turn's KV — the multi-turn/agent case. The final
            # sampled token was never forwarded, so its KV is absent:
            # register only blocks fully inside the written region.
            bos = [self.bos_id] if self.bos_id >= 0 else []
            seq = bos + req.prompt + req.tokens
            self.prefix.insert(seq[:-1], self.block_size,
                               self._slot_blocks[idx])
        self.allocator.release(self._slot_blocks[idx])
        self._slot_blocks[idx] = []
        self.allocator.unreserve(self._slot_reserved[idx])
        self._slot_reserved[idx] = 0
        # Point the dead slot's whole row at the null block: dead
        # rows keep decoding garbage at offset 0 every step (fixed-
        # shape dispatch), and with the stale mapping those writes
        # would land in released — possibly prefix-cached or
        # reallocated — blocks. In the trash block they're inert.
        self.state = self._set_slot_meta(
            self.state, jnp.int32(idx),
            jnp.zeros((self.max_blocks,), jnp.int32), jnp.int32(0))

    # -- introspection ----------------------------------------------------

    @property
    def hbm_blocks_in_use(self) -> int:
        return len(self.allocator.refs)
