"""`llm-server` — online HTTP serving front end (continuous batching).

The reference serves one prompt per process (`llama2.f90:379-402`);
`llm-serve` batches a fixed offline prompt list. This server accepts
requests over HTTP *while decode is running*: a single loop thread owns
the engine (engine scheduling and device dispatch are deliberately
single-threaded) and steps it whenever any slot is live, admitting
network arrivals between steps — iteration-level scheduling extended to
online traffic. stdlib ``http.server`` only: the environment bakes in no
web framework, and the reference's zero-dependency ethos
(`README.md:5`) is worth keeping at the serving layer.

API (JSON over HTTP):

  POST /v1/completions
    {"prompt": str, "max_tokens": int?, "temperature": float?,
     "seed": int?, "stop_at_eos": bool?, "stream": bool?}
    -> {"completion": str, "tokens": [int], "n_tokens": int,
        "ttft_s": float, ...} plus the OpenAI completion fields
    ("id"/"object"/"model"/"choices"/"usage") so off-the-shelf OpenAI
    clients pointed at this server parse the response unchanged.
    With "stream": true the response is ``text/event-stream``: one
    ``data: {"token": id, "text": "...", "choices": [...]}`` event per
    generated token, a terminal ``data: {"done": true, ...}`` event,
    then the OpenAI ``data: [DONE]`` sentinel.

  POST /v1/chat/completions
    {"messages": [{"role": str, "content": str}, ...], ...same knobs}
    — messages are rendered through a chat template (--chat-template:
    "zephyr" = TinyLlama-chat's <|role|> format, "plain" = role: content
    lines) and the reply comes back OpenAI-chat-shaped
    ({"choices": [{"message": {"role": "assistant", ...}}]}).

  GET /v1/models -> OpenAI model list (one entry, the loaded model)
  GET /health -> {"ok": true, "active": n, "queued": n}
  GET /stats  -> uptime, request/token counters, tokens/s, engine kind,
                 prefix-cache hit rate + HBM blocks (paged engine),
                 speculative acceptance (spec mode)

Threading model: HTTP handler threads never touch the engine. They
enqueue (Request, _Tracker) pairs with the loop's condition variable and
wait on the tracker; the loop thread submits, steps the engine, and
publishes per-token events through the tracker (``Request.stream``
callbacks run inside the loop thread's ``engine.step()``). Completion is
signalled once the request's ``done`` flag is set by the engine's
(pipelined, one step lagged) bookkeeping.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


def render_chat_segments(messages, template: str = "zephyr"):
    """Render an OpenAI-style messages list to (text, is_scaffolding)
    segments.

    Scaffolding segments (role headers, turn separators) carry control
    markers that must tokenize to their special-token ids; message-body
    segments are user-supplied and are tokenized WITHOUT special-token
    parsing, so content like ``<|eot_id|>`` or ``</s>`` BPEs to literal
    text instead of control ids (the injection surface llama.cpp's
    all-or-nothing parse_special leaves open).

    "zephyr" is the TinyLlama-1.1B-Chat format (its HF chat_template):
    ``<|role|>\\n{content}</s>\\n`` per message, then the assistant
    header the model completes after. "plain" is a model-agnostic
    fallback: ``role: content`` lines then ``assistant:``."""
    for m in messages:
        if not isinstance(m, dict) or "content" not in m:
            raise ValueError("each message needs role/content")
    segs = []
    if template == "zephyr":
        for m in messages:
            segs.append((f"<|{m.get('role', 'user')}|>\n", True))
            segs.append((m["content"], False))
            segs.append(("</s>\n", True))
        segs.append(("<|assistant|>\n", True))
        return segs
    if template == "plain":
        for m in messages:
            segs.append((f"{m.get('role', 'user')}: ", True))
            segs.append((m["content"], False))
            segs.append(("\n", True))
        segs.append(("assistant:", True))
        return segs
    if template == "llama2":
        # Llama-2-chat: [INST] ... [/INST] turns, system folded into the
        # first user turn inside <<SYS>> markers. llama.cpp renders
        # multi-turn chats as ``<s>[INST] u [/INST] a </s><s>[INST] ...``
        # — each completed assistant turn is closed with EOS and the next
        # user turn opens with a fresh BOS. The FIRST BOS comes from the
        # engine, not the template; the markers here are tokenized to ids
        # by encode(parse_special=True).
        sys_txt = None
        first_user = True
        for m in messages:
            role = m.get("role", "user")
            if role == "system":
                sys_txt = m["content"]
                continue
            if role == "assistant":
                segs.append((" ", True))
                segs.append((m["content"], False))
                segs.append((" </s><s>", True))
                continue
            segs.append(("[INST] ", True))
            if first_user and sys_txt:
                segs.append(("<<SYS>>\n", True))
                segs.append((sys_txt, False))
                segs.append(("\n<</SYS>>\n\n", True))
            segs.append((m["content"], False))
            segs.append((" [/INST]", True))
            first_user = False
        return segs
    if template == "llama3":
        # Llama-3 instruct format: per-turn header markers + <|eot_id|>
        # terminators (BOS <|begin_of_text|> comes from the engine); the
        # markers tokenize to their ids via encode(parse_special=True)
        # and generation stops at <|eot_id|> (stop_token_ids)
        for m in messages:
            segs.append((f"<|start_header_id|>{m.get('role', 'user')}"
                         "<|end_header_id|>\n\n", True))
            segs.append((m["content"], False))
            segs.append(("<|eot_id|>", True))
        segs.append(("<|start_header_id|>assistant<|end_header_id|>\n\n",
                     True))
        return segs
    if template == "chatml":
        # ChatML (qwen2 and friends): <|im_start|>role\ncontent<|im_end|>
        for m in messages:
            segs.append((f"<|im_start|>{m.get('role', 'user')}\n", True))
            segs.append((m["content"], False))
            segs.append(("<|im_end|>\n", True))
        segs.append(("<|im_start|>assistant\n", True))
        return segs
    if template == "gemma":
        # Gemma instruction format: <start_of_turn>user|model turns; the
        # system message (gemma has no system role) folds into the first
        # user turn
        sys_txt = None
        for m in messages:
            role = m.get("role", "user")
            if role == "system":
                sys_txt = m["content"]
                continue
            turn = "model" if role == "assistant" else "user"
            segs.append((f"<start_of_turn>{turn}\n", True))
            if role != "assistant" and sys_txt:
                segs.append((sys_txt, False))
                segs.append(("\n\n", True))
                sys_txt = None
            segs.append((m["content"], False))
            segs.append(("<end_of_turn>\n", True))
        segs.append(("<start_of_turn>model\n", True))
        return segs
    raise ValueError(f"unknown chat template {template!r}")


def render_chat(messages, template: str = "zephyr") -> str:
    """The rendered prompt string (segments joined) — display/tests."""
    return "".join(t for t, _ in render_chat_segments(messages, template))


def encode_chat(tokenizer, messages, template: str = "zephyr"):
    """Tokenize a chat: scaffolding with parse_special=True (control
    markers become their ids), message bodies without (user text cannot
    inject control tokens). BOS is the engine's job, as in render_chat."""
    ids = []
    for text, scaffolding in render_chat_segments(messages, template):
        ids.extend(tokenizer.encode(text, parse_special=scaffolding))
    return ids


class Embedder:
    """/v1/embeddings backend: mean-pooled, L2-normalized final hidden
    states from one prefill forward (no lm_head). Bucketed lengths bound
    the compile count; stateless — safe to dispatch from handler threads
    (it never touches the engine's donated state)."""

    def __init__(self, params, adapter, max_len: int = 512):
        import jax

        self.params = params
        self.adapter = adapter
        self.max_len = max_len
        self._fn = jax.jit(self._impl)

    def _impl(self, params, toks, length):
        import jax.numpy as jnp
        import numpy as np

        state = self.adapter.init_state(1, toks.shape[1])
        hidden, _ = self.adapter.apply(
            params, tokens=toks, state=state, offset=np.int32(0),
            length=length)
        mask = (jnp.arange(toks.shape[1]) < length)[None, :, None]
        pooled = jnp.sum(hidden.astype(jnp.float32) * mask, axis=1) / length
        return pooled / jnp.linalg.norm(pooled, axis=-1, keepdims=True)

    def embed(self, ids):
        import jax.numpy as jnp
        import numpy as np

        from tpu_llm.runtime.engine import _next_bucket

        ids = ids[: self.max_len]
        pad = min(_next_bucket(len(ids)), self.max_len)
        toks = np.zeros((1, pad), np.int32)
        toks[0, : len(ids)] = np.asarray(ids, np.int32)
        out = self._fn(self.params, jnp.asarray(toks),
                       jnp.int32(len(ids)))
        return np.asarray(out)[0]


def _decode_toks(tokenizer, toks) -> str:
    out = tokenizer.decode(toks)
    if isinstance(out, bytes):
        out = out.decode("utf-8", errors="replace")
    return out


class _Tracker:
    """Handler<->loop handshake for one request."""

    def __init__(self, want_stream: bool):
        self.done = threading.Event()
        self.events: Optional[queue.Queue] = queue.Queue() if want_stream else None
        self.error: Optional[str] = None
        self.t_enqueue = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_admit: Optional[float] = None
        # stop-string state (OpenAI `stop`): the scanner runs on the LOOP
        # thread per token; a match records the char offset of the
        # earliest stop occurrence and asks the loop to cancel the request
        self.stop: list = []
        self._scanner = None         # () -> Optional[int] over decoded text
        self.stop_cut: Optional[int] = None
        self.want_cancel = False

    # called on the LOOP thread (from Request.stream)
    def on_token(self, tok: int) -> None:
        if self.t_first is None:
            self.t_first = time.monotonic()
        # scan BEFORE publishing the token, so a streaming consumer that
        # dequeues it observes stop_cut no later than the matching token
        if self._scanner is not None and self.stop_cut is None:
            cut = self._scanner()
            if cut is not None:
                self.stop_cut = cut
                self.want_cancel = True
        if self.events is not None:
            self.events.put(tok)

    def finish(self, error: Optional[str] = None) -> None:
        self.error = error
        if self.events is not None:
            self.events.put(None)        # stream sentinel
        self.done.set()


class ServingLoop(threading.Thread):
    """Owns the engine. The only thread that calls submit/step/_collect."""

    daemon = True

    def __init__(self, engine, max_queue: int = 256):
        super().__init__(name="llm-serving-loop")
        self.engine = engine
        self.max_queue = max_queue
        self._cv = threading.Condition()
        self._pending = []           # [(Request, _Tracker)]
        self._tracked = {}           # rid -> (Request, _Tracker)
        self._stopping = False
        self.t0 = time.monotonic()
        self.n_requests = 0
        self.n_completed = 0
        self.n_tokens = 0
        self.n_restarts = 0

    # -- handler-thread API -------------------------------------------------

    def enqueue(self, req, tracker: _Tracker) -> bool:
        """Queue a request for the loop thread. False if at capacity."""
        with self._cv:
            if self._stopping:
                return False
            if len(self._pending) + len(self.engine._queue) >= self.max_queue:
                return False
            self._pending.append((req, tracker))
            self.n_requests += 1
            self._cv.notify()
        return True

    def shutdown(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify()
        self.join(timeout=30)

    def snapshot(self) -> dict:
        eng = self.engine
        out = {
            "uptime_s": round(time.monotonic() - self.t0, 1),
            "requests": self.n_requests,
            "completed": self.n_completed,
            "active": eng.n_active,
            "queued": len(eng._queue) + len(self._pending),
            "generated_tokens": self.n_tokens,
            "engine": type(eng).__name__,
        }
        if self.n_restarts:
            out["engine_restarts"] = self.n_restarts
        stats = getattr(eng, "stats", None)
        if stats and stats.get("spec_forwards"):
            out["spec_tokens_per_forward"] = round(
                stats["spec_tokens"] / stats["spec_forwards"], 2)
        prefix = getattr(eng, "prefix", None)
        if prefix is not None and prefix.queries:
            out["prefix_cache_hit_rate"] = round(
                prefix.hits / prefix.queries, 3)
            out["hbm_blocks_in_use"] = eng.hbm_blocks_in_use
        return out

    # -- loop thread ---------------------------------------------------------

    def run(self) -> None:
        eng = self.engine
        while True:
            with self._cv:
                while (not self._stopping and not self._pending
                       and not (eng._queue or eng.n_active)):
                    self._cv.wait(timeout=0.25)
                if self._stopping and not (
                        self._pending or eng._queue or eng.n_active):
                    return
                pending, self._pending = self._pending, []
            for req, tr in pending:
                try:
                    eng.submit(req)
                except (ValueError, MemoryError) as e:
                    tr.finish(error=str(e))
                    continue
                self._tracked[req.rid] = (req, tr)
            # stop-string matches recorded by the token callbacks: cancel
            # between steps (the engine is only touched from this thread)
            for rid, (req, tr) in list(self._tracked.items()):
                if tr.want_cancel and not req.done:
                    eng.cancel(req)
            if eng._queue or eng.n_active:
                try:
                    eng.step()
                except MemoryError as e:
                    # admission can never fit: fail every queued request
                    # rather than spin (running slots keep decoding)
                    for req in list(eng._queue):
                        tr = self._tracked.pop(req.rid, (None, None))[1]
                        eng._queue.remove(req)
                        if tr:
                            tr.finish(error=str(e))
                except Exception as e:     # noqa: BLE001 — recovery path
                    self._restart(e)
                if not (eng._queue or eng.n_active):
                    eng._collect()   # flush the pipelined last step
            self._reap()

    def _restart(self, exc: BaseException) -> None:
        """Engine-step crash recovery (SURVEY §5): fail every in-flight
        and queued request LOUDLY, then rebuild all decode state from
        the stateless weight store (engine.reset()) so serving resumes
        instead of dying. Donated buffers may be invalid after a failed
        step — nothing survives except params."""
        import sys
        import traceback

        self.n_restarts += 1
        print(f"[llm-server] engine step crashed ({exc!r}); restarting "
              f"engine (#{self.n_restarts})", file=sys.stderr, flush=True)
        traceback.print_exc(file=sys.stderr)
        eng = self.engine
        msg = f"engine restarted after internal error: {exc}"
        for rid, (req, tr) in list(self._tracked.items()):
            req.done = True
            tr.finish(error=msg)
            self._tracked.pop(rid, None)
        try:
            eng.reset()
        except Exception as e2:          # noqa: BLE001
            # unrecoverable (e.g. device gone): stop the loop loudly
            print(f"[llm-server] engine reset failed: {e2!r}; serving "
                  f"loop stopping", file=sys.stderr, flush=True)
            with self._cv:
                self._stopping = True
            raise

    def _reap(self) -> None:
        done = [rid for rid, (req, _) in self._tracked.items() if req.done]
        for rid in done:
            req, tr = self._tracked.pop(rid)
            self.n_completed += 1
            self.n_tokens += len(req.tokens)
            tr.finish()


def make_handler(loop: ServingLoop, tokenizer, max_new_cap: int,
                 request_timeout_s: float = 600.0,
                 model_name: str = "tpu-llm",
                 chat_template: str = "zephyr",
                 embedder: Optional["Embedder"] = None):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # server identity stays generic; clients key on the JSON body
        server_version = "llm-server"

        def log_message(self, fmt, *args):  # stderr chatter off by default
            if loop_verbose:
                sys.stderr.write("%s - %s\n" % (self.address_string(),
                                                fmt % args))

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _embeddings(self):
            if embedder is None:
                self._json(501, {"error": "embeddings not enabled"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                inputs = body["input"]
                if isinstance(inputs, str):
                    inputs = [inputs]
                if not inputs or not all(
                        isinstance(s, str) and s for s in inputs):
                    raise ValueError("input must be a non-empty string "
                                     "or list of strings")
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            data = []
            n_tok = 0
            for i, text in enumerate(inputs[:64]):
                ids = tokenizer.encode(text)
                n_tok += len(ids)
                vec = embedder.embed(ids)
                data.append({"object": "embedding", "index": i,
                             "embedding": [round(float(x), 7)
                                           for x in vec]})
            self._json(200, {
                "object": "list", "data": data, "model": model_name,
                "usage": {"prompt_tokens": n_tok, "total_tokens": n_tok}})

        def do_GET(self):
            if self.path == "/health":
                snap = loop.snapshot()
                self._json(200, {"ok": True, "active": snap["active"],
                                 "queued": snap["queued"]})
            elif self.path == "/stats":
                self._json(200, loop.snapshot())
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [{
                    "id": model_name, "object": "model",
                    "owned_by": "tpu-llm"}]})
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path == "/v1/embeddings":
                self._embeddings()
                return
            chat = self.path == "/v1/chat/completions"
            if not chat and self.path not in ("/v1/completions",
                                              "/completions"):
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if chat:
                    prompt = render_chat(body["messages"],
                                         body.get("chat_template",
                                                  chat_template))
                else:
                    prompt = body["prompt"]
                if not isinstance(prompt, str) or not prompt:
                    raise ValueError(
                        "messages must render to a non-empty prompt"
                        if chat else "prompt must be a non-empty string")
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return

            from tpu_llm.runtime.batching import Request

            want_stream = bool(body.get("stream", False))
            n_choices = max(1, min(int(body.get("n", 1)), 8))
            if want_stream and n_choices > 1:
                self._json(400, {"error": "n > 1 with stream=true is "
                                          "not supported"})
                return
            stop = body.get("stop") or []
            if isinstance(stop, str):
                stop = [stop]
            stop = [s for s in stop if isinstance(s, str) and s][:4]
            lp_field = body.get("logprobs")
            if chat:
                if body.get("top_logprobs") is not None and not lp_field:
                    # OpenAI contract: chat top_logprobs requires
                    # "logprobs": true
                    self._json(400, {"error": "top_logprobs requires "
                                              "logprobs: true"})
                    return
                want_lp = bool(lp_field)
                want_top_n = int(body.get("top_logprobs") or 0)
            else:
                if isinstance(lp_field, bool):
                    want_lp, want_top_n = lp_field, 0
                elif lp_field is None:
                    want_lp, want_top_n = False, 0
                else:   # int, 0 included: chosen-token logprobs on
                    want_lp, want_top_n = True, int(lp_field)
            if chat:
                # template scaffolding carries control markers (</s>,
                # <|user|>) that must become their token ids; message
                # bodies are tokenized WITHOUT special parsing so user
                # content cannot inject control tokens (encode_chat);
                # raw completion prompts stay unparsed for the same reason
                prompt_ids = encode_chat(
                    tokenizer, body["messages"],
                    body.get("chat_template", chat_template))
            else:
                prompt_ids = tokenizer.encode(prompt)
            # end-of-generation markers beyond the model EOS (llama.cpp's
            # EOG set): llama-3 <|eot_id|>, chatml <|im_end|>, gemma
            # <end_of_turn> — chat replies stop at whichever the vocab has
            eog = [tid for t, tid in
                   getattr(tokenizer, "special", {}).items()
                   if t in (b"<|eot_id|>", b"<|im_end|>", b"<|end|>",
                            b"<end_of_turn>")]
            pairs = []
            for ci in range(n_choices):
                tracker = _Tracker(want_stream)
                req = Request(
                    prompt=prompt_ids,
                    max_new=min(int(body.get("max_tokens", 64)),
                                max_new_cap),
                    temperature=float(body.get("temperature", 0.0)),
                    # n identical greedy choices would be pointless; each
                    # extra choice gets its own sampling stream
                    seed=int(body.get("seed", 0)) + ci,
                    # chat replies should stop at </s> like any chat server
                    stop_at_eos=bool(body.get("stop_at_eos", chat)),
                    stop_token_ids=(eog or None) if chat else None,
                    top_k=int(body.get("top_k", 0)),
                    top_p=float(body.get("top_p", 1.0)),
                    min_p=float(body.get("min_p", 0.0)),
                    # OpenAI penalty fields (+ HF-style repetition_penalty
                    # as an extension)
                    frequency_penalty=float(body.get("frequency_penalty", 0.0)),
                    presence_penalty=float(body.get("presence_penalty", 0.0)),
                    repetition_penalty=float(
                        body.get("repetition_penalty", 1.0)),
                    logit_bias=(body.get("logit_bias")
                                if isinstance(body.get("logit_bias"), dict)
                                else None),
                    # completions: logprobs is an int N >= 0 (OpenAI: N=0
                    # still returns tokens/token_logprobs, just no top
                    # alternatives); bool true = chosen-token-only, a
                    # native extension. chat: logprobs is the OpenAI bool
                    # + top_logprobs N (validated above). Cap at the
                    # compiled top-k width (20, the OpenAI chat max).
                    logprobs=want_lp,
                    top_logprobs=min(want_top_n, 20),
                    stream=tracker.on_token,
                )
                if stop:
                    tracker.stop = stop

                    def _scan(req=req, stop=stop):
                        text = _decode_toks(tokenizer, req.tokens)
                        best = None
                        for s in stop:
                            i = text.find(s)
                            if i >= 0 and (best is None or i < best):
                                best = i
                        return best

                    tracker._scanner = _scan
                pairs.append((req, tracker))
            for req, tracker in pairs:
                if not loop.enqueue(req, tracker):
                    self._json(503, {"error": "server at capacity"})
                    return
            if want_stream:
                self._stream_response(pairs[0][0], pairs[0][1], chat)
            else:
                self._block_response(pairs, chat,
                                     echo=bool(body.get("echo", False)),
                                     prompt_text=prompt)

        def _finish_reason(self, req) -> str:
            if (req.stop_at_eos and req.tokens
                    and req.tokens[-1] == getattr(loop.engine, "eos_id", -1)):
                return "stop"
            return "length"

        def _visible_tokens(self, req) -> list:
            """Generated tokens minus the trailing stop token.

            The engine appends the EOS id to ``req.tokens`` before
            retiring; OpenAI clients expect ``content`` without the stop
            token and ``completion_tokens`` not to count it."""
            if self._finish_reason(req) == "stop":
                return req.tokens[:-1]
            return req.tokens

        def _n_prompt(self, req) -> int:
            # count the BOS the engine prepends at admission
            n_bos = 1 if getattr(loop.engine, "bos_id", -1) >= 0 else 0
            return len(req.prompt) + n_bos

        def _decode(self, toks) -> str:
            out = tokenizer.decode(toks)
            if isinstance(out, bytes):
                out = out.decode("utf-8", errors="replace")
            return out

        def _finish_one(self, req, tracker: _Tracker):
            """Visible tokens / text / finish_reason for one completed
            request, stop-string truncation applied."""
            vis = self._visible_tokens(req)
            text = self._decode(vis)
            finish = self._finish_reason(req)
            if tracker.stop_cut is not None:
                # cut at the earliest stop-string match: text at the char
                # offset, tokens at the smallest prefix covering it
                finish = "stop"
                cut = tracker.stop_cut
                n = 0
                while n < len(vis) and len(self._decode(vis[:n])) < cut:
                    n += 1
                vis = vis[:n]
                text = self._decode(vis)[:cut]
            return vis, text, finish

        def _block_response(self, pairs, chat: bool = False,
                            echo: bool = False,
                            prompt_text: str = "") -> None:
            deadline = time.monotonic() + request_timeout_s
            for req, tracker in pairs:
                left = max(0.0, deadline - time.monotonic())
                if not tracker.done.wait(timeout=left):
                    self._json(504, {"error": "generation timed out"})
                    return
                if tracker.error is not None:
                    self._json(400, {"error": tracker.error})
                    return
            req0, tracker0 = pairs[0]
            ttft = ((tracker0.t_first or time.monotonic())
                    - tracker0.t_enqueue)
            choices = []
            total_completion = 0
            vis0 = text0 = None
            for i, (req, tracker) in enumerate(pairs):
                vis, text, finish = self._finish_one(req, tracker)
                if i == 0:
                    vis0, text0 = vis, text
                total_completion += len(vis)
                if echo and not chat:
                    text = prompt_text + text
                if chat:
                    choice = {"index": i, "finish_reason": finish,
                              "message": {"role": "assistant",
                                          "content": text}}
                else:
                    choice = {"index": i, "finish_reason": finish,
                              "text": text}
                if req.logprobs or req.top_logprobs > 0:
                    lps = req.token_logprobs[:len(vis)]
                    tops = req.top_ids[:len(vis)]
                    top_lps = req.top_lps[:len(vis)]
                    if chat:
                        content = []
                        for j, t in enumerate(vis):
                            entry = {"token": self._decode([t]),
                                     "logprob": round(lps[j], 6)
                                     if j < len(lps) else None}
                            if j < len(tops):
                                entry["top_logprobs"] = [
                                    {"token": self._decode([ti]),
                                     "logprob": round(tl, 6)}
                                    for ti, tl in zip(tops[j], top_lps[j])]
                            content.append(entry)
                        choice["logprobs"] = {"content": content}
                    else:
                        lp_obj = {
                            "tokens": [self._decode([t]) for t in vis],
                            "token_logprobs": [round(x, 6) for x in lps],
                        }
                        if req.top_logprobs > 0:
                            lp_obj["top_logprobs"] = [
                                {self._decode([ti]): round(tl, 6)
                                 for ti, tl in zip(ids, ls)}
                                for ids, ls in zip(tops, top_lps)]
                            offs, acc = [], 0
                            for t in vis:
                                offs.append(acc)
                                acc += len(self._decode([t]))
                            lp_obj["text_offset"] = offs
                        choice["logprobs"] = lp_obj
                choices.append(choice)
            self._json(200, {
                # native fields (tests, llm-serve parity): first choice
                "completion": text0,
                "tokens": vis0,
                "n_tokens": len(vis0),
                "ttft_s": round(ttft, 4),
                # OpenAI-compatible superset
                "id": f"{'chatcmpl' if chat else 'cmpl'}-{req0.rid}",
                "object": ("chat.completion" if chat else "text_completion"),
                "created": int(time.time()),
                "model": model_name,
                "choices": choices,
                "usage": {"prompt_tokens": self._n_prompt(req0),
                          "completion_tokens": total_completion,
                          "total_tokens": (self._n_prompt(req0)
                                           + total_completion)},
            })

        def _stream_response(self, req, tracker: _Tracker,
                             chat: bool = False) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            # SSE has no predeclared length; chunked framing keeps
            # HTTP/1.1 keep-alive semantics honest
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes) -> None:
                self.wfile.write(f"{len(data):X}\r\n".encode())
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()

            deadline = time.monotonic() + request_timeout_s
            sent = 0        # tokens consumed from the queue
            epos = 0        # chars of decoded text already emitted
            first = True
            stop_hit = False
            eos_id = getattr(loop.engine, "eos_id", -1)
            stops = tracker.stop

            def emit(tok, delta):
                nonlocal first
                if chat:
                    # OpenAI SDKs expect role in the first chat delta
                    d = ({"role": "assistant", "content": delta}
                         if first else {"content": delta})
                    choice = {"index": 0, "finish_reason": None, "delta": d}
                else:
                    choice = {"index": 0, "finish_reason": None,
                              "text": delta}
                if ((req.logprobs or req.top_logprobs > 0) and tok is not None
                        and sent <= len(req.token_logprobs)):
                    # per-chunk logprob of the token that produced this
                    # delta (+ top alternatives when requested)
                    j = sent - 1
                    lp = round(req.token_logprobs[j], 6)
                    tok_s = self._decode([tok])
                    if chat:
                        entry = {"token": tok_s, "logprob": lp}
                        if j < len(req.top_ids):
                            entry["top_logprobs"] = [
                                {"token": self._decode([ti]),
                                 "logprob": round(tl, 6)}
                                for ti, tl in zip(req.top_ids[j],
                                                  req.top_lps[j])]
                        choice["logprobs"] = {"content": [entry]}
                    else:
                        lp_obj = {"tokens": [tok_s], "token_logprobs": [lp]}
                        if j < len(req.top_ids):
                            lp_obj["top_logprobs"] = [
                                {self._decode([ti]): round(tl, 6)
                                 for ti, tl in zip(req.top_ids[j],
                                                   req.top_lps[j])}]
                        choice["logprobs"] = lp_obj
                first = False
                ev = {"token": tok, "text": delta,
                      "id": f"{'chatcmpl' if chat else 'cmpl'}-{req.rid}",
                      "model": model_name,
                      "object": ("chat.completion.chunk" if chat
                                 else "text_completion"),
                      "choices": [choice]}
                chunk(b"data: " + json.dumps(ev).encode() + b"\n\n")

            try:
                while True:
                    try:
                        tok = tracker.events.get(timeout=1.0)
                    except queue.Empty:
                        if time.monotonic() > deadline:
                            break
                        continue
                    if tok is None:
                        break
                    sent += 1
                    if req.stop_at_eos and tok == eos_id:
                        continue  # stop token is not content (ADVICE r2)
                    # decode incrementally against the full prefix so
                    # multi-token UTF-8/whitespace merges stay byte-exact
                    full = self._decode(req.tokens[:sent])
                    # stop strings: emit up to the earliest match and end
                    cut = None
                    for s in stops:
                        i = full.find(s)
                        if i >= 0 and (cut is None or i < cut):
                            cut = i
                    if cut is not None:
                        stop_hit = True
                        if cut > epos:
                            emit(tok, full[epos:cut])
                            epos = cut
                        break
                    # hold back any suffix that could grow into a stop
                    # match with the next token
                    hold = 0
                    for s in stops:
                        m = min(len(s) - 1, len(full))
                        for k in range(m, 0, -1):
                            if full.endswith(s[:k]):
                                hold = max(hold, k)
                                break
                    new_end = max(epos, len(full) - hold)
                    delta = full[epos:new_end]
                    if delta or first:
                        emit(tok, delta)
                        epos = new_end
                if not stop_hit and tracker.stop_cut is None:
                    # flush text the holdback withheld (generation ended
                    # without the potential match completing)
                    full = self._decode(self._visible_tokens(req))
                    if len(full) > epos:
                        emit(None, full[epos:])
                n_vis = len(self._visible_tokens(req))
                finish = self._finish_reason(req)
                if stop_hit or tracker.stop_cut is not None:
                    finish = "stop"
                    n_vis = min(n_vis, sent)
                fin = {"done": True,
                       "n_tokens": n_vis,
                       "choices": [{"index": 0,
                                    "finish_reason": finish,
                                    **({"delta": {}} if chat
                                       else {"text": ""})}]}
                if tracker.error is not None:
                    fin["error"] = tracker.error
                chunk(b"data: " + json.dumps(fin).encode() + b"\n\n")
                chunk(b"data: [DONE]\n\n")   # OpenAI stream sentinel
                chunk(b"")                   # terminal chunk
            except (BrokenPipeError, ConnectionResetError):
                pass                         # client went away mid-stream

    loop_verbose = False
    return Handler


def build_parser() -> argparse.ArgumentParser:
    from tpu_llm.runtime.serve_cli import build_parser as offline_parser

    p = argparse.ArgumentParser(
        prog="llm-server", description=__doc__,
        parents=[offline_parser()], add_help=False, conflict_handler="resolve")
    p.add_argument("-h", "--help", action="help")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-queue", type=int, default=256,
                   help="503 beyond this many waiting requests")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="per-request generation timeout (s)")
    p.add_argument("--chat-template", default="zephyr",
                   choices=["zephyr", "plain", "llama2", "llama3", "chatml",
                            "gemma"],
                   help="messages rendering for /v1/chat/completions "
                        "(zephyr = TinyLlama-chat, llama2 = [INST] turns, "
                        "llama3 = header_id turns + <|eot_id|> stops, "
                        "chatml = qwen2, gemma = start_of_turn turns)")
    p.add_argument("--served-model-name", default=None,
                   help="model id reported by /v1/models and responses "
                        "(default: the model file's basename)")
    return p


def serve(engine, tokenizer, host: str, port: int, *, max_queue: int = 256,
          max_new_cap: int = 4096, timeout_s: float = 600.0,
          model_name: str = "tpu-llm", chat_template: str = "zephyr",
          embedder: Optional[Embedder] = None):
    """Start the loop thread + HTTP server. Returns (server, loop);
    caller runs server.serve_forever() (or uses it from tests)."""
    loop = ServingLoop(engine, max_queue=max_queue)
    loop.start()
    handler = make_handler(loop, tokenizer, max_new_cap, timeout_s,
                           model_name=model_name,
                           chat_template=chat_template, embedder=embedder)
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    return httpd, loop


def main(argv=None) -> int:
    import os

    from tpu_llm.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    from tpu_llm.runtime.serve_cli import _load, make_engine

    params, cfg, tokenizer = _load(args)
    ctx_cap = getattr(cfg, "seq_len", 4096)
    max_seq = args.max_seq or min(ctx_cap, 1024)
    if args.paged and max_seq > 256 and max_seq % 256:
        max_seq = min(-(-max_seq // 256) * 256, ctx_cap)
    is_mamba = args.model.endswith(".bin")
    engine = make_engine(args, params, cfg, tokenizer, max_seq,
                         is_mamba=is_mamba)
    from tpu_llm.runtime.engine import ModelAdapter

    emb_adapter = (ModelAdapter.mamba(cfg) if is_mamba
                   else ModelAdapter.llama(
                       cfg, stacked=not isinstance(
                           engine.params.get("layers"), (list, tuple))))
    embedder = Embedder(engine.params, emb_adapter,
                        max_len=min(max_seq, 512))
    # cap per-request budgets to what the context can actually hold
    max_new_cap = max(1, max_seq - 2)
    model_name = args.served_model_name or os.path.basename(args.model)
    httpd, loop = serve(engine, tokenizer, args.host, args.port,
                        max_queue=args.max_queue, max_new_cap=max_new_cap,
                        timeout_s=args.timeout, model_name=model_name,
                        chat_template=args.chat_template,
                        embedder=embedder)
    print(f"llm-server listening on http://{args.host}:{args.port} "
          f"(engine={type(engine).__name__}, slots={args.batch}, "
          f"max_seq={max_seq})", file=sys.stderr, flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        loop.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
