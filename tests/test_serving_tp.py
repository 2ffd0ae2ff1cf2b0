"""Serving engines on a device mesh (SURVEY.md §7 step 5).

shard_engine places BatchEngine/PagedEngine params + KV state under the
TP/DP GSPMD specs; the jitted host-loop steps then partition like the
single-stream --tp path. Parity is asserted against the unsharded engines
on the 8-virtual-device CPU mesh (tests/conftest.py).
"""

import numpy as np
import pytest

from tests.test_batching import setup, single_stream_tokens
from tests.test_llama import CFG, make_weights, to_params
from tpu_llm.config import LlamaConfig
from tpu_llm.parallel import make_mesh
from tpu_llm.parallel.serving import shard_engine
from tpu_llm.runtime.batching import BatchEngine, Request
from tpu_llm.runtime.engine import ModelAdapter

PROMPTS = [[5, 11], [3, 9, 2], [7], [4, 4, 8, 2]]
N_NEW = [6, 5, 7, 4]


def _reqs():
    return [Request(prompt=list(p), max_new=n)
            for p, n in zip(PROMPTS, N_NEW)]


def _run(eng):
    rs = [eng.submit(r) for r in _reqs()]
    eng.run()
    return [r.tokens for r in rs]


@pytest.mark.parametrize("tp,dp", [(2, 1), (2, 2)])
def test_batch_engine_tp_matches_unsharded(tp, dp):
    params = to_params(make_weights(0))
    cfg = LlamaConfig(**CFG)
    adapter = ModelAdapter.llama(cfg, bos_id=1)
    plain = BatchEngine(params, adapter, batch=4, max_seq=CFG["seq_len"])
    ref = _run(plain)

    mesh = make_mesh(data=dp, model=tp)
    adapter2 = ModelAdapter.llama(cfg, bos_id=1)
    eng = BatchEngine(params, adapter2, batch=4, max_seq=CFG["seq_len"])
    eng = shard_engine(eng, cfg, mesh)
    assert eng.mesh is mesh
    got = _run(eng)
    assert got == ref


def test_batch_engine_tp_sampled_and_staggered():
    """Sampling determinism and slot reuse survive the mesh placement."""
    params = to_params(make_weights(1))
    cfg = LlamaConfig(**CFG)
    plain = BatchEngine(params, ModelAdapter.llama(cfg, bos_id=1),
                        batch=2, max_seq=CFG["seq_len"])
    eng = shard_engine(
        BatchEngine(params, ModelAdapter.llama(cfg, bos_id=1),
                    batch=2, max_seq=CFG["seq_len"]),
        cfg, make_mesh(data=1, model=2))
    reqs = [Request(prompt=[5, 11], max_new=4, temperature=0.8, seed=7),
            Request(prompt=[3], max_new=6),
            Request(prompt=[9, 2], max_new=3, temperature=0.5, seed=1)]
    clone = [Request(**{f: getattr(r, f) for f in
                        ("prompt", "max_new", "temperature", "seed")})
             for r in reqs]
    rp = [plain.submit(r) for r in clone]
    rs = [eng.submit(r) for r in reqs]
    plain.run()
    eng.run()
    for a, b in zip(rp, rs):
        assert a.tokens == b.tokens


def test_paged_engine_tp_matches_unsharded():
    from tpu_llm.runtime.paged_engine import PagedEngine

    params = to_params(make_weights(0))
    cfg = LlamaConfig(**CFG)
    kw = dict(batch=4, n_blocks=64, block_size=4, max_seq=CFG["seq_len"],
              bos_id=1)
    plain = PagedEngine(params, cfg, **kw)
    ref = _run(plain)

    eng = shard_engine(PagedEngine(params, cfg, **kw), cfg,
                       make_mesh(data=1, model=2))
    got = _run(eng)
    assert got == ref


def test_serve_cli_tp(tmp_path, capsys):
    """llm-serve --tp 2 decodes byte-identically to the unsharded run."""
    import json

    from tests.make_tiny_gguf import build
    from tpu_llm.runtime.serve_cli import main

    path = str(tmp_path / "tiny.gguf")
    build(path)
    base = ["-m", path, "-p", "abc", "-p", "ab", "-n", "6", "--batch", "2"]

    def run(argv):
        capsys.readouterr()
        assert main(argv) == 0
        out = capsys.readouterr().out.strip().splitlines()
        return [json.loads(ln) for ln in out if ln.startswith("{")]

    plain = run(base)
    tp = run(base + ["--tp", "2"])
    assert [r["completion"] for r in plain] == [r["completion"] for r in tp]
    paged_tp = run(base + ["--paged", "--block-size", "4", "--tp", "2"])
    assert ([r["completion"] for r in paged_tp]
            == [r["completion"] for r in plain])


def test_shard_engine_validates_degrees():
    params = to_params(make_weights(0))
    cfg = LlamaConfig(**CFG)          # 2 kv heads
    eng = BatchEngine(params, ModelAdapter.llama(cfg, bos_id=1),
                      batch=4, max_seq=CFG["seq_len"])
    with pytest.raises(ValueError, match="n_kv_heads"):
        shard_engine(eng, cfg, make_mesh(data=1, model=4))
    eng2 = BatchEngine(params, ModelAdapter.llama(cfg, bos_id=1),
                       batch=3, max_seq=CFG["seq_len"])
    with pytest.raises(ValueError, match="batch"):
        shard_engine(eng2, cfg, make_mesh(data=2, model=2))


def test_serve_cli_tp_validation(tmp_path):
    from tests.make_tiny_gguf import build
    from tpu_llm.runtime.serve_cli import main

    path = str(tmp_path / "tiny.gguf")
    build(path)
    # main catches the SystemExit and returns nonzero
    assert main(["-m", path, "-p", "a", "--batch", "3", "--dp", "2"]) == 1


def test_http_server_under_tp(tmp_path):
    """Real-socket llm-server with a tp=2-sharded engine: HTTP completions
    match the unsharded engine's greedy stream."""
    import json
    import threading
    import urllib.request
    from argparse import Namespace

    from tests.make_tiny_gguf import build
    from tpu_llm.io.gguf import GGUFFile
    from tpu_llm.models.llama import load_gguf
    from tpu_llm.runtime.serve_cli import make_engine
    from tpu_llm.runtime.server import serve
    from tpu_llm.tokenizers.bpe import BPETokenizer

    path = str(tmp_path / "tiny.gguf")
    build(path)
    gguf = GGUFFile(path)
    params, cfg = load_gguf(gguf)
    tokenizer = BPETokenizer.from_gguf(gguf)
    args = Namespace(paged=False, cache_dtype="f32", batch=2, spec=0,
                     block_size=None, n_blocks=None, tp=2, dp=1)
    engine = make_engine(args, params, cfg, tokenizer, max_seq=64)
    assert engine.mesh is not None
    httpd, loop = serve(engine, tokenizer, "127.0.0.1", 0, max_new_cap=16)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions",
            data=json.dumps({"prompt": "abc", "max_tokens": 5}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        httpd.shutdown()
        loop.shutdown()

    plain = BatchEngine(params, ModelAdapter.llama(cfg, bos_id=1),
                        batch=2, max_seq=64)
    from tests.make_tiny_gguf import build as _  # noqa: F401
    from tpu_llm.runtime.batching import Request as Rq

    ref = plain.submit(Rq(prompt=tokenizer.encode("abc"), max_new=5))
    plain.run()
    assert out["tokens"] == ref.tokens


def test_batch_engine_tp_quantized_params():
    """QTensor params through the shard_map TP adapter: per-shard fused
    kernels on the GPU, plane-wise sharding everywhere — parity with the
    unsharded quantized engine."""
    from tpu_llm.quant.convert_params import quantize_llama_params

    # col-parallel projections + classifier only: the toy hidden_dim
    # (48) is not a multiple of the 32-wide q4_0 block, and the toy
    # wo's K=32 gives a 1-row scales plane that can't row-shard by 2
    # (real models have K/32 >> tp)
    params = quantize_llama_params(
        to_params(make_weights(0)), "q4_0",
        layer_keys=("wq", "wk", "wv"))
    cfg = LlamaConfig(**CFG)
    plain = BatchEngine(params, ModelAdapter.llama(cfg, bos_id=1),
                        batch=4, max_seq=CFG["seq_len"])
    ref = _run(plain)

    eng = BatchEngine(params, ModelAdapter.llama(cfg, bos_id=1),
                      batch=4, max_seq=CFG["seq_len"])
    eng = shard_engine(eng, cfg, make_mesh(data=1, model=2))
    # the dense stacked llama engine takes the shard_map TP adapter
    assert eng.adapter is not plain.adapter
    got = _run(eng)
    assert got == ref


def test_two_model_spec_under_mesh():
    """llm-serve --tp 2 --spec K --draft equivalent: the draft's params
    and dense state get their own placement (shard_engine draft_cfg) and
    the greedy stream matches the unsharded spec engine exactly."""
    params = to_params(make_weights(0))
    cfg = LlamaConfig(**CFG)

    def mk(draft):
        return BatchEngine(params, ModelAdapter.llama(cfg, bos_id=1),
                           batch=2, max_seq=CFG["seq_len"],
                           speculative_k=3, draft=draft)

    def draft():
        return (to_params(make_weights(3)),
                ModelAdapter.llama(cfg, bos_id=1))

    plain = mk(draft())
    ref = _run2 = [plain.submit(Request(prompt=[5, 11], max_new=8)),
                   plain.submit(Request(prompt=[3, 9, 2], max_new=6))]
    plain.run()
    ref = [r.tokens for r in _run2]

    eng = mk(draft())
    eng = shard_engine(eng, cfg, make_mesh(data=1, model=2),
                       draft_cfg=cfg)
    rs = [eng.submit(Request(prompt=[5, 11], max_new=8)),
          eng.submit(Request(prompt=[3, 9, 2], max_new=6))]
    eng.run()
    assert [r.tokens for r in rs] == ref
    assert eng.stats["spec_forwards"] > 0


def test_mesh_draft_without_cfg_still_raises():
    params = to_params(make_weights(0))
    cfg = LlamaConfig(**CFG)
    eng = BatchEngine(params, ModelAdapter.llama(cfg, bos_id=1),
                      batch=2, max_seq=CFG["seq_len"], speculative_k=3,
                      draft=(to_params(make_weights(3)),
                             ModelAdapter.llama(cfg, bos_id=1)))
    with pytest.raises(NotImplementedError, match="draft_cfg"):
        shard_engine(eng, cfg, make_mesh(data=1, model=2))
