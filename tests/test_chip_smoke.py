"""CPU rehearsal of chip_smoke.py's phases at tiny widths: the kernels in
interpret mode against their references, the CLI and the in-process
server end to end, and the f32 oracle check. The script itself refuses
to run without a GPU."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from tpu_llm.config import LlamaConfig  # noqa: E402

TINY = LlamaConfig(dim=128, hidden_dim=192, n_layers=2, n_heads=4,
                   n_kv_heads=2, vocab_size=256, seq_len=64)


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("smoke") / "tiny.gguf")
    cs.write_llama_gguf(path, TINY, seed=0, context=512)
    return path


def test_kernel_parity_phase_interpret():
    rows = cs.kernel_parity(TINY, seed=0, interpret=True)
    assert rows and all(r["ok"] for r in rows)
    assert {r["kernel"].split()[0] for r in rows} == {
        "qmatmul", "decode_attention", "paged_decode_attention",
        "prefill_attention"}


def test_end_to_end_phase(tiny_gguf):
    res = cs.end_to_end(tiny_gguf, seed=0, long_words=300, max_new=4,
                        long_ctx=512)
    assert res["llm_step"]["text"] == res["llm_scan"]["text"]
    assert res["llm_long"]["prompt_tokens"] >= 300
    assert len(res["llm_long_int8"]["text"]) > 0
    assert all(c > 0 for c in res["server_dense"])
    assert res["server_paged_bf16"] > 0 and res["server_paged_int8"] > 0


def test_f32_oracle_phase(tmp_path):
    seq = cs.f32_against_oracle(str(tmp_path), n_new=4)
    assert len(seq) > 4


def test_written_gguf_loads_at_its_widths(tiny_gguf):
    from tpu_llm.models.llama import load_gguf
    from tpu_llm.quant.qtensor import QTensor

    params, cfg = load_gguf(tiny_gguf, dtype_policy="native")
    assert (cfg.dim, cfg.hidden_dim, cfg.n_layers, cfg.n_kv_heads,
            cfg.vocab_size, cfg.seq_len) == (128, 192, 2, 2, 256, 512)
    w = params["layers"]["wq"]
    assert isinstance(w, QTensor) and w.kind == "q4_0"
    assert params["tok_emb"].dtype == jnp.bfloat16


def test_synthetic_vocab_encodes_a_letter_per_token(tiny_gguf):
    from tpu_llm.io.gguf import GGUFFile
    from tpu_llm.tokenizers.bpe import BPETokenizer

    tok = BPETokenizer.from_gguf(GGUFFile(tiny_gguf))
    text = cs.letters_prompt(50, seed=3)
    assert len(tok.encode(text)) == 50
    assert np.all(np.asarray(tok.encode(text)) < TINY.vocab_size)


def test_entry_point_fails_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"),
         "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
