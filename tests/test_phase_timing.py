"""Phase-timing buckets (tpu_llm.runtime.phase_timing): the reference's
five-bucket exit report (llama2.f90:403-410) measured as per-phase jitted
scans. On the CPU test backend we check the programs build/run and the
report has the reference's shape; the numbers themselves are only
meaningful on the GPU."""

import math

import jax.numpy as jnp
import numpy as np

from tpu_llm.config import LlamaConfig
from tpu_llm.models import llama as M
from tpu_llm.runtime.phase_timing import (
    BUCKETS, format_report, measure_phase_times,
)


def tiny_params(cfg, fused=False):
    rng = np.random.default_rng(0)
    s = lambda *sh: jnp.asarray((rng.standard_normal(sh) * 0.05).astype(np.float32))
    L, E, F, V, KV = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim
    layers = {
        "attn_norm": s(L, E) + 1.0, "ffn_norm": s(L, E) + 1.0,
        "wo": s(L, E, E), "w2": s(L, F, E),
    }
    if fused:
        layers["wqkv"] = s(L, E, E + 2 * KV)
        layers["w13"] = s(L, E, 2 * F)
    else:
        layers.update(wq=s(L, E, E), wk=s(L, E, KV), wv=s(L, E, KV),
                      w1=s(L, E, F), w3=s(L, E, F))
    return {"tok_emb": s(V, E), "final_norm": s(E) + 1.0, "wcls": s(E, V),
            "layers": layers}


def test_measure_phase_times_all_buckets():
    cfg = LlamaConfig(dim=32, hidden_dim=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, vocab_size=96, seq_len=64)
    for fused in (False, True):
        times = measure_phase_times(
            tiny_params(cfg, fused), cfg, batch=1, pos=8, max_seq=32,
            steps=6,
        )
        assert set(times) == set(BUCKETS)
        assert all(math.isfinite(v) for v in times.values())


def test_format_report_shape():
    report = format_report({b: 0.5 for b in BUCKETS})
    lines = report.splitlines()
    assert len(lines) == 6  # header + 5 buckets, like the reference loop
    for i, b in enumerate(BUCKETS, start=1):
        assert b in lines[i]
        assert str(i) in lines[i]
