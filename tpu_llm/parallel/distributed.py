"""Multi-host process bring-up (``jax.distributed``).

The reference has no communication backend at all (SURVEY.md §2.3: no
MPI/NCCL/sockets — single process by construction). The JAX
equivalent is its distributed runtime: every host of a multi-host run
runs the same program, calls ``jax.distributed.initialize`` before any
device use, and then sees the GLOBAL device set — after which the mesh /
pjit / collective machinery in this package works unchanged (GSPMD
compiles the same program on every host; XLA hands the collectives to
NCCL on GPUs).

Bring-up is configured by flags or environment:

- ``TPU_LLM_COORDINATOR`` (host:port of process 0),
- ``TPU_LLM_NUM_PROCESSES``, ``TPU_LLM_PROCESS_ID``.

Where a cluster environment lets JAX auto-detect them,
``init_distributed()`` with no arguments is also correct: it calls
initialize() whenever it can determine a multi-process world, and is a
no-op otherwise.

``--selftest`` (python -m tpu_llm.parallel.distributed --selftest ...)
runs one rank of a localhost two-process decode-parity check: a dp-sharded
llama decode step over a mesh spanning BOTH processes, compared against
the same step computed locally. Used by the multiprocess pytest
(tests/test_multiprocess.py) and the driver dry-run.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Initialize the JAX distributed runtime if a multi-process world is
    configured. Returns (process_id, num_processes) — (0, 1) when single
    process. Must run before any other JAX usage touches devices."""
    import jax

    coordinator = coordinator or os.environ.get("TPU_LLM_COORDINATOR")
    if num_processes is None:
        n = os.environ.get("TPU_LLM_NUM_PROCESSES")
        num_processes = int(n) if n else None
    if process_id is None:
        p = os.environ.get("TPU_LLM_PROCESS_ID")
        process_id = int(p) if p else None

    if coordinator is None and num_processes is None:
        # Auto-detect: when the environment carries a multi-host
        # coordinator signal (cluster metadata / JAX service env),
        # run the no-arg initialize() that reads it; otherwise stay a
        # single-process world. Probing jax.process_count() alone is NOT
        # enough — without initialize() each host reports itself as a
        # standalone world.
        hints = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
        if any(os.environ.get(h) for h in hints):
            try:
                jax.distributed.initialize()
            except Exception:
                pass
        try:
            if jax.process_count() > 1:
                return jax.process_index(), jax.process_count()
        except Exception:
            pass
        return 0, 1

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index(), jax.process_count()


# -- localhost two-process selftest ------------------------------------------

def _selftest_rank(rank: int, nprocs: int, port: int, local_devices: int) -> None:
    """One rank of the decode-parity selftest. Prints 'SELFTEST OK ...' on
    success; any mismatch raises."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={local_devices}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"localhost:{port}", nprocs, rank)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_llm.config import LlamaConfig
    from tpu_llm.models import llama as M
    from tpu_llm.parallel import make_mesh, llama_param_specs, llama_cache_spec
    from tpu_llm.parallel.sharding import shard_pytree

    n_dev = len(jax.devices())
    assert n_dev == nprocs * local_devices, (n_dev, nprocs, local_devices)

    cfg = LlamaConfig(dim=32, hidden_dim=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, vocab_size=96, seq_len=32)
    rng = np.random.default_rng(0)   # identical on every rank
    s = lambda *sh: jnp.asarray((rng.standard_normal(sh) * 0.05).astype(np.float32))
    L, E, F, V, KV = (cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size,
                      cfg.kv_dim)
    params = {
        "tok_emb": s(V, E), "final_norm": s(E) + 1.0, "wcls": s(E, V),
        "layers": {
            "attn_norm": s(L, E) + 1.0, "ffn_norm": s(L, E) + 1.0,
            "wq": s(L, E, E), "wk": s(L, E, KV), "wv": s(L, E, KV),
            "wo": s(L, E, E), "w1": s(L, E, F), "w3": s(L, E, F),
            "w2": s(L, F, E),
        },
    }
    batch = 2 * n_dev
    tokens_np = rng.integers(0, V, (batch,)).astype(np.int32)

    # single-device reference BEFORE sharding (jax still usable locally)
    cache0 = M.init_cache(cfg, batch, cfg.seq_len)
    ref_logits, _ = jax.jit(
        lambda p, t, c: M.decode_step(p, cfg, t, c, jnp.int32(0))
    )(params, jnp.asarray(tokens_np), cache0)
    ref = np.asarray(ref_logits)

    # dp-sharded decode over the cross-process mesh
    mesh = make_mesh(data=n_dev, model=1)
    p_sh = shard_pytree(params, llama_param_specs(cfg), mesh)
    cache = M.init_cache(cfg, batch, cfg.seq_len)
    cache = shard_pytree(cache, llama_cache_spec(), mesh)
    tok_sharding = NamedSharding(mesh, P("data"))
    tokens = jax.make_array_from_callback(
        (batch,), tok_sharding, lambda idx: tokens_np[idx]
    )

    replicated = NamedSharding(mesh, P())
    logits, _ = jax.jit(
        lambda p, t, c: M.decode_step(p, cfg, t, c, jnp.int32(0)),
        out_shardings=(replicated, replicated),
    )(p_sh, tokens, cache)
    got = np.asarray(
        jax.device_get(logits.addressable_shards[0].data)
    ).reshape(batch, V)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    print(f"SELFTEST OK rank={rank}/{nprocs} devices={n_dev} "
          f"logits={got.shape} maxdiff={np.abs(got - ref).max():.2e}",
          flush=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="tpu_llm.parallel.distributed")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--port", type=int, default=12789)
    ap.add_argument("--local-devices", type=int, default=2)
    args = ap.parse_args(argv)
    if args.selftest:
        _selftest_rank(args.rank, args.nprocs, args.port, args.local_devices)
        return 0
    ap.print_help()
    return 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
