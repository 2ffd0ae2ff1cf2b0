"""Fast-reload weight cache: a converted checkpoint as serialized arrays.

The reference's answer to slow GGUF parsing is the offline ``load``
converter writing the packed "ak" binary (load.f90:158-507). The JAX
analog (SURVEY.md §5, checkpoint/resume): after one GGUF parse + repack
(dequant policy applied, QKV/gate-up fused, Q4_0 repacked to the device
layout), persist the finished parameter pytree as one ``.npz`` and reload
it with zero parsing — a single mmap'd read per tensor, already in the
exact layout the kernels consume.

Format: numpy .npz (zip of .npy). Pytree paths become array names
("layers.0.wqkv.q"); QTensor leaves store their q/scales planes plus a
kind marker; a "__meta__" JSON entry carries the LlamaConfig and tree
structure hints. bfloat16 (no numpy dtype) is stored as uint16 bits with a
dtype tag in the meta.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple

import numpy as np
import jax.numpy as jnp

from tpu_llm.config import LlamaConfig
from tpu_llm.quant.qtensor import QTensor

MAGIC = "tpu_llm-weight-cache-v1"


def _flatten(prefix: str, node: Any, out: Dict[str, Any], meta: Dict[str, Any]):
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(f"{prefix}{k}.", v, out, meta)
        return
    if isinstance(node, (list, tuple)):
        meta.setdefault("lists", {})[prefix.rstrip(".")] = len(node)
        for i, v in enumerate(node):
            _flatten(f"{prefix}{i}.", v, out, meta)
        return
    key = prefix.rstrip(".")
    if node is None:
        meta.setdefault("nones", []).append(key)
        return
    if isinstance(node, QTensor):
        meta.setdefault("qtensors", {})[key] = node.kind
        _store(f"{key}.q", node.q, out, meta)
        _store(f"{key}.scales", node.scales, out, meta)
        if node.mins is not None:
            _store(f"{key}.mins", node.mins, out, meta)
        return
    _store(key, node, out, meta)


def _store(key: str, arr, out: Dict[str, Any], meta: Dict[str, Any]):
    a = np.asarray(arr)
    if a.dtype == jnp.bfloat16:
        meta.setdefault("bf16", []).append(key)
        a = a.view(np.uint16)
    out[key] = a


def save_weight_cache(path: str, params: Any, cfg: LlamaConfig):
    arrays: Dict[str, Any] = {}
    meta: Dict[str, Any] = {
        "magic": MAGIC,
        "config": dataclasses.asdict(cfg),
    }
    _flatten("", params, arrays, meta)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_weight_cache(path: str) -> Tuple[Any, LlamaConfig]:
    with np.load(path) as z:
        return _build_tree(z, path)


def _build_tree(z, path: str = "<npz>") -> Tuple[Any, LlamaConfig]:
    meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
    assert meta.get("magic") == MAGIC, f"not a tpu_llm weight cache: {path}"
    cfg = LlamaConfig(**meta["config"])
    bf16 = set(meta.get("bf16", []))
    qkinds = meta.get("qtensors", {})
    lists = meta.get("lists", {})
    nones = set(meta.get("nones", []))

    def load_arr(key):
        a = z[key]
        if key in bf16:
            a = a.view(np.uint16)
            return jnp.asarray(a).view(jnp.bfloat16)
        return jnp.asarray(a)

    names = [n for n in z.files if n != "__meta__"]
    tree: Dict[str, Any] = {}

    def insert(path_key: str, value):
        parts = path_key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    qprefixes = sorted(qkinds, key=len, reverse=True)
    done = set()
    for name in names:
        owner = next((q for q in qprefixes
                      if name in (f"{q}.q", f"{q}.scales", f"{q}.mins")),
                     None)
        if owner is not None:
            if owner in done:
                continue
            done.add(owner)
            insert(owner, QTensor(
                q=load_arr(f"{owner}.q"),
                scales=load_arr(f"{owner}.scales"),
                kind=qkinds[owner],
                mins=(load_arr(f"{owner}.mins")
                      if f"{owner}.mins" in names else None),
            ))
        else:
            insert(name, load_arr(name))
    for key in nones:
        insert(key, None)

    def fix_lists(node: Dict[str, Any], prefix: str):
        for k in list(node.keys()):
            v = node[k]
            if isinstance(v, dict):
                full = f"{prefix}{k}"
                fix_lists(v, full + ".")
                if full in lists:
                    node[k] = [v[str(i)] for i in range(lists[full])]
        return node

    return fix_lists(tree, ""), cfg
