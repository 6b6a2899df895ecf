"""Carry an engine's state across the two packages, as numpy arrays.

The leaves are the dynamic state of `repro.core.engine.DagEngine` (local
backend, dense closure): ``keys``, ``alive``, ``adj``, ``n_overflow``,
``depth_ema``, ``cache.closure``, ``cache.dirty``, ``cache.repair_ema``
and ``epoch``.  Packed words cross as int32 arrays holding the uint32 bit
pattern (a ``uint32`` array is taken with ``.view(np.int32)``).  The
caller flattens and rebuilds the JAX side with numpy; this module never
imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.closure_cache import ClosureCache
from repro_torch.core.dag import DagState
from repro_torch.core.engine import DagEngine

LEAVES = ("keys", "alive", "adj", "n_overflow", "depth_ema", "cache.closure",
          "cache.dirty", "cache.repair_ema", "epoch")


def _words(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)


def engine_from_arrays(arrays: dict, config_kwargs: dict | None = None,
                       device=None) -> DagEngine:
    """A port engine on ``device`` (None: the card) holding the leaves in
    ``arrays`` (every name of `LEAVES`), configured by ``config_kwargs``
    (the `DagEngine.create` keywords; the capacity is the leaves')."""
    missing = [k for k in LEAVES if k not in arrays]
    if missing:
        raise KeyError(f"missing engine leaves: {missing}")
    keys = np.asarray(arrays["keys"])
    eng = DagEngine.create(int(keys.shape[0]), device=device,
                           **(config_kwargs or {}))
    dev = eng.device

    def on(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    state = DagState(
        keys=on(keys.astype(np.int32), torch.int32),
        alive=on(np.asarray(arrays["alive"], bool), torch.bool),
        adj=on(_words(arrays["adj"]), torch.int32),
        n_overflow=on(np.asarray(arrays["n_overflow"], np.int32),
                      torch.int32).reshape(()))
    cache = ClosureCache(
        on(_words(arrays["cache.closure"]), torch.int32),
        bool(np.asarray(arrays["cache.dirty"])),
        torch.as_tensor(np.array(arrays["cache.repair_ema"], np.float32)
                        ).reshape(()))
    depth_ema = torch.as_tensor(np.array(arrays["depth_ema"], np.float32)
                                ).reshape(-1)
    return DagEngine(state, depth_ema, cache, eng.config,
                     int(np.asarray(arrays["epoch"])))


def engine_to_arrays(engine: DagEngine) -> dict:
    """The engine's leaves as numpy arrays (packed words as int32)."""
    st, cache = engine.state, engine.cache
    return {
        "keys": st.keys.cpu().numpy(),
        "alive": st.alive.cpu().numpy(),
        "adj": st.adj.cpu().numpy(),
        "n_overflow": st.n_overflow.cpu().numpy(),
        "depth_ema": engine.depth_ema.cpu().numpy(),
        "cache.closure": cache.closure.cpu().numpy(),
        "cache.dirty": np.asarray(cache.dirty),
        "cache.repair_ema": cache.repair_ema.cpu().numpy(),
        "epoch": np.asarray(engine.epoch, np.int32),
    }
