"""Carry an engine's state across the two packages, as numpy arrays.

The leaves are the dynamic state of `repro.core.engine.DagEngine` (local
backend): ``keys``, ``alive``, ``adj``, ``n_overflow``, ``depth_ema``,
the closure cache and ``epoch``.  The cache crosses as ``cache.closure``
on the dense layout, and as ``cache.closure.tiles`` and
``cache.closure.summary`` (the two leaves of a `TiledClosure`) on the
tiled one, followed by ``cache.dirty`` and ``cache.repair_ema``.  Packed
words cross as int32 arrays holding the uint32 bit pattern (a ``uint32``
array is taken with ``.view(np.int32)``).  The caller flattens and
rebuilds the JAX side with numpy; this module never imports JAX.

LM params cross as the reference's param tree of numpy arrays (see
`lm_params_from_arrays`).  A JAX bfloat16 array becomes a numpy array
of the ``ml_dtypes`` bfloat16 type, which ``torch.from_numpy`` rejects;
such arrays are recognised by their dtype's name and cross by bit
pattern (16-bit integer views on both sides), so neither side rounds and
this module never imports ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.closure_cache import ClosureCache, TiledClosure
from repro_torch.core.dag import DagState
from repro_torch.core.engine import DagEngine, resolve_device

LEAVES = ("keys", "alive", "adj", "n_overflow", "depth_ema", "cache.closure",
          "cache.dirty", "cache.repair_ema", "epoch")
TILED_LEAVES = ("keys", "alive", "adj", "n_overflow", "depth_ema",
                "cache.closure.tiles", "cache.closure.summary", "cache.dirty",
                "cache.repair_ema", "epoch")


def _words(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)


def engine_from_arrays(arrays: dict, config_kwargs: dict | None = None,
                       device=None) -> DagEngine:
    """A port engine on ``device`` (None: the card) holding the leaves in
    ``arrays`` (every name of `LEAVES`, or of `TILED_LEAVES` for a tiled
    cache), configured by ``config_kwargs`` (the `DagEngine.create`
    keywords; the capacity, and on the tiled layout the window, are the
    leaves')."""
    tiled = "cache.closure.tiles" in arrays
    names = TILED_LEAVES if tiled else LEAVES
    missing = [k for k in names if k not in arrays]
    if missing:
        raise KeyError(f"missing engine leaves: {missing}")
    keys = np.asarray(arrays["keys"])
    kwargs = dict(config_kwargs or {})
    if tiled:
        kwargs.update(closure_layout="tiled", closure_region=int(
            np.asarray(arrays["cache.closure.tiles"]).shape[0]))
    eng = DagEngine.create(int(keys.shape[0]), device=device, **kwargs)
    dev = eng.device

    def on(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    state = DagState(
        keys=on(keys.astype(np.int32), torch.int32),
        alive=on(np.asarray(arrays["alive"], bool), torch.bool),
        adj=on(_words(arrays["adj"]), torch.int32),
        n_overflow=on(np.asarray(arrays["n_overflow"], np.int32),
                      torch.int32).reshape(()))
    if tiled:
        closure = TiledClosure(
            on(_words(arrays["cache.closure.tiles"]), torch.int32),
            on(_words(arrays["cache.closure.summary"]), torch.int32))
    else:
        closure = on(_words(arrays["cache.closure"]), torch.int32)
    cache = ClosureCache(
        closure, bool(np.asarray(arrays["cache.dirty"])),
        torch.as_tensor(np.array(arrays["cache.repair_ema"], np.float32)
                        ).reshape(()))
    depth_ema = torch.as_tensor(np.array(arrays["depth_ema"], np.float32)
                                ).reshape(-1)
    return DagEngine(state, depth_ema, cache, eng.config,
                     int(np.asarray(arrays["epoch"])))


def engine_to_arrays(engine: DagEngine) -> dict:
    """The engine's leaves as numpy arrays (packed words as int32)."""
    st, cache = engine.state, engine.cache
    out = {
        "keys": st.keys.cpu().numpy(),
        "alive": st.alive.cpu().numpy(),
        "adj": st.adj.cpu().numpy(),
        "n_overflow": st.n_overflow.cpu().numpy(),
        "depth_ema": engine.depth_ema.cpu().numpy(),
    }
    if isinstance(cache.closure, TiledClosure):
        out["cache.closure.tiles"] = cache.closure.tiles.cpu().numpy()
        out["cache.closure.summary"] = cache.closure.summary.cpu().numpy()
    else:
        out["cache.closure"] = cache.closure.cpu().numpy()
    out.update({"cache.dirty": np.asarray(cache.dirty),
                "cache.repair_ema": cache.repair_ema.cpu().numpy(),
                "epoch": np.asarray(engine.epoch, np.int32)})
    return out


def _tensor_of(arr, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def _array_of(t: torch.Tensor, bfloat16) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    return t.view(torch.int16).numpy().view(bfloat16)


def lm_params_from_arrays(arrays: dict, device=None) -> dict:
    """The port's LM params on ``device`` (None: the card) from the
    reference's param tree as numpy arrays: {"embed", "unembed",
    "final_norm", "layers": {name: stacked leaf}} (`models.transformer`).
    bfloat16 leaves keep their bits."""
    dev = resolve_device(device)
    out = {k: _tensor_of(v, dev) for k, v in arrays.items() if k != "layers"}
    out["layers"] = {k: _tensor_of(v, dev)
                     for k, v in arrays["layers"].items()}
    return out


def lm_params_to_arrays(params: dict, bfloat16) -> dict:
    """The port's LM params as the reference's tree of numpy arrays.
    bfloat16 leaves come back bit for bit as arrays of ``bfloat16``, the
    numpy bfloat16 type the caller passes (``ml_dtypes.bfloat16``, which
    ``jnp.bfloat16`` is)."""
    out = {k: _array_of(v, bfloat16) for k, v in params.items()
           if k != "layers"}
    out["layers"] = {k: _array_of(v, bfloat16)
                     for k, v in params["layers"].items()}
    return out
