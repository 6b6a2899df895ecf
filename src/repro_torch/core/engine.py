"""Unified `DagEngine` session API — the local backend, in torch.

Port of `repro.core.engine` (local backend, both closure layouts):

    eng = DagEngine.create(1024)                    # on "cuda", method="auto"
    eng, r = eng.add_vertices(keys)                 # r: OpResult
    eng, r = eng.add_edges_acyclic(us, vs)          # cycle-checked inserts
    hit    = eng.reachable(from_keys, to_keys)      # wait-free read
    eng, r = eng.apply(OpBatch(op, a, b))           # mixed typed batch

The engine is immutable: every mutating call returns ``(engine, OpResult)``
and a new engine; no tensor an engine or snapshot returned is ever
written in place.  Its state is the `DagState` slab and the packed closure
cache on the engine's device, plus host bookkeeping: the per-shard
deciding-depth EMA and the cache's repair-depth EMA (float32 CPU
scalars), the cache's dirty flag and the epoch (Python values).

``device`` is explicit: ``DagEngine.create(..., device=None)`` means
"cuda" and raises when no card is present; CPU runs pass ``device="cpu"``.
On a CUDA engine the default ``matmul_impl`` / ``closure_update_impl`` /
``closure_delete_impl`` are the `kernels.ops` dispatchers, so every
boolean product, rank-B fold and delete-repair hop launches the
hand-written kernels B1 / B2 / B3 with no argument from the caller; on a
CPU engine the same dispatchers run the plain versions.

``closure_layout="tiled"`` keeps the closure cache as 32x32-bit tiles in
a region window plus a per-tile occupancy summary (kernels B4 / B5 on the
card).  Eager calls widen the window host-side before it overflows, as
the reference's eager calls do; calls made inside `as_compiled` run as
the reference runs them inside its jitted serving tick, with no host
widening, so an edge past the window degrades the cache to dirty and the
exact partial check decides.  The window's high-water marks are reduced
on the card: only integers cross to the host, never the slab.

Not ported yet, raising NotImplementedError: ``backend="sharded"``
(ROADMAP.md section A item 11).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import bitset, closure_cache, dispatch, reachability
from repro_torch.core import acyclic as acyclic_mod
from repro_torch.core import dag as dag_mod
from repro_torch.core import snapshot, snapshot_view
from repro_torch.core.closure_cache import ClosureCache
from repro_torch.core.dag import (
    ADD_EDGE, ADD_VERTEX, CONTAINS_EDGE, CONTAINS_VERTEX, DagState,
    REMOVE_EDGE, REMOVE_VERTEX,
)
from repro_torch.core.reachability import MatmulImpl

BACKENDS = ("local", "sharded")

SHARDED_NOT_PORTED = ("backend='sharded' is not ported yet "
                      "(ROADMAP.md section A item 11)")

_COMPILED = contextvars.ContextVar("repro_torch_compiled", default=False)


@contextlib.contextmanager
def as_compiled():
    """Run the engine calls inside as the reference runs them inside
    ``jax.jit`` (its serving ticks are jitted), where the host cannot widen
    the tiles window between calls: `DagEngine._pre_widened` and
    `_region_synced` are identities, so an edge past the window degrades
    the cache to dirty and the exact partial check decides; and
    `_grown_for_overflow` is None, so an ``auto_grow`` engine reports its
    overflow and drops instead of growing inside the call.  The tick
    bodies of `launch/serve.py` run under it; calls outside it widen as
    the reference's eager calls do."""
    token = _COMPILED.set(True)
    try:
        yield
    finally:
        _COMPILED.reset(token)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; raises when a CUDA device is asked for and
    none is present.  Nothing falls back to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the "
            "engine on the CPU")
    return dev


# ------------------------------------------------------------ typed batches

class OpBatch(NamedTuple):
    """A typed batch of operation requests (one row per logical "thread");
    ``op`` holds the `core/dag.py` op codes, ``a``/``b`` the operands.
    Linearization: RemoveVertex -> AddVertex -> RemoveEdge -> AddEdge ->
    reads, then batch-index order within a phase."""

    op: torch.Tensor  # int32[B] op codes
    a: torch.Tensor   # int32[B] first key operand
    b: torch.Tensor   # int32[B] second key operand (edge target)

    @staticmethod
    def _of(code: int, a, b=None, device=None) -> "OpBatch":
        a = torch.as_tensor(a, dtype=torch.int32, device=device)
        b = torch.zeros_like(a) if b is None \
            else torch.as_tensor(b, dtype=torch.int32, device=a.device)
        return OpBatch(torch.full(a.shape, code, dtype=torch.int32,
                                  device=a.device), a, b)

    @classmethod
    def add_vertices(cls, keys, device=None) -> "OpBatch":
        return cls._of(ADD_VERTEX, keys, device=device)

    @classmethod
    def remove_vertices(cls, keys, device=None) -> "OpBatch":
        return cls._of(REMOVE_VERTEX, keys, device=device)

    @classmethod
    def add_edges(cls, us, vs, device=None) -> "OpBatch":
        """AcyclicAddEdge requests (cycle-checked under
        ``apply(..., acyclic=True)``, the default)."""
        return cls._of(ADD_EDGE, us, vs, device=device)

    @classmethod
    def remove_edges(cls, us, vs, device=None) -> "OpBatch":
        return cls._of(REMOVE_EDGE, us, vs, device=device)

    @classmethod
    def contains_vertices(cls, keys, device=None) -> "OpBatch":
        return cls._of(CONTAINS_VERTEX, keys, device=device)

    @classmethod
    def contains_edges(cls, us, vs, device=None) -> "OpBatch":
        return cls._of(CONTAINS_EDGE, us, vs, device=device)

    @classmethod
    def concat(cls, *batches: "OpBatch") -> "OpBatch":
        return cls(torch.cat([x.op for x in batches]),
                   torch.cat([x.a for x in batches]),
                   torch.cat([x.b for x in batches]))

    @property
    def size(self) -> int:
        return self.op.shape[0]


class ReachStats(NamedTuple):
    """Cycle-check work accounting.  The counts are ints;
    ``deciding_depth`` is int32[S] on the CPU (S = shard count, 1
    locally): the deciding hops of the call's last algorithm-2 check."""

    n_products: int               # boolean matmuls executed
    row_products: int             # total rows fed through the matmul
    n_partial: int                # sub-batch checks algorithm 2 decided
    n_incremental: int            # sub-batch checks the cache decided
    deciding_depth: torch.Tensor  # int32[S]: last partial check's hops
    n_repair: int                 # delete-repair commits of this call

    @classmethod
    def zeros(cls, n_shards: int = 1) -> "ReachStats":
        return cls(0, 0, 0, 0, torch.zeros((n_shards,), dtype=torch.int32),
                   0)

    @classmethod
    def from_raw(cls, stats: dict) -> "ReachStats":
        return cls(stats["n_products"], stats["row_products"],
                   stats["n_partial"], stats["n_incremental"],
                   stats["deciding_depth"], stats["n_repair"])


class OpResult(NamedTuple):
    """Result of one engine call: per-row ok bits, the number of vertex
    adds this call dropped for capacity, and the cycle-check stats."""

    ok: torch.Tensor          # bool[B]
    n_overflow: torch.Tensor  # int32: adds dropped for capacity, this call
    stats: ReachStats


# ----------------------------------------------------------- configuration

@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static session configuration (see `repro.core.engine.EngineConfig`;
    the mesh field comes with its port).  ``device`` is the one option the
    port adds.  ``None`` for an impl means the `kernels.ops` dispatcher."""

    capacity: int
    backend: str = "local"
    method: str = "auto"
    subbatches: int = 1
    matmul_impl: Optional[MatmulImpl] = None
    policy: Optional[dispatch.DispatchPolicy] = None
    closure_update_impl: Optional[object] = None
    closure_delete_impl: Optional[object] = None
    auto_grow: bool = False
    # "dense" keeps the int32[C, C/32] slab; "tiled" the tiles window plus
    # summary (`closure_cache.TiledClosure`)
    closure_layout: str = "dense"
    # the tiles window's initial size (0 = min(capacity, 1024))
    closure_region: int = 0
    device: torch.device = torch.device("cpu")

    @property
    def n_devices(self) -> int:
        return 1


def _capacity_alignment(backend: str, n_dev: int) -> Tuple[int, str]:
    if backend == "sharded":
        return bitset.WORD * n_dev, f"32 bits x {n_dev} devices"
    return bitset.WORD, "32-bit packed words"


def validate_capacity(capacity: int, *, backend: str = "local",
                      n_dev: int = 1, what: str = "capacity") -> None:
    """Raise ValueError unless ``capacity`` sits on the backend's grid,
    naming the nearest valid capacity in the message."""
    align, why = _capacity_alignment(backend, n_dev)
    if capacity <= 0:
        raise ValueError(f"{what} must be positive, got {capacity}")
    if capacity % align != 0:
        down = (capacity // align) * align
        up = down + align
        # ties round UP: the request is a floor
        nearest = up if (down == 0 or capacity - down >= up - capacity) \
            else down
        raise ValueError(
            f"{backend} {what} must be a multiple of {align} ({why}), got "
            f"{capacity}; nearest valid capacity is {nearest}")


def _bit_high_water(packed: torch.Tensor) -> int:
    """The smallest window covering every set bit of a (C, C/32) bit
    matrix: max(last non-empty row + 1, 32 * (last non-empty word column
    + 1)), 0 when empty.  Reduced on the device: one int crosses to the
    host, not the matrix."""
    c, w = packed.shape
    dev = packed.device
    rows = torch.where(torch.any(packed, dim=1),
                       torch.arange(1, c + 1, device=dev), 0)
    cols = torch.where(torch.any(packed, dim=0),
                       torch.arange(1, w + 1, device=dev) * bitset.WORD, 0)
    return int(torch.maximum(torch.max(rows), torch.max(cols)))


def _zero_ema(n_dev: int) -> torch.Tensor:
    return torch.zeros((n_dev,), dtype=torch.float32)


class DagEngine:
    """The concurrent-DAG session object.  Immutable: every mutating call
    returns a new engine sharing the static config."""

    __slots__ = ("state", "depth_ema", "cache", "config", "epoch")

    def __init__(self, state: DagState, depth_ema: torch.Tensor,
                 cache: ClosureCache, config: EngineConfig, epoch: int = 0):
        self.state = state
        self.depth_ema = depth_ema  # float32[S] CPU: deciding-depth EMA
        self.cache = cache          # incremental transitive-closure cache
        self.config = config
        # version counter: bumped by every mutation commit (not by views,
        # refresh or grow); names snapshots
        self.epoch = int(epoch)

    # ------------------------------------------------------- construction

    @classmethod
    def create(cls, capacity: int, *, backend: str = "local",
               method: str = "auto", subbatches: int = 1,
               matmul_impl: Optional[MatmulImpl] = None,
               policy: Optional[dispatch.DispatchPolicy] = None,
               mesh=None, closure_update_impl=None,
               closure_delete_impl=None,
               auto_grow: bool = False,
               closure_layout: str = "dense",
               closure_region: int = 0,
               device=None) -> "DagEngine":
        """Create an empty engine on ``device`` (None: the card; raises if
        none is present).  ``policy`` overrides ``method``; "auto" gets
        `CostModelPolicy`, a fixed method `FixedPolicy`.  The impl hooks
        default to the `kernels.ops` dispatchers.
        ``closure_layout="tiled"`` stores the cache as tiles in a region
        window (``closure_region`` pre-sizes it) plus a per-tile occupancy
        summary.  ``mesh`` is the reference's keyword for the sharded
        backend; the local engine ignores it, as the reference's does."""
        if backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {backend!r}")
        if backend == "sharded":
            raise NotImplementedError(SHARDED_NOT_PORTED)
        if subbatches < 1:
            raise ValueError(f"subbatches must be >= 1, got {subbatches}")
        validate_capacity(capacity, backend="local")
        if closure_layout not in ("dense", "tiled"):
            raise ValueError(
                f"closure_layout must be 'dense' or 'tiled', got "
                f"{closure_layout!r}")
        dev = resolve_device(device)
        policy = dispatch.policy_for_method(method, policy)
        method = dispatch.method_name(policy)
        state = dag_mod.new_state(capacity, device=dev)
        # a fresh engine's cache is exact: the empty graph's strict
        # closure is all-zeros
        if closure_layout == "tiled":
            cache = closure_cache.empty_tiled_cache(capacity, closure_region,
                                                    device=dev)
            closure_region = cache.closure.region
        else:
            cache = closure_cache.empty_cache(capacity, device=dev)
        del mesh
        config = EngineConfig(capacity=capacity, backend=backend,
                              method=method, subbatches=subbatches,
                              matmul_impl=matmul_impl, policy=policy,
                              closure_update_impl=closure_update_impl,
                              closure_delete_impl=closure_delete_impl,
                              auto_grow=auto_grow,
                              closure_layout=closure_layout,
                              closure_region=closure_region, device=dev)
        return cls(state, _zero_ema(config.n_devices), cache, config)

    @classmethod
    def wrap(cls, state: DagState, config: EngineConfig,
             depth_ema=None, cache=None, epoch: int = 0) -> "DagEngine":
        """Wrap an existing `DagState` slab in an engine without copying.
        Without an explicit ``cache`` the closure cache starts DIRTY."""
        ema = _zero_ema(config.n_devices) if depth_ema is None else depth_ema
        if cache is None:
            if config.closure_layout == "tiled":
                cache = closure_cache.empty_tiled_cache(
                    config.capacity, config.closure_region, dirty=True,
                    device=state.device)
            else:
                cache = closure_cache.empty_cache(config.capacity, dirty=True,
                                                  device=state.device)
        return cls(state, ema, cache, config, epoch)

    def refresh_cache(self) -> "DagEngine":
        """Rebuild the closure cache from the committed graph iff dirty; on
        the tiled layout the window is first widened to cover every
        committed edge."""
        eng = self._region_synced()
        closure, _ = closure_cache.refresh_closure(
            eng.cache.closure, eng.cache.dirty, eng.state.adj,
            eng.config.matmul_impl)
        return DagEngine(eng.state, eng.depth_ema,
                         ClosureCache(closure, False, eng.cache.repair_ema),
                         eng.config, eng.epoch)

    def snapshot(self) -> "snapshot_view.EngineSnapshot":
        """The versioned wait-free read view of this session (epoch + slab
        view + clean packed closure); a dirty cache is rebuilt for the
        view.  Shares the engine's tensors, which are never written."""
        eng = self._region_synced()
        closure, _ = closure_cache.refresh_closure(
            eng.cache.closure, eng.cache.dirty, eng.state.adj,
            eng.config.matmul_impl)
        return snapshot_view.EngineSnapshot(eng.epoch, eng.state, closure)

    def with_options(self, *, method: Optional[str] = None,
                     subbatches: Optional[int] = None,
                     matmul_impl=dataclasses.MISSING) -> "DagEngine":
        """A view of the same session state under overridden static
        options; unspecified options are inherited."""
        cfg = self.config
        policy = cfg.policy if method is None \
            else dispatch.policy_for_method(method)
        new = dataclasses.replace(
            cfg,
            method=dispatch.method_name(policy),
            subbatches=cfg.subbatches if subbatches is None else subbatches,
            matmul_impl=cfg.matmul_impl
            if matmul_impl is dataclasses.MISSING else matmul_impl,
            policy=policy)
        return DagEngine(self.state, self.depth_ema, self.cache, new,
                         self.epoch)

    # --------------------------------------------------------------- growth

    def grow(self, new_capacity: int) -> "DagEngine":
        """Re-embed the whole session at a larger capacity (pure
        zero-padding: clean/dirty status, EMAs and epoch carry over)."""
        cfg = self.config
        validate_capacity(new_capacity, backend=cfg.backend,
                          n_dev=cfg.n_devices, what="grown capacity")
        if new_capacity < cfg.capacity:
            raise ValueError(
                f"cannot shrink: grown capacity {new_capacity} < current "
                f"{cfg.capacity}")
        if new_capacity == cfg.capacity:
            return self
        state = dag_mod.grow_state(self.state, new_capacity)
        cache = closure_cache.grow_cache(self.cache, new_capacity)
        config = dataclasses.replace(cfg, capacity=new_capacity)
        return DagEngine(state, self.depth_ema, cache, config, self.epoch)

    # ------------------------------------------------ tiled window sizing

    @property
    def closure_region(self) -> Optional[int]:
        """Live tiles-window size (None on the dense layout)."""
        closure = self.cache.closure
        return closure.region if closure_cache.is_tiled(closure) else None

    def _with_region(self, new_region: int) -> "DagEngine":
        """Engine with the tiles window widened to ``new_region`` (no-op on
        dense or when already wide enough): zero-padding of the tiles;
        closure bits, dirty flag and epoch ride through."""
        closure = self.cache.closure
        if not closure_cache.is_tiled(closure):
            return self
        nr = closure_cache.align_region(new_region, self.capacity)
        if nr <= closure.region:
            return self
        cache = self.cache._replace(
            closure=closure_cache.grow_region(closure, nr))
        return DagEngine(self.state, self.depth_ema, cache, self.config,
                         self.epoch)

    def grow_region(self, new_region: int) -> "DagEngine":
        """Widen the tiled closure window so slots below ``new_region`` fold
        into the cache (identity on dense or when already wide enough)."""
        return self._with_region(new_region)

    def _live_high_water(self) -> int:
        """max live slot + 1 (0 when empty), reduced on the device."""
        alive = self.state.alive
        idx = torch.arange(1, alive.shape[0] + 1, device=alive.device)
        return int(torch.max(torch.where(alive, idx, 0)))

    def _pre_widened(self, n_new_slots: int) -> "DagEngine":
        """Widen the tiles window, doubling, before a call that may place
        ``n_new_slots`` more vertices (slots fill lowest-free-first, so the
        post-call high-water is at most the live high-water + n_new).
        Identity on dense and inside `as_compiled`."""
        closure = self.cache.closure
        if not closure_cache.is_tiled(closure) or _COMPILED.get():
            return self
        need = self._live_high_water() + int(n_new_slots)
        if need <= closure.region:
            return self
        return self._with_region(max(2 * closure.region, need))

    def _region_synced(self) -> "DagEngine":
        """Engine whose tiles window covers every committed adjacency bit
        (identity on dense, inside `as_compiled`, or when already
        confined) — the precondition for a tiled cache refresh."""
        closure = self.cache.closure
        if not closure_cache.is_tiled(closure) or _COMPILED.get() \
                or closure_cache.region_confined(self.state.adj,
                                                 closure.region):
            return self
        return self._with_region(_bit_high_water(self.state.adj))

    def with_closure_layout(self, layout: str,
                            region: int = 0) -> "DagEngine":
        """Re-represent the closure cache in ``layout`` ("dense" |
        "tiled") without touching the graph or the epoch.  The tiled window
        is the smallest that covers every closure and adjacency bit (and
        ``region``)."""
        cfg = self.config
        if layout == cfg.closure_layout:
            return self
        cache = self.cache
        dense = closure_cache.dense_of(cache.closure)
        if layout == "tiled":
            need = max(int(region), closure_cache.TILE,
                       _bit_high_water(dense | self.state.adj))
            tiled = closure_cache.tiled_of(
                dense, closure_cache.align_region(need, cfg.capacity))
            new_cache = cache._replace(closure=tiled)
            config = dataclasses.replace(cfg, closure_layout="tiled",
                                         closure_region=tiled.region)
        elif layout == "dense":
            new_cache = cache._replace(closure=dense)
            config = dataclasses.replace(cfg, closure_layout="dense",
                                         closure_region=0)
        else:
            raise ValueError(
                f"closure_layout must be 'dense' or 'tiled', got {layout!r}")
        return DagEngine(self.state, self.depth_ema, new_cache, config,
                         self.epoch)

    def _grown_for_overflow(self, result: "OpResult") -> Optional["DagEngine"]:
        """Under ``auto_grow``, the PRE-call engine doubled until the adds
        ``result`` dropped would fit — or None when no growth applies.
        Inside `as_compiled` it is None, as the reference's is under
        ``jax.jit``: the call reports its overflow and drops, and the
        caller grows between ticks."""
        if not self.config.auto_grow or _COMPILED.get():
            return None
        need = int(result.n_overflow)
        if need <= 0:
            return None
        new_cap = self.config.capacity
        while new_cap - self.config.capacity < need:
            new_cap *= 2
        return self.grow(new_cap)

    def __repr__(self):
        c = self.config
        return (f"DagEngine(capacity={c.capacity}, backend={c.backend!r}, "
                f"method={c.method!r}, subbatches={c.subbatches}, "
                f"device={str(c.device)!r})")

    # ---------------------------------------------------------- internals

    @property
    def capacity(self) -> int:
        return self.config.capacity

    @property
    def device(self) -> torch.device:
        return self.config.device

    def _keys(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int32, device=self.device)

    def _with_state(self, state: DagState, cache: ClosureCache,
                    stats: Optional[dict] = None) -> "DagEngine":
        ema = self.depth_ema
        if stats is not None:
            update = getattr(self.config.policy, "update_depth_ema", None)
            if update is not None:
                ema = update(ema, stats["deciding_depth"])
        # every mutation commit bumps the session epoch
        return DagEngine(state, ema, cache, self.config, self.epoch + 1)

    def _invalidated_cache(self, state: DagState) -> ClosureCache:
        """Cache after a mutation that bypassed the incremental fold-in:
        dirty iff any adjacency bit changed; configurations that never
        read the cache mark it stale without the diff."""
        if not self._cache_aware(self.config.method):
            return self.cache._replace(dirty=True)
        return self.cache.invalidated_if(
            bool(torch.any(state.adj != self.state.adj)))

    def _cache_aware(self, method: str) -> bool:
        """Whether this call threads the closure cache through the cycle
        check (fixed incremental, or auto with an opted-in policy)."""
        if method == "incremental":
            return True
        return method == "auto" and getattr(
            self.config.policy, "use_incremental", False)

    def _prefer_repair_fn(self):
        """The policy's delete dispatch arm closed over the capacity — over
        the live window's rows on the tiled layout, where a rebuild costs
        O(region) rows."""
        hook = getattr(self.config.policy, "prefer_delete_repair", None)
        if hook is None:
            return None
        region = self.closure_region
        capacity = self.config.capacity if region is None else region

        def prefer(n_affected, depth_hint):
            return hook(n_affected, capacity, depth_hint=depth_hint)

        return prefer

    def _commit_cache(self, state: DagState, delta):
        """Apply a mutation's typed `CacheDelta` through the single
        `closure_cache.commit` entry point -> (cache', ReachStats)."""
        zeros = ReachStats.zeros(self.config.n_devices)
        if not self._cache_aware(self.config.method):
            return self.cache._replace(dirty=True), zeros
        cache, st = closure_cache.commit(
            self.cache, delta, state.adj,
            update_impl=self.config.closure_update_impl,
            delete_impl=self.config.closure_delete_impl,
            prefer_repair_fn=self._prefer_repair_fn(),
            ema_alpha=getattr(self.config.policy, "ema_alpha", 0.25),
            with_stats=True)
        return cache, zeros._replace(n_products=st["n_products"],
                                     row_products=st["row_products"],
                                     n_repair=st["n_repair"])

    def _overflow_delta(self, state: DagState) -> torch.Tensor:
        return state.n_overflow - self.state.n_overflow

    def _dispatch_hooks(self):
        """(method, prefer_partial_fn) for one cycle-checked call."""
        policy = self.config.policy
        fixed = getattr(policy, "fixed_method", None)
        if fixed is not None:
            return fixed, None
        ema = self.depth_ema

        def prefer(adj_t, b_sub):
            return policy.prefer_partial(adj_t, b_sub, depth_hint=ema)

        return "auto", prefer

    # ------------------------------------------------------ vertex ops

    def add_vertices(self, keys, valid=None):
        """AddVertex batch -> (engine, OpResult); overflowed adds report
        ok=False and count into ``result.n_overflow`` (unless
        ``auto_grow``, which doubles capacity and re-runs the call)."""
        keys = self._keys(keys)
        # widen a tiled window so this batch's slots can fold into the
        # cache (no-op on dense and inside as_compiled)
        eng = self._pre_widened(keys.shape[0])
        state, ok = dag_mod.add_vertices(eng.state, keys, valid=valid)
        res = OpResult(ok, eng._overflow_delta(state),
                       ReachStats.zeros(eng.config.n_devices))
        grown = eng._grown_for_overflow(res)
        if grown is not None:
            return grown.add_vertices(keys, valid=valid)
        # vertex adds never touch adjacency: a clean cache stays clean
        return eng._with_state(state, eng.cache), res

    def remove_vertices(self, keys, valid=None):
        """RemoveVertex batch (incident edges cleared in-step) -> (engine,
        OpResult); the removal commits a typed `CacheDelta`."""
        return self.remove_vertices_with_delta(keys, valid)[:2]

    def remove_vertices_with_delta(self, keys, valid=None):
        """`remove_vertices` -> (engine, OpResult, the committed
        `CacheDelta`): the replication log's record of the call."""
        state, ok, delta = dag_mod.remove_vertices_delta(
            self.state, self._keys(keys), valid=valid)
        cache, stats = self._commit_cache(state, delta)
        res = OpResult(ok, self._overflow_delta(state), stats)
        return self._with_state(state, cache), res, delta

    # -------------------------------------------------------- edge ops

    def add_edges_acyclic(self, us, vs, valid=None):
        """AcyclicAddEdge batch -> (engine, OpResult), dispatched by the
        configured policy; joint-abort semantics within a sub-batch."""
        cfg = self.config
        us, vs = self._keys(us), self._keys(vs)
        method, prefer = self._dispatch_hooks()
        common = dict(valid=valid, subbatches=cfg.subbatches,
                      matmul_impl=cfg.matmul_impl, method=method,
                      with_stats=True, prefer_partial_fn=prefer,
                      n_shards=cfg.n_devices)
        if self._cache_aware(method):
            state, ok, cache, stats = acyclic_mod.acyclic_add_edges_impl(
                self.state, us, vs, cache=self.cache,
                closure_update_impl=cfg.closure_update_impl,
                prefer_incremental_fn=getattr(cfg.policy,
                                              "prefer_incremental", None),
                **common)
        else:
            state, ok, stats = acyclic_mod.acyclic_add_edges_impl(
                self.state, us, vs, **common)
            cache = self._invalidated_cache(state)
        res = OpResult(ok, self._overflow_delta(state),
                       ReachStats.from_raw(stats))
        return self._with_state(state, cache, stats), res

    def remove_edges(self, us, vs, valid=None):
        """RemoveEdge batch -> (engine, OpResult); commits an adj-diff
        exact `CacheDelta`."""
        return self.remove_edges_with_delta(us, vs, valid)[:2]

    def remove_edges_with_delta(self, us, vs, valid=None):
        """`remove_edges` -> (engine, OpResult, the committed
        `CacheDelta`): the replication log's record of the call."""
        state, ok, delta = dag_mod.remove_edges_delta(
            self.state, self._keys(us), self._keys(vs), valid=valid)
        cache, stats = self._commit_cache(state, delta)
        res = OpResult(ok, self._overflow_delta(state), stats)
        return self._with_state(state, cache), res, delta

    # ------------------------------------------------- wait-free reads

    def contains(self, keys) -> torch.Tensor:
        """ContainsVertex batch -> bool[B]."""
        return dag_mod.contains_vertices(self.state, self._keys(keys))

    def contains_edges(self, us, vs) -> torch.Tensor:
        return dag_mod.contains_edges(self.state, self._keys(us),
                                      self._keys(vs))

    def reachable(self, from_keys, to_keys) -> torch.Tensor:
        """Batch PathExists(from, to): True iff a path of >= 1 edge exists.
        A pinned "incremental" engine reads its clean cache (B bit reads);
        otherwise the policy picks the full or the early-exit scan."""
        cfg = self.config
        from_keys, to_keys = self._keys(from_keys), self._keys(to_keys)
        b = from_keys.shape[0]
        fixed = getattr(cfg.policy, "fixed_method", None)
        if fixed == "incremental":
            if self.cache.dirty:
                # reads cannot return a rebuilt engine: full scan instead
                return reachability.path_exists(self.state, from_keys,
                                                to_keys, cfg.matmul_impl)
            f_slot, f_found = dag_mod.lookup_slots(self.state, from_keys)
            t_slot, t_found = dag_mod.lookup_slots(self.state, to_keys)
            return f_found & t_found & closure_cache.closure_bit_get(
                self.cache.closure, f_slot, t_slot)
        if fixed == "closure":
            return reachability.path_exists(self.state, from_keys, to_keys,
                                            cfg.matmul_impl)
        if fixed == "partial" or bool(cfg.policy.prefer_partial(
                self.state.adj, b, depth_hint=self.depth_ema)):
            return snapshot.path_exists_partial(self.state, from_keys,
                                                to_keys, cfg.matmul_impl)
        return reachability.path_exists(self.state, from_keys, to_keys,
                                        cfg.matmul_impl)

    def is_acyclic(self) -> torch.Tensor:
        """True iff the graph has no cycle.  On the tiled layout, when every
        edge lies in the window, only the window is squared (its cycles
        are all the graph's): the answer is the reference's, without
        squaring the whole slab."""
        adj, region = self.state.adj, self.closure_region
        if region is not None and closure_cache.region_confined(adj, region):
            adj = closure_cache.region_window(adj, region)
        return reachability.is_acyclic(adj, self.config.matmul_impl)

    def live_vertex_count(self) -> torch.Tensor:
        return dag_mod.live_vertex_count(self.state)

    def edge_count(self) -> torch.Tensor:
        return dag_mod.edge_count(self.state)

    # ------------------------------------------------- mixed-op batches

    def apply(self, batch: OpBatch, acyclic: bool = True):
        """Apply a typed mixed batch -> (engine, OpResult), with the
        documented linearization.  ``acyclic=False`` degrades ADD_EDGE
        rows to plain directed-graph inserts."""
        batch = OpBatch(*(self._keys(x) for x in batch))
        if self.closure_region is not None:
            self = self._pre_widened(
                int(torch.sum(batch.op == ADD_VERTEX)))
        cfg = self.config
        method, prefer = self._dispatch_hooks()
        common = dict(acyclic=acyclic, subbatches=cfg.subbatches,
                      method=method, matmul_impl=cfg.matmul_impl,
                      with_stats=True, prefer_partial_fn=prefer,
                      n_shards=cfg.n_devices)
        if acyclic and self._cache_aware(method):
            state, ok, cache, stats = dag_mod.apply_op_batch_impl(
                self.state, batch.op, batch.a, batch.b, cache=self.cache,
                closure_update_impl=cfg.closure_update_impl,
                closure_delete_impl=cfg.closure_delete_impl,
                prefer_repair_fn=self._prefer_repair_fn(),
                prefer_incremental_fn=getattr(cfg.policy,
                                              "prefer_incremental", None),
                **common)
        else:
            state, ok, stats = dag_mod.apply_op_batch_impl(
                self.state, batch.op, batch.a, batch.b, **common)
            cache = self._invalidated_cache(state)
        res = OpResult(ok, self._overflow_delta(state),
                       ReachStats.from_raw(stats))
        grown = self._grown_for_overflow(res)
        if grown is not None:
            return grown.apply(batch, acyclic=acyclic)
        return self._with_state(state, cache,
                                stats if acyclic else None), res
