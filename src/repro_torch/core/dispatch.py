"""Adaptive reachability dispatch — `method="auto"`, in torch.

Port of `repro.core.dispatch` (see its module docstring for the cost
model).  In short, in boolean-matmul row-products:

  closure (algorithm 1):  C * ceil(log2 C)                 — exact
  partial (algorithm 2):  B * est_depth                    — estimated
  incremental:            0 against a clean cache
  delete repair:          n_affected * repair_depth vs the rebuild's
                          C * ceil(log2 C)

The constants are the reference's, unchanged.  Every estimate is
computed in float32 on CPU scalar tensors (the decision inputs that live
on a card are copied over first), so the port picks the same arm as the
reference and a card run picks the same arm as a CPU run.  Predicates
return a 0-d bool tensor, or a Python bool where the input is already a
host value.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

import torch

from repro_torch.core import bitset

METHODS = ("closure", "partial", "auto", "incremental")

# FixedPolicy can pin any concrete algorithm (everything except "auto")
FIXED_METHODS = ("closure", "partial", "incremental")

# Bias toward the closure's predictable cost unless the partial estimate
# wins by this factor.
SAFETY_FACTOR = 2.0

# B-sharding needs at least this many query rows per device.
MIN_ROWS_PER_SHARD = 8


def _f32(x) -> torch.Tensor:
    """A float32 CPU tensor of ``x`` (a number or a tensor on any device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device="cpu", dtype=torch.float32)
    return torch.tensor(x, dtype=torch.float32)


def ceil_log2(n: int) -> int:
    """ceil(log2 n), floored at 1 — the closure's squaring iteration count."""
    from repro_torch.core.reachability import closure_iteration_bound

    return closure_iteration_bound(n)


def closure_row_products(capacity: int) -> int:
    """Exact worst-case row-products of algorithm 1 (full closure)."""
    return capacity * ceil_log2(capacity)


def mean_out_degree(adj_packed: torch.Tensor) -> torch.Tensor:
    """Density estimate: mean out-degree over the capacity slab (one
    popcount over the packed adjacency), float32 on the CPU."""
    c = adj_packed.shape[0]
    edges = torch.sum(bitset.popcount(adj_packed), dtype=torch.int32)
    return _f32(edges) / c


def estimate_deciding_depth(capacity: int, out_degree) -> torch.Tensor:
    """Estimated frontier hops until a partial scan decides:
    clip(ceil(log2 C / log2(max(d, 2))), 1, ceil(log2 C))."""
    log2c = ceil_log2(capacity)
    branching = torch.clamp(_f32(out_degree), min=2.0)
    depth = torch.ceil(log2c / torch.log2(branching))
    return torch.clamp(depth, 1.0, float(log2c))


def partial_row_products(batch: int, capacity: int,
                         out_degree) -> torch.Tensor:
    """Estimated row-products of algorithm 2 for a B-row candidate batch."""
    return batch * estimate_deciding_depth(capacity, out_degree)


def prefer_partial(batch: int, capacity: int, out_degree) -> torch.Tensor:
    """True iff the cost model picks algorithm 2."""
    est = SAFETY_FACTOR * partial_row_products(batch, capacity, out_degree)
    return est <= closure_row_products(capacity)


def prefer_partial_from_adj(adj_packed: torch.Tensor,
                            batch: int) -> torch.Tensor:
    """`prefer_partial` with the density read off the packed adjacency."""
    return prefer_partial(batch, adj_packed.shape[0],
                          mean_out_degree(adj_packed))


def choose_method(batch: int, capacity: int, out_degree: float) -> str:
    """Concrete dispatch: "partial" or "closure"."""
    return "partial" if bool(prefer_partial(batch, capacity, out_degree)) \
        else "closure"


def prefer_partial_with_depth(batch: int, capacity: int, depth_est,
                              safety_factor: float = SAFETY_FACTOR
                              ) -> torch.Tensor:
    """`prefer_partial` with an explicit deciding-depth estimate, clipped
    to [1, ceil(log2 C)] like the density-derived estimate."""
    log2c = ceil_log2(capacity)
    depth = torch.clamp(_f32(depth_est), 1.0, float(log2c))
    est = safety_factor * batch * depth
    return est <= closure_row_products(capacity)


def delete_repair_row_products(n_affected, capacity: int,
                               depth_est) -> torch.Tensor:
    """Estimated row-products of the masked affected-row re-derivation."""
    log2c = ceil_log2(capacity)
    depth = torch.clamp(_f32(depth_est), 1.0, float(log2c))
    return _f32(n_affected) * depth


def prefer_delete_repair(n_affected, capacity: int, depth_hint=None,
                         safety_factor: float = SAFETY_FACTOR
                         ) -> torch.Tensor:
    """True iff a delete should be maintained by affected-row
    re-derivation rather than invalidating the cache.  ``depth_hint`` <= 0
    or None means unseeded: the conservative ceil(log2 C) bound."""
    log2c = ceil_log2(capacity)
    if depth_hint is None:
        depth = _f32(log2c)
    else:
        h = _f32(depth_hint)
        depth = torch.where(h > 0, torch.clamp(h, 1.0, float(log2c)),
                            _f32(log2c))
    est = safety_factor * delete_repair_row_products(n_affected, capacity,
                                                     depth)
    return est <= closure_row_products(capacity)


def occupied_tile_fraction(summary: torch.Tensor, region: int) -> torch.Tensor:
    """Fraction of 32x32 closure tiles holding any reachability bit, read
    off a block-occupancy summary bitmap (one popcount)."""
    n_tiles = max((region // bitset.WORD) ** 2, 1)
    occ = _f32(torch.sum(bitset.popcount(summary), dtype=torch.int32))
    return occ / n_tiles


def choose_scan_sharding(batch: int, capacity: int, n_devices: int) -> str:
    """Pick the sharded partial-scan schedule: "batch" or "frontier"."""
    del capacity  # present for signature stability; the rule is B vs mesh
    if (n_devices > 1 and batch % n_devices == 0
            and batch // n_devices >= MIN_ROWS_PER_SHARD):
        return "batch"
    return "frontier"


# --------------------------------------------------------------- policies

@runtime_checkable
class DispatchPolicy(Protocol):
    """What `core/engine.py` needs from a dispatch policy.  ``fixed_method``
    is None for adaptive policies or a pinned method name."""

    fixed_method: Optional[str]

    def prefer_partial(self, adj_packed: torch.Tensor, batch: int,
                       depth_hint=None) -> torch.Tensor:
        ...

    def scan_sharding(self, batch: int, capacity: int,
                      n_devices: int) -> str:
        ...


@dataclasses.dataclass(frozen=True)
class CostModelPolicy:
    """The cost model as a policy object (the ``method="auto"`` default).
    A measured deciding-depth EMA from the engine replaces the static
    popcount-density depth guess; ``ema_alpha`` is the smoothing weight."""

    safety_factor: float = SAFETY_FACTOR
    ema_alpha: float = 0.25
    use_incremental: bool = True
    use_delete_repair: bool = True
    fixed_method: Optional[str] = dataclasses.field(default=None, init=False)

    def prefer_partial(self, adj_packed: torch.Tensor, batch: int,
                       depth_hint=None) -> torch.Tensor:
        capacity = adj_packed.shape[0]
        est = estimate_deciding_depth(capacity, mean_out_degree(adj_packed))
        if depth_hint is not None:
            # dispatch on the deepest measured shard; unmeasured shards
            # (0) drop out of the max
            measured = torch.max(_f32(depth_hint))
            est = torch.where(measured > 0, measured, est)
        return prefer_partial_with_depth(batch, capacity, est,
                                         self.safety_factor)

    def prefer_incremental(self, cache_dirty: bool) -> bool:
        """A clean cache turns the whole check into B^2 bit reads plus a
        B x B closure, so "clean" IS the decision."""
        return self.use_incremental and not cache_dirty

    def prefer_delete_repair(self, n_affected, capacity: int,
                             depth_hint=None):
        if not self.use_delete_repair:
            return False
        return prefer_delete_repair(n_affected, capacity, depth_hint,
                                    self.safety_factor)

    def scan_sharding(self, batch: int, capacity: int,
                      n_devices: int) -> str:
        return choose_scan_sharding(batch, capacity, n_devices)

    def update_depth_ema(self, ema: torch.Tensor,
                         measured_depth: torch.Tensor) -> torch.Tensor:
        """Fold one measured deciding depth (int32; 0 == no partial check
        ran) into the engine's EMA (float32; 0 == unseeded)."""
        d = _f32(measured_depth)
        blended = torch.where(
            ema > 0, (1.0 - self.ema_alpha) * ema + self.ema_alpha * d, d)
        return torch.where(d > 0, blended, ema)


@dataclasses.dataclass(frozen=True)
class FixedPolicy:
    """Pin one concrete algorithm: "closure", "partial" or "incremental".
    ``use_delete_repair`` governs the "incremental" delete path only."""

    method: str
    use_delete_repair: bool = True

    def __post_init__(self):
        if self.method not in FIXED_METHODS:
            raise ValueError(
                f"FixedPolicy method must be one of {FIXED_METHODS}, "
                f"got {self.method!r}")

    @property
    def fixed_method(self) -> str:
        return self.method

    def prefer_partial(self, adj_packed: torch.Tensor, batch: int,
                       depth_hint=None) -> torch.Tensor:
        del adj_packed, batch, depth_hint
        return torch.tensor(self.method == "partial")

    def prefer_delete_repair(self, n_affected, capacity: int,
                             depth_hint=None):
        if not self.use_delete_repair:
            return False
        return prefer_delete_repair(n_affected, capacity, depth_hint)

    def scan_sharding(self, batch: int, capacity: int,
                      n_devices: int) -> str:
        return choose_scan_sharding(batch, capacity, n_devices)

    def update_depth_ema(self, ema: torch.Tensor,
                         measured_depth: torch.Tensor) -> torch.Tensor:
        d = _f32(measured_depth)
        return torch.where(d > 0, d, ema)


def method_name(policy: DispatchPolicy) -> str:
    """The method string a policy realizes (its pinned algorithm, or
    "auto")."""
    return getattr(policy, "fixed_method", None) or "auto"


def validate_choice(value: str, valid, what: str = "value") -> None:
    """Raise ValueError unless ``value`` is one of ``valid``, naming the
    nearest valid name in the message."""
    valid = tuple(valid)
    if value in valid:
        return
    import difflib
    near = difflib.get_close_matches(str(value), [str(v) for v in valid],
                                     n=1, cutoff=0.4)
    hint = f"; nearest valid {what} is {near[0]!r}" if near else ""
    raise ValueError(
        f"{what} must be one of {valid}, got {value!r}{hint}")


def validate_method(method: str, what: str = "method") -> None:
    """Raise ValueError unless ``method`` is one of `METHODS`."""
    validate_choice(method, METHODS, what=what)


def policy_for_method(method: str,
                      policy: Optional[DispatchPolicy] = None):
    """Resolve the (method, policy) pair of `DagEngine.create`: an explicit
    policy wins; otherwise "auto" gets the cost model and a fixed method
    gets pinned."""
    if policy is not None:
        return policy
    validate_method(method)
    if method == "auto":
        return CostModelPolicy()
    return FixedPolicy(method)
