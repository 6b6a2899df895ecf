"""Deterministic fault injection for the replication + serving stack.

Port of `repro.ft.faults` (numpy only): the same plans, the same rng
draws in the same order, so a seed injects the same faults at the same
call sites in both packages.

The paper's claim is progress under adversity — non-blocking acyclicity
maintenance that stays correct no matter how threads interleave.  Our
distributed analog (`repro_torch.replica`, `repro_torch.serve`) must
make the same promise against the faults a serving deployment actually
sees.  This module is the adversary: a seeded `FaultPlan` that injects,
at explicit call sites in the stack,

  * torn / truncated `save_delta_log` writes (file cut at a random byte),
  * bit flips in saved log files and checkpoint base images (bit rot),
  * bit flips in shipped `LogEntry` payloads (corruption in transit),
  * dropped / duplicated / reordered entries in replica shipping,
  * replica stalls (a real `time.sleep`, tripping real timeout logic),
  * a crash at an arbitrary point inside `Primary.flush` (a durable
    prefix of the tick's entries survives; the rest is lost).

Every injection is deterministic in ``(seed, spec, call order)`` and is
recorded in ``plan.injected`` AND logged with the plan's seed + the
injection site, so any failure a fault surfaces replays exactly from
``FaultPlan(seed, spec)`` (or `launch/serve.py --profile chaos
--fault-seed N`).

The plan mutates nothing by itself — the stack calls it at the seams:
`Primary.flush` consults `crash_index`, the shipping path routes entries
through `perturb_entries`, the disk layer calls `corrupt_log_file` /
`corrupt_checkpoint` after a save, and the front-end's replica advance
consults `maybe_stall`.  Code under test is the REAL hardened stack; the
plan only decides where it hurts.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


class InjectedCrash(RuntimeError):
    """A `FaultPlan`-injected process crash (e.g. mid-`Primary.flush`).

    Raised from the injection site; the caller catches it and
    "restarts" from durable state (checkpoint base image + on-disk log).
    """


class Fault(NamedTuple):
    """One injection that actually fired: what, where, and the detail
    needed to reason about the blast radius."""

    kind: str    # "torn_write" | "bit_flip_file" | ... (spec field name)
    site: str    # call site, e.g. "save_delta_log:/tmp/x/log.bin"
    detail: str  # human-readable specifics (offset, entry index, ...)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-site injection probabilities (all default 0 = no faults).

    Probabilities are evaluated independently at each call site visit
    with the plan's own rng, so a fixed seed gives one reproducible
    fault schedule per spec."""

    torn_write: float = 0.0      # truncate a just-saved log file
    bit_flip_file: float = 0.0   # flip one bit of a saved log file
    bit_flip_ckpt: float = 0.0   # flip one bit of a checkpoint arrays.npz
    bit_flip_entry: float = 0.0  # flip one byte of a shipped LogEntry
    drop_entry: float = 0.0      # drop one shipped entry
    dup_entry: float = 0.0       # duplicate one shipped entry
    reorder: float = 0.0         # swap two adjacent shipped entries
    stall: float = 0.0           # stall a replica advance
    crash_flush: float = 0.0     # crash inside Primary.flush
    stall_s: float = 0.05        # how long an injected stall sleeps

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "stall_s":
                if v < 0:
                    raise ValueError(f"stall_s must be >= 0, got {v}")
            elif not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"{f.name} is a probability in [0, 1], got {v}")


# Named plans for `launch/serve.py --profile chaos --fault-plan NAME` and
# the fixed-seed CI corpus: each stresses one seam hard, plus a
# kitchen-sink mix that exercises every detection path at once.
NAMED_PLANS: Dict[str, FaultSpec] = {
    "none": FaultSpec(),
    "torn-tail": FaultSpec(torn_write=0.5),
    "bitflip-log": FaultSpec(bit_flip_file=0.5),
    "bitflip-ckpt": FaultSpec(bit_flip_ckpt=0.5),
    "ship-chaos": FaultSpec(bit_flip_entry=0.15, drop_entry=0.15,
                            dup_entry=0.15, reorder=0.15),
    "stall-resync": FaultSpec(stall=0.4, stall_s=0.02),
    "crash-flush": FaultSpec(crash_flush=0.25),
    "kitchen-sink": FaultSpec(torn_write=0.15, bit_flip_file=0.1,
                              bit_flip_ckpt=0.1, bit_flip_entry=0.1,
                              drop_entry=0.1, dup_entry=0.1, reorder=0.1,
                              stall=0.1, crash_flush=0.1, stall_s=0.01),
}


def plan(seed: int, name_or_spec="kitchen-sink") -> "FaultPlan":
    """`FaultPlan` from a seed and a named plan (see `NAMED_PLANS`) or an
    explicit `FaultSpec`."""
    if isinstance(name_or_spec, FaultSpec):
        return FaultPlan(seed, name_or_spec)
    from repro_torch.core.dispatch import validate_choice
    validate_choice(name_or_spec, tuple(NAMED_PLANS), what="fault plan")
    return FaultPlan(seed, NAMED_PLANS[name_or_spec])


class FaultPlan:
    """A seeded, deterministic schedule of injections.

    One rng drives every site, so the schedule is a pure function of
    ``(seed, spec)`` and the order the stack visits the sites in —
    re-running the same workload with the same plan reproduces the same
    faults at the same places.
    """

    def __init__(self, seed: int, spec: FaultSpec = FaultSpec()):
        self.seed = int(seed)
        self.spec = spec
        self.injected: List[Fault] = []
        self._rng = np.random.default_rng(self.seed)

    def __repr__(self):
        return (f"FaultPlan(seed={self.seed}, spec={self.spec}, "
                f"injected={len(self.injected)})")

    def report(self) -> str:
        """The reproduction header every failure should carry."""
        lines = [f"FaultPlan seed={self.seed} "
                 f"({len(self.injected)} faults injected)"]
        lines += [f"  [{f.kind}] at {f.site}: {f.detail}"
                  for f in self.injected]
        return "\n".join(lines)

    # ------------------------------------------------------------ internals

    def _chance(self, p: float) -> bool:
        # always draw when the arm is armed, so the schedule depends only
        # on (seed, spec, visit order) — not on earlier hits/misses
        return p > 0.0 and bool(self._rng.random() < p)

    def _fire(self, kind: str, site: str, detail: str) -> Fault:
        fault = Fault(kind, site, detail)
        self.injected.append(fault)
        logger.warning("FaultPlan(seed=%d) injected %s at %s: %s",
                       self.seed, kind, site, detail)
        return fault

    # ------------------------------------------------------- disk artifacts

    def corrupt_log_file(self, path: str) -> List[Fault]:
        """Maybe tear (truncate) and/or bit-flip a just-saved delta log.

        A torn write models a crash mid-`os.replace` target flush: the
        file ends at an arbitrary byte.  The hardened `load_delta_log`
        must truncate to the last valid entry (prefix property), never
        invent or reorder entries."""
        applied: List[Fault] = []
        size = os.path.getsize(path)
        site = f"save_delta_log:{path}"
        if self._chance(self.spec.torn_write) and size > 1:
            cut = int(self._rng.integers(1, size))
            with open(path, "r+b") as f:
                f.truncate(cut)
            applied.append(self._fire(
                "torn_write", site, f"truncated {size} -> {cut} bytes"))
            size = cut
        if self._chance(self.spec.bit_flip_file) and size > 0:
            off = int(self._rng.integers(0, size))
            bit = int(self._rng.integers(0, 8))
            with open(path, "r+b") as f:
                f.seek(off)
                byte = f.read(1)[0]
                f.seek(off)
                f.write(bytes([byte ^ (1 << bit)]))
            applied.append(self._fire(
                "bit_flip_file", site, f"flipped bit {bit} of byte {off}"))
        return applied

    def corrupt_checkpoint(self, directory: str,
                           step: Optional[int] = None) -> List[Fault]:
        """Maybe flip one bit of a checkpoint's ``arrays.npz`` (the
        newest step unless given).  The hardened restore must refuse the
        image (`CorruptCheckpointError`) so recovery falls back to an
        older valid base instead of resurrecting garbage state."""
        if not self._chance(self.spec.bit_flip_ckpt):
            return []
        from repro_torch.ft import checkpoint as ckpt
        if step is None:
            step = ckpt.latest_step(directory)
        if step is None:
            return []
        path = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
        size = os.path.getsize(path)
        if size == 0:
            return []
        off = int(self._rng.integers(0, size))
        bit = int(self._rng.integers(0, 8))
        with open(path, "r+b") as f:
            f.seek(off)
            byte = f.read(1)[0]
            f.seek(off)
            f.write(bytes([byte ^ (1 << bit)]))
        return [self._fire("bit_flip_ckpt", f"checkpoint:{path}",
                           f"flipped bit {bit} of byte {off}")]

    # ----------------------------------------------------- entry shipping

    def perturb_entries(self, entries: Sequence, site: str):
        """The lossy/disordered shipping channel: maybe drop, duplicate,
        adjacent-swap, or payload-corrupt the entries of one shipment.

        Returns ``(entries, faults)``.  Corruption deep-copies the hit
        entry's arrays — the primary's own log is never mutated."""
        out = list(entries)
        applied: List[Fault] = []
        if self._chance(self.spec.drop_entry) and out:
            i = int(self._rng.integers(0, len(out)))
            dropped = out.pop(i)
            applied.append(self._fire(
                "drop_entry", site,
                f"dropped entry {i} (epoch {int(dropped.epoch)})"))
        if self._chance(self.spec.dup_entry) and out:
            i = int(self._rng.integers(0, len(out)))
            out.insert(i + 1, out[i])
            applied.append(self._fire(
                "dup_entry", site,
                f"duplicated entry {i} (epoch {int(out[i].epoch)})"))
        if self._chance(self.spec.reorder) and len(out) >= 2:
            i = int(self._rng.integers(0, len(out) - 1))
            out[i], out[i + 1] = out[i + 1], out[i]
            applied.append(self._fire(
                "reorder", site, f"swapped entries {i} and {i + 1}"))
        if self._chance(self.spec.bit_flip_entry) and out:
            i = int(self._rng.integers(0, len(out)))
            out[i], fault = self._flip_entry_payload(out[i], site, i)
            applied.append(fault)
        return out, applied

    def _flip_entry_payload(self, entry, site: str, index: int):
        """Flip one byte in one of the entry's delta arrays (or its
        epoch metadata) — the per-entry CRC must catch it."""
        delta = entry.delta
        # candidate arrays with at least one byte
        arrays = [(name, np.asarray(v)) for name, v in
                  zip(type(delta)._fields, delta)]
        nonempty = [(n, a) for n, a in arrays if a.nbytes > 0]
        if not nonempty or self._rng.random() < 0.25:
            # corrupt the epoch itself instead
            bad = entry._replace(epoch=int(entry.epoch) + 1_000_000)
            return bad, self._fire("bit_flip_entry", site,
                                   f"corrupted epoch of entry {index}")
        name, arr = nonempty[int(self._rng.integers(0, len(nonempty)))]
        raw = bytearray(arr.tobytes())
        off = int(self._rng.integers(0, len(raw)))
        bit = int(self._rng.integers(0, 8))
        raw[off] ^= 1 << bit
        flipped = np.frombuffer(bytes(raw), dtype=arr.dtype)
        flipped = flipped.reshape(arr.shape)
        fields = dict(zip(type(delta)._fields, delta))
        fields[name] = flipped
        fault = self._fire("bit_flip_entry", site,
                           f"flipped bit {bit} of byte {off} in entry "
                           f"{index}.{name}")
        return entry._replace(delta=type(delta)(**fields)), fault

    # ------------------------------------------------------------- timing

    def maybe_stall(self, site: str) -> bool:
        """Maybe sleep ``spec.stall_s`` — a stalled replica advance.  The
        caller's REAL timeout machinery must notice; nothing is faked."""
        if not self._chance(self.spec.stall):
            return False
        self._fire("stall", site, f"slept {self.spec.stall_s:.3f}s")
        time.sleep(self.spec.stall_s)
        return True

    # -------------------------------------------------------------- crash

    def crash_index(self, n: int, site: str) -> Optional[int]:
        """Maybe pick an index in ``[0, n)`` at which `Primary.flush`
        crashes (entries before it shipped durably; it and everything
        after are lost).  None = no crash this flush."""
        if n <= 0 or not self._chance(self.spec.crash_flush):
            return None
        i = int(self._rng.integers(0, n))
        self._fire("crash_flush", site, f"crash before entry {i} of {n}")
        return i
