"""Serving drivers, in torch.

Port of `repro.launch.serve`'s SGT half — the paper's end-to-end
application, an SGT transaction scheduler serving batched
begin / conflict / finish requests on the concurrent acyclic DAG, with
the reference's deterministic numpy request streams, so the same seed
gives the same workload in both packages — with its replicated-read,
front-end and chaos profiles, and of its LM mode (`serve_lm`: prefill,
then greedy decode).

    python -m repro_torch.launch.serve --profile delheavy \\
        --capacity 16384 --batch 1024
    python -m repro_torch.launch.serve --mode lm --arch qwen2-1.5b \\
        --width full --batch 4
    python -m repro_torch.launch.serve --profile chaos --capacity 2048 \\
        --batch 256 --ticks 10 --fault-plan kitchen-sink --fault-seed 11

Runs on the card unless ``--device cpu`` is given.  A tick ends in a
device synchronisation, so the tick times are wall times of finished
work.  The reference jits its tick bodies; the port's run inside
`core.engine.as_compiled`, so a tiled closure window keeps its size for
the whole run, as the reference's does.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core import closure_cache
from repro_torch.core.dispatch import METHODS, FixedPolicy, validate_choice
from repro_torch.core.engine import DagEngine, as_compiled, resolve_device

PROFILES = ("steady", "insheavy", "delheavy", "mixed", "paired", "read",
            "frontend", "chaos")


def _sgt_tick_inputs(capacity: int, batch: int, ticks: int, seed: int):
    """Deterministic per-tick request streams (begins, conflict pairs,
    finishes) as numpy int32 arrays — the reference's stream."""
    rng = np.random.default_rng(seed)
    next_txn = 0
    live: list[int] = []
    inputs = []
    for t in range(ticks):
        n_begin = batch // 4
        begins = np.arange(next_txn, next_txn + n_begin, dtype=np.int32)
        next_txn += n_begin
        live.extend(int(x) for x in begins)
        pool = np.asarray(live[-capacity // 2:], np.int32)
        src = rng.choice(pool, batch // 2).astype(np.int32)
        dst = rng.choice(pool, batch // 2).astype(np.int32)
        n_fin = batch // 4
        fin_idx = rng.choice(len(live), min(n_fin, len(live)), replace=False)
        fins = np.full(n_fin, -1, np.int32)
        fins[:len(fin_idx)] = [live[i] for i in fin_idx]
        for i in sorted(fin_idx, reverse=True):
            live.pop(i)
        inputs.append((begins, src, dst, fins))
    return inputs


def _sgt_insert_heavy_inputs(capacity: int, batch: int, ticks: int,
                             seed: int):
    """Insert-heavy stream: begins + conflicts, NO retirements (the
    reference's stream)."""
    rng = np.random.default_rng(seed)
    pool = capacity // 2
    inputs = []
    for t in range(ticks):
        n_begin = batch // 4
        begins = (np.arange(n_begin, dtype=np.int32)
                  + t * n_begin) % pool  # re-beginning a live txn is a no-op
        src = rng.integers(0, pool, batch // 2).astype(np.int32)
        dst = rng.integers(0, pool, batch // 2).astype(np.int32)
        inputs.append((begins, src, dst))
    return inputs


def _sgt_churn_inputs(capacity: int, batch: int, ticks: int, seed: int,
                      profile: str):
    """Deterministic delete-heavy / mixed streams (the reference's):
    forward-ordered conflict edges (no insert can close a cycle) and a
    host mirror of the live edge set, so removals target real edges."""
    validate_choice(profile, ("delheavy", "mixed"), what="churn profile")
    rng = np.random.default_rng(seed)
    pool = capacity // 2
    if profile == "delheavy":
        n_begin, n_ins = batch // 8, 3 * batch // 8
        n_del, n_fin = 3 * batch // 8, batch // 8
    else:
        n_begin = n_ins = n_del = n_fin = batch // 4
    live_keys: set = set()
    edge_set: set = set()
    inputs = []
    for t in range(ticks):
        begins = (np.arange(n_begin, dtype=np.int32) + t * n_begin) % pool
        live_keys.update(int(k) for k in begins)
        upper = max(2, min(pool, (t + 1) * n_begin))
        lo = rng.integers(0, upper - 1, n_ins).astype(np.int32)
        hi = rng.integers(lo + 1, upper).astype(np.int32)
        for u, v in zip(lo.tolist(), hi.tolist()):
            if u in live_keys and v in live_keys:
                edge_set.add((u, v))
        live_edges = sorted(edge_set)
        n_real = min(n_del, len(live_edges))
        pick = rng.choice(len(live_edges), n_real, replace=False)
        del_src = np.full(n_del, -1, np.int32)
        del_dst = np.full(n_del, -1, np.int32)
        for k, idx in enumerate(pick.tolist()):
            del_src[k], del_dst[k] = live_edges[idx]
            edge_set.discard(live_edges[idx])
        fins = rng.choice(upper, min(n_fin, upper), replace=False)
        fins_full = np.full(n_fin, -1, np.int32)
        fins_full[:len(fins)] = fins
        for f in fins.tolist():
            live_keys.discard(f)
            edge_set = {(u, v) for (u, v) in edge_set if u != f and v != f}
        inputs.append((begins, lo, hi, del_src, del_dst, fins_full))
    return inputs


def steady_tick(eng: DagEngine, xs):
    """One steady SGT tick on a raw engine session: begins, cycle-checked
    conflicts, retirement of the aborted sources, finishes.  Returns
    (engine, (begin, conflict, abort, finish) `OpResult`s)."""
    begins, src, dst, fins = xs
    with as_compiled():
        eng, began = eng.add_vertices(begins)
        eng, conf = eng.add_edges_acyclic(src, dst)
        live = eng.contains(src) & eng.contains(dst)
        eng, rem = eng.remove_vertices(src, valid=live & ~conf.ok)
        eng, fin = eng.remove_vertices(fins)
    return eng, (began, conf, rem, fin)


def insert_heavy_tick(eng: DagEngine, xs):
    """One insert-heavy tick: begins + cycle-checked conflicts.  Returns
    (engine, (begin, conflict) `OpResult`s)."""
    begins, src, dst = xs
    with as_compiled():
        eng, began = eng.add_vertices(begins)
        eng, conf = eng.add_edges_acyclic(src, dst)
    return eng, (began, conf)


def churn_tick(eng: DagEngine, xs):
    """One delete-heavy / mixed tick: begins, conflicts, conflict-edge
    retirements, finishes.  Returns (engine, (begin, conflict, removal,
    finish) `OpResult`s)."""
    begins, src, dst, del_src, del_dst, fins = xs
    with as_compiled():
        eng, began = eng.add_vertices(begins)
        eng, conf = eng.add_edges_acyclic(src, dst)
        eng, rem = eng.remove_edges(del_src, del_dst)
        eng, fin = eng.remove_vertices(fins)
    return eng, (began, conf, rem, fin)


def primary_steady_tick(p, xs):
    """`steady_tick` through a replication writer (`replica.Primary`), so
    every phase lands in its log.  Returns the four `OpResult`s."""
    begins, src, dst, fins = xs
    began = p.add_vertices(begins)
    conf = p.add_edges_acyclic(src, dst)
    live = p.engine.contains(src) & p.engine.contains(dst)
    rem = p.remove_vertices(src, valid=live & ~conf.ok)
    fin = p.remove_vertices(fins)
    return began, conf, rem, fin


def primary_churn_tick(p, xs):
    """`churn_tick` through a replication writer (`replica.Primary`).
    Returns the four `OpResult`s."""
    begins, src, dst, del_src, del_dst, fins = xs
    return (p.add_vertices(begins), p.add_edges_acyclic(src, dst),
            p.remove_edges(del_src, del_dst), p.remove_vertices(fins))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def on_device(device: torch.device, xs):
    """A tick's numpy inputs as int32 tensors on ``device``."""
    return tuple(torch.as_tensor(x, dtype=torch.int32, device=device)
                 for x in xs)


def _sgt_driver(capacity: int, subbatches: int, method: str,
                device: torch.device, auto_grow: bool = False):
    """(carry0, tick, finalize) for the `core/sgt.schedule_tick` surface."""
    from repro_torch.core import sgt

    carry0 = sgt.new_scheduler(capacity, method=method,
                               subbatches=subbatches, device=device)
    overflow_mark = [0]

    def tick(st, xs):
        st = sgt.schedule_tick(st, *xs)[0]
        if auto_grow:
            st, overflow_mark[0] = sgt.maybe_grow(st, overflow_mark[0])
        return st

    def finalize(st):
        return {"begun": int(st.n_begun), "committed": int(st.n_committed),
                "aborted": int(st.n_aborted),
                "depth_ema": float(torch.max(st.engine.depth_ema)),
                "engine": st.engine}

    return carry0, tick, finalize


def _engine_driver(capacity: int, subbatches: int, method: str,
                   device: torch.device, auto_grow: bool = False):
    """(carry0, tick, finalize) for the raw `DagEngine` session surface:
    begins, cycle-checked conflicts with abort-retire, finishes."""
    eng = DagEngine.create(capacity, method=method, subbatches=subbatches,
                           device=device)
    z = torch.zeros((), dtype=torch.int32, device=device)
    carry0 = (eng, z, z, z)  # engine, n_begun, n_committed, n_aborted
    overflow_mark = [0]

    def tick(carry, xs):
        eng, n_begun, n_committed, n_aborted = carry
        eng, (began, _, rem, fin) = steady_tick(eng, xs)
        if auto_grow:
            seen = int(eng.state.n_overflow)
            if seen > overflow_mark[0]:
                eng = eng.grow(eng.capacity * 2)
                overflow_mark[0] = seen
        return (eng,
                n_begun + torch.sum(began.ok, dtype=torch.int32),
                n_committed + torch.sum(fin.ok, dtype=torch.int32),
                n_aborted + torch.sum(rem.ok, dtype=torch.int32))

    def finalize(carry):
        eng, n_begun, n_committed, n_aborted = carry
        return {"begun": int(n_begun), "committed": int(n_committed),
                "aborted": int(n_aborted),
                "depth_ema": float(torch.max(eng.depth_ema)),
                "engine": eng}

    return carry0, tick, finalize


def _timed(tick, carry, inputs, device):
    """Run the ticks, each ending in a device synchronisation; returns
    (carry, per-tick seconds, per-tick tick outputs)."""
    times, outs = [], []
    for xs in inputs:
        t1 = time.perf_counter()
        carry, out = tick(carry, on_device(device, xs))
        _sync(device)
        times.append(time.perf_counter() - t1)
        outs.append(out)
    return carry, times, outs


def _warm_inputs(batch: int):
    """Dummy inputs of the steady tick's shapes, for an untimed warm-up
    tick (the kernels build and load there)."""
    return (np.zeros(batch // 4, np.int32), np.zeros(batch // 2, np.int32),
            np.zeros(batch // 2, np.int32), np.full(batch // 4, -1, np.int32))


def _summarize(label: str, method: str, stats: dict, tick_times, batch: int,
               ticks: int, dt: float) -> dict:
    """Throughput from the median tick (and the best tick), as the
    reference reports it."""
    med = float(np.median(tick_times))
    out = {"ticks": ticks, "ops_per_s": batch / med,
           "best_ops_per_s": batch / float(min(tick_times)),
           "tick_us": med * 1e6,
           "abort_rate": float(stats["aborted"] / max(1, stats["begun"])),
           **stats}
    print(f"[{label}:{method}] {batch * ticks} ops in {dt:.2f}s -> "
          f"{out['ops_per_s']:.0f} ops/s (median tick); "
          f"began={out['begun']} committed={out['committed']} "
          f"aborted={out['aborted']} (abort rate {out['abort_rate']:.3f}, "
          f"depth_ema {out['depth_ema']:.2f})")
    return out


def serve_sgt(capacity: int = 1024, batch: int = 256, ticks: int = 50,
              subbatches: int = 1, seed: int = 0, method: str = "auto",
              api: str = "sgt", auto_grow: bool = False,
              device=None) -> dict:
    """Steady SGT serving: "sgt" drives `core/sgt.schedule_tick`, "engine"
    a raw `DagEngine` session with the same semantics.  One untimed warm-up
    tick on dummy inputs of the serving shapes precedes the timed window
    (the kernels build and load there).  The result holds the final
    engine under "engine"."""
    validate_choice(api, ("sgt", "engine"), what="api")
    device = resolve_device(device)
    driver = _engine_driver if api == "engine" else _sgt_driver
    label = "serve-sgt-engine" if api == "engine" else "serve-sgt"
    carry, step, finalize = driver(capacity, subbatches, method, device,
                                   auto_grow=auto_grow)
    inputs = _sgt_tick_inputs(capacity, batch, ticks, seed)
    step(carry, on_device(device, _warm_inputs(batch)))
    _sync(device)

    def tick(c, xs):
        return step(c, xs), None

    t0 = time.perf_counter()
    carry, tick_times, _ = _timed(tick, carry, inputs, device)
    dt = time.perf_counter() - t0
    return _summarize(label, method, finalize(carry), tick_times, batch,
                      ticks, dt)


def serve_sgt_paired(capacity: int = 1024, batch: int = 256,
                     ticks: int = 50, subbatches: int = 1, seed: int = 0,
                     method: str = "auto", device=None):
    """Run the `core/sgt` surface and the raw `DagEngine` session
    TICK-INTERLEAVED on the identical request stream and return
    (out_sgt, out_engine).  Each tick pair runs back to back under the
    same host contention, so the two paths' median ticks compare inside
    one call (two separate calls can land on different hosts)."""
    device = resolve_device(device)
    c_sgt, step_sgt, fin_sgt = _sgt_driver(capacity, subbatches, method,
                                           device)
    c_eng, step_eng, fin_eng = _engine_driver(capacity, subbatches, method,
                                              device)
    inputs = _sgt_tick_inputs(capacity, batch, ticks, seed)
    warm = on_device(device, _warm_inputs(batch))
    step_sgt(c_sgt, warm)
    step_eng(c_eng, warm)
    _sync(device)
    t_sgt, t_eng = [], []
    for xs in inputs:
        xs = on_device(device, xs)
        t1 = time.perf_counter()
        c_sgt = step_sgt(c_sgt, xs)
        _sync(device)
        t2 = time.perf_counter()
        c_eng = step_eng(c_eng, xs)
        _sync(device)
        t3 = time.perf_counter()
        t_sgt.append(t2 - t1)
        t_eng.append(t3 - t2)
    # each path's printed wall time is ITS OWN ticks' sum
    out_sgt = _summarize("serve-sgt", method, fin_sgt(c_sgt), t_sgt,
                         batch, ticks, sum(t_sgt))
    out_eng = _summarize("serve-sgt-engine", method, fin_eng(c_eng), t_eng,
                         batch, ticks, sum(t_eng))
    return out_sgt, out_eng


def serve_sgt_insert_heavy(capacity: int = 1024, batch: int = 256,
                           ticks: int = 30, seed: int = 0,
                           method: str = "incremental",
                           device=None) -> dict:
    """Insert-heavy SGT serving through a raw `DagEngine` session: begins +
    cycle-checked conflict inserts only, with the exact boolean-matmul
    row-products accumulated across all ticks.  The first tick also runs
    once, untimed, on the fresh engine as a warm-up."""
    device = resolve_device(device)
    eng = DagEngine.create(capacity, method=method, device=device)
    carry0 = (eng, 0, 0)  # engine, n_accepted, row_products

    def tick(carry, xs):
        eng, n_acc, rp = carry
        eng, (_, conf) = insert_heavy_tick(eng, xs)
        return (eng, n_acc + int(torch.sum(conf.ok)),
                rp + conf.stats.row_products), conf.ok

    inputs = _sgt_insert_heavy_inputs(capacity, batch, ticks, seed)
    tick(carry0, on_device(device, inputs[0]))
    _sync(device)
    (eng, n_acc, rp), tick_times, _ = _timed(tick, carry0, inputs, device)
    med = float(np.median(tick_times))
    # a tick here is begins + conflict inserts only (no finish phase)
    ops_per_tick = batch // 4 + batch // 2
    out = {"ticks": ticks, "ops_per_s": ops_per_tick / med,
           "tick_us": med * 1e6, "accepted": n_acc, "row_products": rp,
           "cache_clean": not eng.cache.dirty, "engine": eng}
    print(f"[serve-sgt-insheavy:{method}] {ops_per_tick * ticks} ops -> "
          f"{out['ops_per_s']:.0f} ops/s (median tick); "
          f"accepted={out['accepted']} row_products={out['row_products']} "
          f"cache_clean={out['cache_clean']}")
    return out


def serve_sgt_churn(capacity: int = 1024, batch: int = 256,
                    ticks: int = 30, seed: int = 0,
                    method: str = "incremental",
                    profile: str = "delheavy",
                    closure_layout: str = "dense",
                    closure_region: int = 0,
                    collect_decisions: bool = False,
                    device=None) -> dict:
    """Delete-heavy / mixed SGT serving through a raw `DagEngine` session:
    begins + cycle-checked conflict inserts + conflict-edge retirements +
    vertex finishes every tick, with the exact row-products (cycle
    checks, lazy rebuilds and delete repairs) accumulated.
    ``method="incremental_rebuild"`` pins the invalidate+rebuild baseline
    (`FixedPolicy("incremental", use_delete_repair=False)`).
    ``closure_layout`` / ``closure_region`` pick the cache representation;
    ``closure_bytes`` is the resident closure (tiles plus summary on the
    tiled layout).  With ``collect_decisions`` the result also holds every
    accept bit, in tick order."""
    device = resolve_device(device)
    kw = dict(closure_layout=closure_layout, closure_region=closure_region,
              device=device)
    if method == "incremental_rebuild":
        eng = DagEngine.create(
            capacity,
            policy=FixedPolicy("incremental", use_delete_repair=False), **kw)
    else:
        eng = DagEngine.create(capacity, method=method, **kw)
    carry0 = (eng, 0, 0, 0)  # engine, n_accepted, row_products, n_repairs

    def tick(carry, xs):
        eng, n_acc, rp, nr = carry
        eng, (_, conf, rem, fin) = churn_tick(eng, xs)
        rp += conf.stats.row_products + rem.stats.row_products \
            + fin.stats.row_products
        nr += rem.stats.n_repair + fin.stats.n_repair
        return (eng, n_acc + int(torch.sum(conf.ok)), rp, nr), conf.ok

    inputs = _sgt_churn_inputs(capacity, batch, ticks, seed, profile)
    tick(carry0, on_device(device, inputs[0]))
    _sync(device)
    (eng, n_acc, rp, nr), tick_times, oks = _timed(tick, carry0, inputs,
                                                   device)
    med = float(np.median(tick_times))
    out = {"ticks": ticks, "ops_per_s": batch / med, "tick_us": med * 1e6,
           "accepted": n_acc, "row_products": rp, "n_repairs": nr,
           "cache_clean": not eng.cache.dirty,
           "closure_bytes": closure_cache.closure_nbytes(eng.cache.closure),
           "engine": eng}
    if collect_decisions:
        out["decisions"] = np.concatenate([ok.cpu().numpy() for ok in oks])
    print(f"[serve-sgt-{profile}:{method}] {batch * ticks} ops -> "
          f"{out['ops_per_s']:.0f} ops/s (median tick); "
          f"accepted={out['accepted']} row_products={out['row_products']} "
          f"repairs={out['n_repairs']} cache_clean={out['cache_clean']}")
    return out


def serve_sgt_replicated(capacity: int = 1024, batch: int = 256,
                         ticks: int = 20, seed: int = 0,
                         replicas: int = 0, reads: int = 512,
                         method: str = "incremental", device=None) -> dict:
    """Read-serving throughput under the writer/reader split.

    One writer applies the steady SGT tick stream — UNTIMED, the same on
    every row.  The timed region per tick is the read path only:

      ``replicas=0``  one `DagEngine.reachable` batch of ``reads`` queries
                      against the live engine (the single-engine
                      baseline);
      ``replicas=N``  one `DagEngine.snapshot()` take + N independent read
                      batches of ``reads`` queries answered by
                      `EngineSnapshot.reachable` (closure bit lookups,
                      zero row products — asserted at the end).

    ops/s is aggregate reader throughput (``N * reads`` queries a tick).
    The writer runs method-pinned "incremental" so the closure cache
    stays clean and the snapshot take is a no-op refresh.  Each tick ends
    in a device synchronisation."""
    device = resolve_device(device)
    eng = DagEngine.create(capacity, method=method, device=device)

    def mutate(e, xs):
        return steady_tick(e, xs)[0]

    def snap_take(e):
        with as_compiled():
            return e.snapshot()

    def eng_read(e, f, t):
        with as_compiled():
            return e.reachable(f, t)

    inputs = _sgt_tick_inputs(capacity, batch, ticks, seed)
    # per-tick read streams: one independent stream per replica (the
    # baseline serves stream 0), keys drawn from the txns begun so far
    rng = np.random.default_rng(seed + 7919)
    n_streams = max(1, replicas)
    read_batches = []
    for t in range(ticks):
        hi = max(2, (t + 1) * (batch // 4))
        fs = rng.integers(0, hi, (n_streams, reads))
        ts = rng.integers(0, hi, (n_streams, reads))
        read_batches.append(on_device(device, (fs, ts)))

    # untimed warm-up of every piece of the timed region
    zf = torch.zeros(reads, dtype=torch.int32, device=device)
    mutate(eng, on_device(device, _warm_inputs(batch)))
    snap_take(eng).reachable(zf, zf)
    eng_read(eng, zf, zf)
    _sync(device)

    tick_times = []
    snap = None
    last_hits = None
    t0 = time.perf_counter()
    for xs, (fs, ts) in zip(inputs, read_batches):
        eng = mutate(eng, on_device(device, xs))
        _sync(device)  # writer commit — untimed
        t1 = time.perf_counter()
        if replicas == 0:
            last_hits = [eng_read(eng, fs[0], ts[0])]
        else:
            snap = snap_take(eng)
            last_hits = [snap.reachable(fs[i], ts[i])
                         for i in range(replicas)]
        _sync(device)
        tick_times.append(time.perf_counter() - t1)
    dt = time.perf_counter() - t0

    row_products = None
    fs, ts = read_batches[-1]
    if replicas > 0:
        # the zero-matmul bar: snapshot reads are closure bit lookups,
        # and they agree with the live engine they were taken from
        hit, stats = snap.reachable(fs[0], ts[0], with_stats=True)
        row_products = int(stats.row_products)
        assert row_products == 0, \
            f"snapshot reads did {row_products} row-products (want 0)"
        assert torch.equal(hit, last_hits[0]), \
            "snapshot reads disagree with the engine they were taken from"
        assert torch.equal(hit, eng_read(eng, fs[0], ts[0])), \
            "snapshot reads disagree with the live engine"
    ops_per_tick = reads * n_streams
    med = float(np.median(tick_times))
    label = f"replicas{replicas}" if replicas else "engine"
    out = {"ticks": ticks, "replicas": replicas, "reads": reads,
           "ops_per_s": ops_per_tick / med,
           "best_ops_per_s": ops_per_tick / float(min(tick_times)),
           "tick_us": med * 1e6, "row_products": row_products,
           "epoch": eng.epoch, "engine": eng}
    print(f"[serve-sgt-read:{label}] {ops_per_tick * ticks} reads in "
          f"{dt:.2f}s -> {out['ops_per_s']:.0f} reads/s (median tick); "
          f"best {out['best_ops_per_s']:.0f}"
          + (f" row_products={row_products}" if row_products is not None
             else "")
          + f" epoch={out['epoch']}")
    return out


def serve_frontend(load: float = 1000.0, duration: float = 1.0,
                   capacity: int = 1024, batch: int = 64,
                   reader: str = "snapshot", replicas: int = 2,
                   admission: str = "shed", device=None) -> dict:
    """Open-loop serving through the asyncio front-end
    (`repro_torch.serve`): Poisson arrivals at ``load`` requests/s for
    ``duration`` seconds, coalesced into B-slot ticks, reads answered by
    snapshots or delta-log replicas; prints the client-observed p50/p99
    latency."""
    from repro_torch.serve.openloop import run_openloop

    res = run_openloop(load, duration, capacity=capacity, batch=batch,
                       reader=reader, replicas=replicas, admission=admission,
                       device=resolve_device(device))
    label = "engine" if reader == "snapshot" else f"replicas{replicas}"
    print(f"[serve-frontend:{label}] offered {res.offered_per_s:.0f} req/s "
          f"for {duration:.1f}s -> served {res.n_served} "
          f"(shed {res.n_shed}) in {res.ticks} ticks; p50 "
          f"{res.p50_us / 1e3:.1f}ms p99 {res.p99_us / 1e3:.1f}ms, "
          f"achieved {res.ops_per_s:.0f} req/s, "
          f"row_products={res.row_products} epoch={res.epoch}")
    return {"p50_us": res.p50_us, "p99_us": res.p99_us,
            "ops_per_s": res.ops_per_s, "n_served": res.n_served,
            "n_shed": res.n_shed, "ticks": res.ticks,
            "row_products": res.row_products, "epoch": res.epoch}


def serve_chaos(capacity: int = 256, batch: int = 16, ticks: int = 30,
                fault_seed: int = 0, fault_plan: str = "kitchen-sink",
                replicas: int = 2, seed: int = 0,
                checkpoint_every: int = 5, workdir: str = None,
                device=None) -> dict:
    """End-to-end fault-injection replay: one writer + N replicas under a
    named, seeded `FaultPlan` (`repro_torch.ft.faults.NAMED_PLANS`) — torn
    log files, bit-rotted checkpoints, lossy/disordered entry shipping,
    stalls, and crashes inside `Primary.flush`.

    The run asserts the chaos contract: replicas either track
    the primary exactly or degrade EXPLICITLY (a typed error followed by
    a resync — counted, never served); a crashed writer restarts from the
    newest valid base image (corrupt ones are skipped, newer-generation
    checkpoints are fenced off); disk recovery converges bit for bit with
    the live primary or refuses with a typed error; and NO reachability
    read returns a wrong answer.  The same ``fault_seed`` / ``fault_plan``
    replays the same injections."""
    import logging
    import os
    import shutil
    import tempfile

    from repro_torch.core import dag as dag_mod
    from repro_torch.ft import all_steps, faults, restore_engine_checkpoint
    from repro_torch.ft.checkpoint import CorruptCheckpointError
    from repro_torch.replica import (CorruptLogError, Primary, Replica,
                                     ReplicaDiverged, load_delta_log,
                                     recover_replica, save_delta_log)

    logging.basicConfig(level=logging.WARNING)
    device = resolve_device(device)
    fp = faults.plan(fault_seed, fault_plan)
    tmp = workdir or tempfile.mkdtemp(prefix="chaos_")
    ckpt_dir = os.path.join(tmp, "ckpt")
    log_path = os.path.join(tmp, "delta.log")
    rng = np.random.default_rng(seed)

    def new_engine(cap):
        return DagEngine.create(cap, method="incremental", device=device)

    def fresh_primary(engine=None):
        if engine is None:
            engine = new_engine(capacity)
        return Primary(engine, defer_flush=True, jit=True, fault_plan=fp)

    def restart_primary():
        """Crash recovery for the writer: newest UNcorrupted base image
        (or a fresh engine when none exists), with newer-generation
        checkpoints fenced off — they describe a future the crash lost."""
        like = new_engine(p.engine.capacity)
        for s in sorted(all_steps(ckpt_dir), reverse=True):
            try:
                eng = restore_engine_checkpoint(ckpt_dir, like, step=s)
            except CorruptCheckpointError:
                continue
            for newer in (x for x in all_steps(ckpt_dir) if x > s):
                shutil.rmtree(
                    os.path.join(ckpt_dir, f"step_{newer:08d}"),
                    ignore_errors=True)
            return fresh_primary(eng)
        # no valid base at all: the whole generation is lost — wipe its
        # artifacts so later recovery never replays against a stale base
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        if os.path.exists(log_path):
            os.remove(log_path)
        return fresh_primary()

    def keys(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    p = fresh_primary()
    reps = [Replica.from_engine(p.engine) for _ in range(replicas)]
    counters = {"crashes": 0, "resyncs": 0, "stalled_ticks": 0,
                "degraded_reads": 0, "explicit_errors": 0,
                "wrong_answers": 0, "reads": 0}
    pool = capacity // 2

    for t in range(ticks):
        # ---- mutate: begins + forward conflict edges + some churn ----
        ks = ((np.arange(batch, dtype=np.int32) + t * batch) % pool)
        lo = rng.integers(0, pool - 1, batch).astype(np.int32)
        hi = rng.integers(lo + 1, pool).astype(np.int32)
        p.add_vertices(keys(ks))
        p.add_edges_acyclic(keys(lo), keys(hi))
        if t % 4 == 3:
            p.remove_edges(keys(lo[: batch // 2]), keys(hi[: batch // 2]))
        if t == ticks // 3:
            p.grow(capacity * 2)
        try:
            entries = p.flush()
            if t % checkpoint_every == checkpoint_every - 1:
                p.checkpoint(ckpt_dir)
                fp.corrupt_checkpoint(ckpt_dir)
                save_delta_log(log_path, p.log)
                fp.corrupt_log_file(log_path)
        except faults.InjectedCrash:
            counters["crashes"] += 1
            p = restart_primary()
            reps = [r.resync(p.engine) for r in reps]
            counters["resyncs"] += replicas
            continue

        # ---- ship to each replica through the lossy channel ----
        for i in range(replicas):
            if fp.maybe_stall(site=f"chaos.replica[{i}].tick{t}"):
                counters["stalled_ticks"] += 1
                continue  # lagging; the next tick's gap forces a resync
            ship, _ = fp.perturb_entries(entries,
                                         site=f"chaos.replica[{i}]")
            try:
                reps[i] = reps[i].replay(ship)
            except (ReplicaDiverged, CorruptLogError):
                counters["explicit_errors"] += 1
                reps[i] = reps[i].resync(p.engine)
                counters["resyncs"] += 1

        # ---- reads: a replica at the primary's epoch, else degraded ----
        q_u = keys(rng.integers(0, pool, 32).astype(np.int32))
        q_v = keys(rng.integers(0, pool, 32).astype(np.int32))
        want = p.engine.reachable(q_u, q_v)
        current = [r for r in reps if r.epoch == p.epoch]
        counters["reads"] += 32
        if not current:
            counters["degraded_reads"] += 32
        else:
            us, uf = dag_mod.lookup_slots(p.engine.state, q_u)
            vs, vf = dag_mod.lookup_slots(p.engine.state, q_v)
            got = current[0].reachable_slots(us, vs) & uf & vf
            counters["wrong_answers"] += int(torch.sum(got != want))

    # ---- final verdicts ----
    for i in range(replicas):
        if reps[i].epoch != p.epoch:
            reps[i] = reps[i].resync(p.engine)
            counters["resyncs"] += 1
        assert reps[i].converged_with(p.engine), (
            f"replica {i} not bit-for-bit converged after resync\n"
            + fp.report())

    save_delta_log(log_path, p.log)
    fp.corrupt_log_file(log_path)
    like = new_engine(p.engine.capacity)
    try:
        tail = load_delta_log(log_path)  # torn tail -> valid prefix
        shipped = [int(e.epoch) for e in p.log]
        assert [int(e.epoch) for e in tail] == shipped[:len(tail)], \
            "loaded log is not a prefix of the shipped log\n" + fp.report()
        rec = recover_replica(ckpt_dir, like, tail)
        rec = rec.replay(p.log)  # catch up past the torn tail
        assert rec.converged_with(p.engine), (
            "disk recovery + catch-up did not converge\n" + fp.report())
        recovered = True
    except (CorruptLogError, CorruptCheckpointError,
            ReplicaDiverged) as err:
        # mid-file corruption / no valid base: an EXPLICIT typed refusal
        # is within contract — wrong state silently restored is not
        counters["explicit_errors"] += 1
        print(f"[serve-chaos] disk recovery refused explicitly: {err}")
        recovered = False

    if workdir is None:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"ticks": ticks, "epoch": p.epoch, "converged": 1,
           "disk_recovered": int(recovered),
           "injected": len(fp.injected), **counters}
    assert counters["wrong_answers"] == 0, \
        "chaos contract violated: wrong answers served\n" + fp.report()
    print(f"[serve-chaos:{fault_plan}] seed={fault_seed} ticks={ticks} "
          f"injected={out['injected']} crashes={counters['crashes']} "
          f"resyncs={counters['resyncs']} "
          f"degraded_reads={counters['degraded_reads']} "
          f"wrong_answers={counters['wrong_answers']} converged=1")
    return out


def lm_generate(cfg, params, prompt: torch.Tensor, gen: int) -> dict:
    """Prefill ``prompt`` (B, T), then ``gen - 1`` greedy decode steps
    against a cache padded to ``T + gen``, as the reference's `serve_lm`
    runs them.  Returns the ``gen`` greedy tokens (B, gen), the prefill's
    last-token logits, the last step's logits, the cache, and the
    prefill's and the decode steps' wall seconds (each ends in a device
    synchronisation)."""
    from repro_torch.models import transformer as T

    b, prompt_len = prompt.shape
    device = prompt.device
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = T.prefill(cfg, params, prompt,
                              max_len=prompt_len + gen)
    first = logits
    cur = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(device)
    t1 = time.perf_counter()
    outs = [cur]
    for i in range(gen - 1):
        logits, cache = T.decode_step(cfg, params, cache, cur,
                                      prompt_len + i)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
        outs.append(cur)
    _sync(device)
    t2 = time.perf_counter()
    return {"tokens": torch.stack(outs, dim=1), "prefill_logits": first,
            "logits": logits, "cache": cache, "prefill_s": t1 - t0,
            "decode_s": t2 - t1}


def serve_lm(arch: str = "qwen2-1.5b", batch: int = 4, prompt_len: int = 64,
             gen: int = 32, *, device=None, width: str = "smoke",
             seed: int = 0) -> dict:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and
    generate ``gen`` tokens each by greedy argmax, with random weights
    made from ``seed``.  ``width="smoke"`` runs the reference's reduced
    config (`configs.lm_common.smoke_cfg`, as its `serve_lm` does);
    ``"full"`` the arch's published widths.  Returns tok_per_s (generated
    tokens over the prefill and decode wall time), prefill_ms,
    decode_ms_per_token, the config, params and prompt, and what
    `lm_generate` returns."""
    from repro_torch.configs import lm_common, registry
    from repro_torch.models import transformer as T

    validate_choice(width, ("smoke", "full"), what="width")
    dev = resolve_device(device)
    cfg = registry.lm_config(arch)
    if width == "smoke":
        cfg = lm_common.smoke_cfg(cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(cfg, g, device=dev)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                           device=dev)
    out = lm_generate(cfg, params, prompt, gen)
    dt = out["prefill_s"] + out["decode_s"]
    toks = batch * gen
    print(f"[serve-lm] {arch}: {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, batch={batch})")
    out.update(tok_per_s=toks / dt, prefill_ms=out["prefill_s"] * 1e3,
               decode_ms_per_token=out["decode_s"] * 1e3 / max(1, gen - 1),
               cfg=cfg, params=params, prompt=prompt)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", choices=["sgt", "lm"], default="sgt")
    p.add_argument("--arch", default="qwen2-1.5b",
                   help="lm mode: the LM arch (configs/registry.py)")
    p.add_argument("--width", choices=["smoke", "full"], default="smoke",
                   help="lm mode: the reference's reduced config (smoke) "
                        "or the arch's published widths (full)")
    p.add_argument("--profile", default="steady", metavar="PROFILE",
                   help="request stream: steady begin/conflict/finish "
                        "ticks, insheavy (no retirements), the delheavy / "
                        "mixed churn streams, paired (the sgt and engine "
                        "surfaces tick-interleaved), read (writer + "
                        "snapshot readers; see --replicas), frontend "
                        "(open-loop asyncio front-end; see --load/"
                        "--duration/--reader/--admission), or chaos "
                        "(fault-injection replay; see --fault-seed/"
                        "--fault-plan)")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="chaos profile: FaultPlan seed — the same seed + "
                        "plan replays the same injection schedule")
    p.add_argument("--fault-plan", default="kitchen-sink", metavar="PLAN",
                   help="chaos profile: named fault plan (see "
                        "repro_torch.ft.faults.NAMED_PLANS)")
    p.add_argument("--replicas", type=int, default=0,
                   help="read profile: snapshot readers (0 = the live "
                        "engine answers); frontend / chaos profiles: "
                        "Replica count")
    p.add_argument("--reads", type=int, default=512,
                   help="read profile: queries per reader per tick")
    p.add_argument("--load", type=float, default=1000.0,
                   help="frontend profile: offered load in requests/s "
                        "(open-loop Poisson arrivals)")
    p.add_argument("--duration", type=float, default=1.0,
                   help="frontend profile: drive window in seconds")
    p.add_argument("--reader", default="snapshot", metavar="READER",
                   help="frontend profile: snapshot (a frozen snapshot a "
                        "tick) or replica (delta-log replay into "
                        "--replicas readers)")
    p.add_argument("--admission", default="shed", metavar="POLICY",
                   help="frontend profile: shed (429 exactly the dropped "
                        "vertex adds) or grow (auto-double capacity)")
    p.add_argument("--capacity", type=int, default=1024,
                   help="engine capacity (a multiple of 32)")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--ticks", type=int, default=50)
    p.add_argument("--subbatches", type=int, default=1)
    p.add_argument("--method", choices=list(METHODS) + ["incremental_rebuild"],
                   default="auto",
                   help="conflict cycle-check algorithm (auto = cost-model "
                        "dispatch; incremental_rebuild = the delete-repair "
                        "opt-out baseline, churn profiles only)")
    p.add_argument("--api", choices=["sgt", "engine"], default="sgt",
                   help="steady profile's serving surface")
    p.add_argument("--auto-grow", action="store_true",
                   help="steady profile: double capacity between ticks on "
                        "overflow instead of dropping begins")
    p.add_argument("--device", default="cuda",
                   help="torch device the engine or the model runs on "
                        "(default: cuda)")
    args = p.parse_args(argv)
    from repro_torch.ft.faults import NAMED_PLANS
    from repro_torch.serve import ADMISSION_POLICIES, READERS
    try:
        validate_choice(args.profile, PROFILES, what="profile")
        validate_choice(args.reader, READERS, what="reader")
        if args.profile == "chaos":
            validate_choice(args.fault_plan, tuple(NAMED_PLANS),
                            what="fault plan")
        validate_choice(args.admission, ADMISSION_POLICIES,
                        what="admission policy")
    except ValueError as e:
        p.error(str(e))
    if args.method == "incremental_rebuild" and \
            args.profile not in ("delheavy", "mixed"):
        p.error("--method incremental_rebuild is the delete-repair opt-out "
                "baseline of the churn streams; use --profile delheavy or "
                "mixed with it")
    # the cost model's small float32 products hold 0/1 values, exact with
    # or without TF32; full float32 is pinned all the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.mode == "lm":
        # the reference's batch rule for lm mode
        serve_lm(args.arch, batch=max(2, args.batch % 16),
                 device=args.device, width=args.width)
        return 0
    common = dict(capacity=args.capacity, batch=args.batch, ticks=args.ticks,
                  device=args.device)
    if args.profile == "steady":
        serve_sgt(subbatches=args.subbatches, method=args.method,
                  api=args.api, auto_grow=args.auto_grow, **common)
    elif args.profile == "insheavy":
        serve_sgt_insert_heavy(method=args.method, **common)
    elif args.profile == "paired":
        serve_sgt_paired(subbatches=args.subbatches, method=args.method,
                         **common)
    elif args.profile == "read":
        serve_sgt_replicated(replicas=args.replicas, reads=args.reads,
                             **common)
    elif args.profile == "frontend":
        serve_frontend(load=args.load, duration=args.duration,
                       capacity=args.capacity, batch=args.batch,
                       reader=args.reader, replicas=max(1, args.replicas),
                       admission=args.admission, device=args.device)
    elif args.profile == "chaos":
        serve_chaos(fault_seed=args.fault_seed, fault_plan=args.fault_plan,
                    replicas=max(1, args.replicas), **common)
    else:
        serve_sgt_churn(method=args.method, profile=args.profile, **common)
    return 0


if __name__ == "__main__":
    sys.exit(main())
