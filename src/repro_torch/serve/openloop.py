"""Open-loop offered load for the serving front-end.

Port of `repro.serve.openloop`: the same request stream and arrival
schedule for a seed; the front-end runs on ``device`` (None: the card).

Closed-loop tick benchmarks (launch/serve.py) measure throughput with
the next request waiting on the last — they can never see queueing
delay.  This run is OPEN-loop: requests arrive on a Poisson schedule
at a fixed offered load whether or not earlier ones finished, which is
what surfaces p50/p99 *latency* under coalescing (a trickle pays the
``max_wait_s`` deadline, a burst fills B and pays the tick).

The request mix is deterministic per seed (reachability-read heavy over
a bounded key pool, four tenants round-robin); only arrival timing is
wall-clock.  After the drive the run asserts the zero-matmul read
contract in-run: a snapshot read with stats must report
``row_products == 0``, and replica-served runs must have converged
bit-for-bit with the writer.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import List, Tuple

import numpy as np

import torch

from repro_torch.serve.frontend import Frontend, FrontendConfig

TENANTS = ("t0", "t1", "t2", "t3")

# mix fractions: reachability-read heavy, mutations keep the graph churning
MIX = (("reachable", 0.60), ("add_edge", 0.20), ("add_vertex", 0.10),
       ("remove_edge", 0.05), ("remove_vertex", 0.05))


@dataclasses.dataclass(frozen=True)
class OpenLoopResult:
    offered_per_s: float
    n_requests: int
    n_served: int
    n_shed: int
    p50_us: float
    p99_us: float
    ops_per_s: float      # achieved completion rate over the drive window
    row_products: int     # reader-side boolean-matmul products (must be 0)
    epoch: int
    ticks: int


def request_stream(n: int, seed: int, key_hi: int
                   ) -> List[Tuple[str, int, int, str]]:
    """n deterministic (kind, a, b, tenant) requests — the same stream
    every run at a given seed, so engine-vs-replicas rows compare the
    identical workload."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice([k for k, _ in MIX], size=n,
                       p=[w for _, w in MIX])
    a = rng.integers(0, key_hi, n)
    b = rng.integers(0, key_hi, n)
    return [(str(kinds[i]), int(a[i]), int(b[i]), TENANTS[i % len(TENANTS)])
            for i in range(n)]


async def _drive(fe: Frontend, reqs, arrivals) -> Tuple[list, float]:
    loop = asyncio.get_running_loop()
    lat_us: List[Tuple[float, int]] = []

    async def client(delay, kind, a, b, tenant):
        await asyncio.sleep(delay)
        t0 = loop.time()
        resp = await fe.submit(kind, a, b, tenant=tenant)
        lat_us.append(((loop.time() - t0) * 1e6, resp.status))

    t0 = time.perf_counter()
    async with fe:
        tasks = [asyncio.ensure_future(client(arrivals[i], *reqs[i]))
                 for i in range(len(reqs))]
        await asyncio.gather(*tasks)
    return lat_us, time.perf_counter() - t0


def run_openloop(load: float, duration_s: float = 1.0, *,
                 capacity: int = 1024, batch: int = 64,
                 max_wait_s: float = 0.002, reader: str = "snapshot",
                 replicas: int = 2, admission: str = "shed",
                 queue_depth: int = 4096, seed: int = 0,
                 warmup: bool = True, device=None) -> OpenLoopResult:
    """One offered-load point: ``load`` requests/s for ``duration_s``.

    ``reader="snapshot"`` is the single-view baseline ("engine" rows);
    ``reader="replica"`` replays the coalesced delta log into
    ``replicas`` readers and rotates reads across them."""
    n = max(1, int(load * duration_s))
    reqs = request_stream(n, seed, key_hi=capacity // 2)
    rng = np.random.default_rng(seed + 104729)
    arrivals = np.cumsum(rng.exponential(1.0 / load, n))

    cfg = FrontendConfig(batch_size=batch, max_wait_s=max_wait_s,
                         queue_depth=queue_depth, admission=admission,
                         reader=reader, replicas=replicas)
    fe = Frontend.create(capacity, config=cfg, device=device)
    if warmup:
        fe.warmup()
    lat, window = asyncio.run(_drive(fe, reqs, arrivals))

    served = np.asarray([us for us, status in lat if status == 200])
    n_shed = sum(1 for _, status in lat if status != 200)
    # the zero-matmul read contract, asserted on the LIVE run's writer
    dev = fe.primary.engine.device
    f = torch.as_tensor(rng.integers(0, capacity // 2, 64), dtype=torch.int32,
                        device=dev)
    t = torch.as_tensor(rng.integers(0, capacity // 2, 64), dtype=torch.int32,
                        device=dev)
    _, stats = fe.primary.snapshot().reachable(f, t, with_stats=True)
    row_products = int(stats.row_products)
    assert row_products == 0, \
        f"reader-side reads did {row_products} row-products (want 0)"
    if reader == "replica":
        # bit-for-bit adjacency + closure equality subsumes read
        # agreement: a converged replica answers exactly like the writer
        for rep in fe._replicas:
            assert rep.converged_with(fe.primary.engine), \
                "replica diverged from the writer it replayed"
    return OpenLoopResult(
        offered_per_s=float(load), n_requests=n,
        n_served=int(served.size), n_shed=int(n_shed),
        p50_us=float(np.percentile(served, 50)) if served.size else 0.0,
        p99_us=float(np.percentile(served, 99)) if served.size else 0.0,
        ops_per_s=float(served.size / max(window, 1e-9)),
        row_products=row_products, epoch=fe.primary.engine.epoch,
        ticks=fe.stats["ticks"])
