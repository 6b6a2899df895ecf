"""The port's serving front-end (`repro_torch.serve`) and the serving
profiles of `repro_torch.launch.serve`, on the CPU.

  * A burst-submitted trace (the whole stream queued before the first
    tick, so the ticks' composition is fixed) served with the `snapshot`
    reader and with the `replica` reader over 2 replicas: every response
    and the final graph and closure equal the port's sequential oracle
    (`core.oracle.SeqGraph` replaying the commit-order trace), the two
    readers answer alike, and the replicas converge with the writer.
  * Deficit round robin selects the reference's requests in the
    reference's order, and the shed / grow admission policies give the
    reference front-end's responses, counters and capacity.
  * The writer's hot-path modes behind the front-end: ``defer_flush``
    staging, coalescing (split by a delete after adds), an uncoalesced
    flush equal to the eager log, and ``jit`` across an ``auto_grow``.
  * `serve_sgt_replicated`, `serve_sgt_paired` and `serve_frontend` at a
    small size.
"""
import asyncio
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core.engine import DagEngine as TEngine  # noqa: E402
from repro_torch.core.oracle import SeqGraph  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.replica import (Primary, Replica,  # noqa: E402
                                 coalesce_entries)

KINDS = ("add_vertex", "remove_vertex", "add_edge", "remove_edge",
         "reachable")


@pytest.fixture(scope="module", autouse=True)
def _fresh_xla_caches():
    # the executables cached before and during this module hold memory
    # maps; free them so this worker stays far from the kernel's limit
    jax.clear_caches()
    yield
    jax.clear_caches()


def mixed_stream(n, seed, key_hi, tenants=("t0", "t1")):
    rng = np.random.default_rng(seed)
    kinds = rng.choice(KINDS, size=n, p=[0.25, 0.05, 0.35, 0.05, 0.30])
    a = rng.integers(0, key_hi, n)
    b = rng.integers(0, key_hi, n)
    return [(str(kinds[i]), int(a[i]), int(b[i]),
             tenants[i % len(tenants)]) for i in range(n)]


def run_burst(fe, reqs):
    """Queue every request before the coalescer's first tick; responses
    in submission order."""

    async def go():
        async with fe:
            return await asyncio.gather(
                *[fe.submit(k, a, b, tenant=t) for k, a, b, t in reqs])

    return asyncio.run(go())


def oracle_of(trace):
    g = SeqGraph()
    step = {"add_vertex": lambda a, b: g.add_vertex(a),
            "remove_vertex": lambda a, b: g.remove_vertex(a),
            "add_edge": g.acyclic_add_edge, "remove_edge": g.remove_edge,
            "reachable": g.path_exists}
    return g, [step[k](a, b) for k, a, b, _ in trace]


def assert_graph_is(eng, g):
    """The engine's live keys, edges and closure are the oracle's."""
    keys = eng.state.keys.numpy()
    alive = eng.state.alive.numpy()
    live = {int(k) for k in keys[alive]}
    assert live == g.vertices
    slot = {int(k): i for i, k in enumerate(keys) if alive[i]}
    ks = sorted(live)
    u = torch.tensor([slot[x] for x in ks for _ in ks], dtype=torch.int32)
    v = torch.tensor([slot[y] for _ in ks for y in ks], dtype=torch.int32)
    from repro_torch.core import bitset, closure_cache
    eng = eng.refresh_cache()
    edges = bitset.bit_get(eng.state.adj, u, v).tolist()
    reach = closure_cache.closure_bit_get(eng.cache.closure, u, v).tolist()
    pairs = [(x, y) for x in ks for y in ks]
    assert {p for p, e in zip(pairs, edges) if e} == g.edges
    assert reach == [g.path_exists(x, y) for x, y in pairs]


def test_trace_equals_sequential_oracle():
    reqs = mixed_stream(96, seed=9, key_hi=24)
    answers = {}
    for reader in ("snapshot", "replica"):
        fe = tserve.Frontend.create(
            64, tserve.FrontendConfig(batch_size=8, max_wait_s=0.005,
                                      reader=reader, replicas=2),
            device="cpu")
        fe.warmup()
        resps = run_burst(fe, reqs)
        assert all(r.status == tserve.STATUS_OK for r in resps)
        assert len(fe.trace) == len(reqs) and fe.stats["ticks"] == 12
        g, want = oracle_of(fe.trace)
        assert [ok for *_, ok in fe.trace] == want
        assert_graph_is(fe.primary.engine, g)
        answers[reader] = [(r.ok, r.epoch, r.tick, r.read_epoch)
                           for r in resps]
        for rep in fe._replicas:
            assert rep.converged_with(fe.primary.engine)
            assert rep.epoch == fe.primary.epoch
        # one coalesced entry a tick that mutated
        assert len(fe.primary.log) == len(
            {r.tick for (k, *_), r in zip(reqs, resps) if k != "reachable"})
    assert answers["snapshot"] == answers["replica"]


def _drr_runs(cls):
    out = []
    drr = cls(weights={"a": 3.0, "b": 1.0})
    pending = {"a": collections.deque(), "b": collections.deque()}
    for i in range(50):
        for t in pending:
            while len(pending[t]) < 16:
                pending[t].append(f"{t}{i}")
        out.append(drr.select(pending, 8))
    drr = cls()
    pending = {t: collections.deque() for t in "abcde"}
    for i in range(30):
        for t in pending:
            while len(pending[t]) < 4:
                pending[t].append(f"{t}{i}")
        out.append(drr.select(pending, 2))
    return out


def _admission_runs(serve, **create):
    out = {}
    for policy in ("shed", "grow"):
        fe = serve.Frontend.create(
            32, serve.FrontendConfig(batch_size=64, max_wait_s=0.1,
                                     admission=policy), **create)
        resps = run_burst(fe, [("add_vertex", k, 0, "t0")
                               for k in range(40)])
        out[policy] = ([(bool(r.ok), r.status, int(r.epoch), r.tick)
                        for r in resps], fe.admission.stats,
                       fe.primary.engine.capacity,
                       int(fe.primary.engine.state.n_overflow))
    ctrl = serve.AdmissionController("shed", queue_depth=3)
    out["queue"] = ([ctrl.admit(n) for n in range(5)], ctrl.stats)
    return out


def test_fairness_and_admission_match_reference():
    assert _drr_runs(tserve.DeficitRoundRobin) == \
        _drr_runs(jserve.DeficitRoundRobin)
    got = _admission_runs(tserve, device="cpu")
    assert got == _admission_runs(jserve)
    shed, grow = got["shed"], got["grow"]
    assert sum(s == tserve.STATUS_SHED for _, s, *_ in shed[0]) == 8
    assert shed[2] == 32 and grow[2] >= 40
    assert all(ok and s == tserve.STATUS_OK for ok, s, *_ in grow[0])
    with pytest.raises(ValueError, match="nearest valid reader is "
                                         "'replica'"):
        tserve.Frontend.create(32, tserve.FrontendConfig(reader="replcia"),
                               device="cpu")


def _quad(p):
    """One front-end-shaped tick: all four phases, deletes before adds."""
    t = torch.tensor
    p.remove_vertices(t([9], dtype=torch.int32))
    p.add_vertices(t([0, 1, 2, 3], dtype=torch.int32))
    p.remove_edges(t([0], dtype=torch.int32), t([3], dtype=torch.int32))
    p.add_edges_acyclic(t([0, 1, 2], dtype=torch.int32),
                        t([1, 2, 3], dtype=torch.int32))


def test_primary_hot_path_modes():
    def fresh(**kw):
        return Primary.create(64, method="incremental", device="cpu", **kw)

    def replays(p):
        rep = Replica.from_engine(TEngine.create(64, method="incremental",
                                                 device="cpu"))
        return rep.replay(p.log).converged_with(p.engine)

    p = fresh(defer_flush=True)
    _quad(p)
    assert p.log == [] and len(p._staged) == 4
    assert len(p.flush()) == 1 and p.log[0].epoch == p.epoch == 4
    assert replays(p)
    # a delete after adds opens a new entry
    p = fresh(defer_flush=True)
    t = torch.tensor
    p.add_vertices(t([0, 1, 2], dtype=torch.int32))
    p.add_edges_acyclic(t([0, 1], dtype=torch.int32),
                        t([1, 2], dtype=torch.int32))
    p.remove_edges(t([0], dtype=torch.int32), t([1], dtype=torch.int32))
    p.add_edges_acyclic(t([0], dtype=torch.int32), t([2], dtype=torch.int32))
    assert len(coalesce_entries(p._staged)) == 2
    assert len(p.flush()) == 2 and replays(p)
    # an uncoalesced flush writes the eager log
    p, q = fresh(defer_flush=True), fresh()
    for x in (p, q):
        _quad(x)
    p.flush(coalesce=False)
    assert [e[:2] + e[3:] for e in p.log] == [e[:2] + e[3:] for e in q.log]
    for a, b in zip(p.log, q.log):
        for x, y in zip(a.delta, b.delta):
            np.testing.assert_array_equal(x, y)
    # jit across auto_grow: the eager writer's state, and a log that
    # replays through the grow
    engines = []
    for opts in ({}, {"defer_flush": True, "jit": True}):
        p = Primary.create(32, method="incremental", auto_grow=True,
                           device="cpu", **opts)
        for kind, a, b, _ in mixed_stream(60, seed=21, key_hi=40):
            a1, b1 = t([a], dtype=torch.int32), t([b], dtype=torch.int32)
            if kind == "add_vertex":
                p.add_vertices(a1)
            elif kind == "remove_vertex":
                p.remove_vertices(a1)
            elif kind == "add_edge":
                p.add_edges_acyclic(a1, b1)
            elif kind == "remove_edge":
                p.remove_edges(a1, b1)
        p.add_vertices(torch.arange(40, 72, dtype=torch.int32))
        p.flush()
        engines.append(p)
    eager, jitted = engines
    assert jitted.engine.capacity == eager.engine.capacity > 32
    assert jitted.epoch == eager.epoch
    assert torch.equal(jitted.engine.state.adj, eager.engine.state.adj)
    assert torch.equal(jitted.engine.cache.closure,
                       eager.engine.cache.closure)
    rep = Replica.from_engine(TEngine.create(32, method="incremental",
                                             device="cpu"))
    assert rep.replay(jitted.log).converged_with(jitted.engine)


def test_serving_profiles_on_the_cpu():
    kw = dict(capacity=128, batch=32, ticks=4, device="cpu")
    base = tlaunch.serve_sgt_replicated(replicas=0, reads=64, **kw)
    two = tlaunch.serve_sgt_replicated(replicas=2, reads=64, **kw)
    assert two["row_products"] == 0 and base["epoch"] == two["epoch"]
    sgt, eng = tlaunch.serve_sgt_paired(**kw)
    for key in ("begun", "committed", "aborted"):
        assert sgt[key] == eng[key], key
    out = tlaunch.serve_frontend(load=400.0, duration=0.2, capacity=128,
                                 batch=16, reader="replica", replicas=2,
                                 device="cpu")
    assert out["row_products"] == 0
    assert out["n_served"] + out["n_shed"] == 80
