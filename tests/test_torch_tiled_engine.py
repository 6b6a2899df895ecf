"""The port's tiled-layout engine and serving loop against the reference,
on the CPU at C=512, B=128, 6 ticks of the mixed churn stream.

* `serve_sgt_churn(closure_layout="tiled")` with the default window (512
  slots here) and a 64-slot one, against the reference's own
  `serve_sgt_churn`: accept bits, ``row_products``, ``n_repairs``,
  ``closure_bytes`` and ``cache_clean`` identical.  The reference jits
  its tick, so its window never widens: with 64 slots the stream (live
  high-water 95 slots at B=128) spills, the cache degrades to dirty and
  the partial check decides.  The port's ticks run inside
  `engine.as_compiled` and must do the same work.  (At B=32 the stream's
  high-water is 25 slots, so no window would spill: B=128, the main
  path's batch, is the smallest here that exercises the spill.)
* The eager session widens: every call made outside `as_compiled`
  matches the reference's eager call — its host-side `_pre_widened`,
  then the call's traced body — tick by tick (ok bits, every `ReachStats`
  field, window size, tiles, summary, dirty flag, epoch; EMAs within
  1e-6).  A reference engine handed over mid-stream through `interop`
  continues in the port to the same results.
* `with_closure_layout` both ways, tiled snapshots and the window-squared
  `is_acyclic`.

The reference compiles here: the two `serve_sgt_churn` ticks, and one
jitted churn tick at each window size the eager stream reaches (64, 128).
Each reference stream runs once, in a module-scoped fixture.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import DagEngine as JEngine  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import closure_cache as tcc  # noqa: E402
from repro_torch.core.engine import DagEngine as TEngine  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

C, B, TICKS, HANDOVER = 512, 128, 6, 3
EMA_ATOL = 1e-6
SERVE = dict(capacity=C, batch=B, ticks=TICKS, method="incremental",
             profile="mixed", closure_layout="tiled", collect_decisions=True)
SERVE_KEYS = ("accepted", "row_products", "n_repairs", "closure_bytes",
              "cache_clean")

# the port's tick body, traced over a reference engine: the reference's
# jitted tick
_ref_tick = jax.jit(tserve.churn_tick)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def j(a):
    return jnp.asarray(np.asarray(a, dtype=np.int32))


def stream():
    mine = tserve._sgt_churn_inputs(C, B, TICKS, 0, "mixed")
    ref = jserve._sgt_churn_inputs(C, B, TICKS, 0, "mixed")
    for xs, ys in zip(mine, ref):
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(x, np.asarray(y))
    return mine


def ref_arrays(je):
    """A reference engine's leaves in `interop.TILED_LEAVES` form."""
    cl = je.cache.closure
    return {"keys": np.asarray(je.state.keys),
            "alive": np.asarray(je.state.alive),
            "adj": np.asarray(je.state.adj).view(np.int32),
            "n_overflow": np.asarray(je.state.n_overflow),
            "depth_ema": np.asarray(je.depth_ema),
            "cache.closure.tiles": np.asarray(cl.tiles).view(np.int32),
            "cache.closure.summary": np.asarray(cl.summary).view(np.int32),
            "cache.dirty": np.asarray(je.cache.dirty),
            "cache.repair_ema": np.asarray(je.cache.repair_ema),
            "epoch": np.asarray(je.epoch)}


def same_arrays(mine: dict, ref: dict):
    assert set(mine) == set(ref) == set(interop.TILED_LEAVES)
    for k, v in ref.items():
        if v.dtype == np.float32:
            np.testing.assert_allclose(mine[k], v, rtol=0, atol=EMA_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(mine[k], v, err_msg=k)


def same_results(tres, jres):
    for tr, jr in zip(tres, jres):
        np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))
        assert int(tr.n_overflow) == int(jr.n_overflow)
        for name, tv, jv in zip(jr.stats._fields, tr.stats, jr.stats):
            np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv),
                                          err_msg=name)


def eager_tick(eng, xs):
    """One churn tick as eager calls (outside `as_compiled`)."""
    begins, src, dst, del_src, del_dst, fins = xs
    eng, began = eng.add_vertices(begins)
    eng, conf = eng.add_edges_acyclic(src, dst)
    eng, rem = eng.remove_edges(del_src, del_dst)
    eng, fin = eng.remove_vertices(fins)
    return eng, (began, conf, rem, fin)


# ------------------------------------------------------------ fixtures

@pytest.fixture(scope="module")
def ref_serve():
    return {region: jserve.serve_sgt_churn(closure_region=region, **SERVE)
            for region in (0, 64)}


@pytest.fixture(scope="module")
def ref_eager():
    """The reference's eager session on a 64-slot window: per tick, the
    host-side widening its eager add_vertices does, then the tick's
    traced body.  Per tick: (results, engine leaves, window size)."""
    je = JEngine.create(C, method="incremental", closure_layout="tiled",
                        closure_region=64)
    ticks, handover = [], None
    for k, xs in enumerate(stream()):
        if k == HANDOVER:
            handover = ref_arrays(je)
        je = je._pre_widened(len(xs[0]))
        je, res = _ref_tick(je, tuple(map(j, xs)))
        ticks.append((res, ref_arrays(je), je.closure_region))
    return ticks, handover


# --------------------------------------------------------------- serving

@pytest.mark.parametrize("region", [0, 64])
def test_serve_sgt_churn_tiled_matches_reference(region, ref_serve):
    want = ref_serve[region]
    got = tserve.serve_sgt_churn(closure_region=region, device="cpu",
                                 **SERVE)
    np.testing.assert_array_equal(got["decisions"], want["decisions"])
    for k in SERVE_KEYS:
        assert got[k] == want[k], k
    assert got["engine"].closure_region == (64 if region else C)


def test_the_small_window_spills_in_the_served_stream(ref_serve):
    """Hazard check: the 64-slot window overflows, so the run must go
    dirty and pay partial checks — the work differs, the decisions do
    not."""
    small, full = ref_serve[64], ref_serve[0]
    np.testing.assert_array_equal(small["decisions"], full["decisions"])
    assert full["cache_clean"] and not small["cache_clean"]
    assert small["row_products"] != full["row_products"]
    assert small["closure_bytes"] < full["closure_bytes"]


# ---------------------------------------------------- the eager session

def test_eager_session_widens_as_the_reference(ref_eager):
    ticks, _ = ref_eager
    eng = TEngine.create(C, method="incremental", closure_layout="tiled",
                         closure_region=64, device="cpu")
    regions = []
    for xs, (jres, jarrays, jregion) in zip(stream(), ticks):
        eng, tres = eager_tick(eng, tuple(map(t, xs)))
        same_results(tres, jres)
        same_arrays(interop.engine_to_arrays(eng), jarrays)
        assert eng.closure_region == jregion
        regions.append(eng.closure_region)
    assert regions[0] == 64 and regions[-1] == 128   # it did widen
    assert not eng.cache.dirty
    assert tcc.cache_matches_state(eng.cache, eng.state.adj)


def test_mid_stream_reference_engine_continues_in_the_port(ref_eager):
    ticks, handover = ref_eager
    eng = interop.engine_from_arrays(handover, {"method": "incremental"},
                                     device="cpu")
    same_arrays(interop.engine_to_arrays(eng), handover)
    assert eng.config.closure_layout == "tiled"
    for xs, (jres, jarrays, _) in zip(stream()[HANDOVER:],
                                      ticks[HANDOVER:]):
        eng, tres = eager_tick(eng, tuple(map(t, xs)))
        same_results(tres, jres)
        same_arrays(interop.engine_to_arrays(eng), jarrays)
    back = interop.engine_to_arrays(eng)
    again = interop.engine_from_arrays(back, {"method": "incremental"},
                                       device="cpu")
    same_arrays(interop.engine_to_arrays(again), back)


# ------------------------------------------------ layouts, views, checks

@pytest.fixture(scope="module")
def tiled_engine():
    """The port's engine in the eager stream's last tick, after its
    conflict inserts (the stream's removals empty the graph by the end of
    every tick); its window has widened to 128."""
    eng = TEngine.create(C, method="incremental", closure_layout="tiled",
                         closure_region=64, device="cpu")
    inputs = stream()
    for xs in inputs[:-1]:
        eng, _ = eager_tick(eng, tuple(map(t, xs)))
    begins, src, dst = map(t, inputs[-1][:3])
    eng, _ = eng.add_vertices(begins)
    eng, _ = eng.add_edges_acyclic(src, dst)
    assert int(eng.edge_count()) > 0 and eng.closure_region == 128
    return eng


def test_with_closure_layout_goes_both_ways(tiled_engine):
    eng = tiled_engine
    dense = eng.with_closure_layout("dense")
    assert dense.config.closure_layout == "dense"
    assert dense.closure_region is None and dense.epoch == eng.epoch
    assert torch.equal(dense.cache.closure, tcc.dense_of(eng.cache.closure))
    back = dense.with_closure_layout("tiled")
    # the smallest window covering every closure and adjacency bit
    live = torch.nonzero(torch.any(dense.cache.closure | eng.state.adj,
                                   dim=1)).max().item() + 1
    assert back.closure_region == tcc.align_region(live, C) <= 128
    assert torch.equal(tcc.dense_of(back.cache.closure), dense.cache.closure)
    assert torch.equal(back.cache.closure.summary,
                       tcc.build_summary(back.cache.closure.tiles, C))
    assert tcc.cache_matches_state(back.cache, back.state.adj)
    wide = dense.with_closure_layout("tiled", region=256)
    assert wide.closure_region == 256
    with pytest.raises(ValueError, match="closure_layout"):
        eng.with_closure_layout("sparse")


def test_tiled_reads_snapshot_and_acyclicity(tiled_engine):
    eng = tiled_engine
    live = eng.state.keys[eng.state.alive]
    rng = np.random.default_rng(3)
    f = live[torch.from_numpy(rng.integers(0, live.numel(), 64))]
    to = live[torch.from_numpy(rng.integers(0, live.numel(), 64))]
    dense = eng.with_closure_layout("dense")
    want = dense.reachable(f, to)
    assert torch.equal(eng.reachable(f, to), want)
    snap = eng.snapshot()
    assert torch.equal(snap.reachable(f, to), want)
    assert bool(snap.is_acyclic()) and bool(eng.is_acyclic())
    assert bool(eng.is_acyclic()) == bool(dense.is_acyclic())


def test_refresh_cache_widens_a_dirty_window_to_the_graph(tiled_engine):
    eng = tiled_engine
    stale = TEngine(eng.state, eng.depth_ema,
                    tcc.empty_tiled_cache(C, 32, dirty=True),
                    eng.config, eng.epoch)
    fresh = stale.refresh_cache()
    assert not fresh.cache.dirty and fresh.closure_region > 32
    assert tcc.cache_matches_state(fresh.cache, fresh.state.adj)
    assert torch.equal(tcc.dense_of(fresh.cache.closure),
                       tcc.dense_of(eng.cache.closure))
    assert fresh.snapshot().closure.region == fresh.closure_region


def test_create_tiled_at_the_main_path_size_needs_a_card():
    """The main path's engine runs on the card by default and raises
    without one, before anything is allocated."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error cannot occur")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine.create(131072, closure_layout="tiled", method="incremental")
    eng = TEngine.create(C, closure_layout="tiled", device="cpu")
    assert eng.closure_region == C and eng.config.closure_region == C
    assert tcc.closure_nbytes(eng.cache.closure) == C * C // 8 + 16 * 4


def test_mixed_opbatch_apply_tiled_matches_dense_layout():
    """`apply` on the tiled layout (a 32-slot window that the batches'
    vertex adds make it widen) against the dense layout, which
    tests/test_torch_engine.py holds against the reference: identical ok
    bits, adjacency, epoch, and, whenever both caches are clean,
    identical closure bits."""
    from repro_torch.core import dag
    from repro_torch.core.engine import OpBatch
    codes = [dag.REMOVE_VERTEX, dag.ADD_VERTEX, dag.REMOVE_EDGE,
             dag.ADD_EDGE, dag.CONTAINS_VERTEX, dag.CONTAINS_EDGE]
    cap = 128
    for seed in range(3):
        rng = np.random.default_rng(700 + seed)
        tiled = TEngine.create(cap, method="incremental",
                               closure_layout="tiled", closure_region=32,
                               device="cpu")
        dense = TEngine.create(cap, method="incremental", device="cpu")
        for _ in range(12):
            batch = OpBatch(*(t(x) for x in (
                rng.choice(codes, 16, p=[.1, .35, .1, .3, .1, .05]),
                rng.integers(0, 100, 16), rng.integers(0, 100, 16))))
            tiled, tr = tiled.apply(batch)
            dense, dr = dense.apply(batch)
            assert torch.equal(tr.ok, dr.ok)
            assert torch.equal(tiled.state.adj, dense.state.adj)
            assert tiled.epoch == dense.epoch
            if not tiled.cache.dirty and not dense.cache.dirty:
                assert torch.equal(tcc.dense_of(tiled.cache.closure),
                                   dense.cache.closure)
            assert tcc.cache_matches_state(tiled.cache, tiled.state.adj)
        assert tiled.closure_region > 32
