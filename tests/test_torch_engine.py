"""The port's `DagEngine` (`repro_torch.core.engine`) against the
reference engine (`repro.core.engine`), on the CPU.

Both engines replay the same streams, made from a seed with numpy:
  * the mixed OpBatch stream of
    `tests/test_engine.py::test_engine_mixed_ops_match_oracle`, under each
    method (closure / partial / incremental / auto);
  * the SGT serving streams (steady and mixed under "auto"; insheavy,
    delheavy, and delheavy on the invalidate+rebuild baseline under
    "incremental") at C=256, B=64 for 6 ticks.
After every call the ok bits, adjacency, closure words, dirty flag, epoch
and every `ReachStats` field must be identical; the float32 EMAs
(``depth_ema``, ``repair_ema``) must agree within 1e-6 absolute.  Also:
the work counts the reference pins, snapshot isolation, the interop round
trip of a mid-stream reference engine, ``auto_grow`` inside
`as_compiled` (report and drop, as under ``jax.jit``) and outside it
(grow and re-run, as eager), and device selection.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the tensors here are small: one intra-op thread each keeps the test
# workers from contending for the cores
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import DagEngine as JEngine  # noqa: E402
from repro.api import FixedPolicy as JFixed  # noqa: E402
from repro.api import OpBatch as JBatch  # noqa: E402
from repro.core import dag as jdag  # noqa: E402
from repro.core.oracle import SeqGraph, apply_op_batch_oracle  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import closure_cache as tcc  # noqa: E402
from repro_torch.core.dispatch import FixedPolicy as TFixed  # noqa: E402
from repro_torch.core.engine import DagEngine as TEngine  # noqa: E402
from repro_torch.core.engine import OpBatch as TBatch  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

EMA_ATOL = 1e-6
OP_CODES = [jdag.REMOVE_VERTEX, jdag.ADD_VERTEX, jdag.REMOVE_EDGE,
            jdag.ADD_EDGE, jdag.CONTAINS_VERTEX, jdag.CONTAINS_EDGE]
SGT_C, SGT_B, SGT_TICKS = 256, 64, 6


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def j(a):
    return jnp.asarray(np.asarray(a, dtype=np.int32))


def same_engine(te, je):
    """Identical slab, closure words, dirty flag and epoch; EMAs within
    EMA_ATOL."""
    arrays = interop.engine_to_arrays(te)
    np.testing.assert_array_equal(arrays["keys"], np.asarray(je.state.keys))
    np.testing.assert_array_equal(arrays["alive"],
                                  np.asarray(je.state.alive))
    np.testing.assert_array_equal(arrays["adj"].view(np.uint32),
                                  np.asarray(je.state.adj))
    assert int(arrays["n_overflow"]) == int(je.state.n_overflow)
    np.testing.assert_array_equal(arrays["cache.closure"].view(np.uint32),
                                  np.asarray(je.cache.closure))
    assert bool(arrays["cache.dirty"]) == bool(je.cache.dirty)
    assert int(arrays["epoch"]) == int(je.epoch)
    np.testing.assert_allclose(arrays["depth_ema"],
                               np.asarray(je.depth_ema), rtol=0,
                               atol=EMA_ATOL)
    np.testing.assert_allclose(arrays["cache.repair_ema"],
                               np.asarray(je.cache.repair_ema), rtol=0,
                               atol=EMA_ATOL)


def same_result(tr, jr):
    np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))
    assert int(tr.n_overflow) == int(jr.n_overflow)
    for name, tv, jv in zip(jr.stats._fields, tr.stats, jr.stats):
        np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv),
                                      err_msg=name)


# ------------------------------------------------ mixed OpBatch stream

_apply_ref = jax.jit(lambda e, b: e.apply(b))


@pytest.mark.parametrize("method", ["closure", "partial", "incremental",
                                    "auto"])
def test_mixed_opbatch_stream_matches_reference(method):
    cap = 64
    for seed in range(4):
        rng = np.random.default_rng(500 + seed)
        te = TEngine.create(cap, method=method, device="cpu")
        je = JEngine.create(cap, method=method)
        g = SeqGraph(capacity=cap)
        for _ in range(6):
            op = rng.choice(OP_CODES, 6)
            a = rng.integers(0, 12, 6)
            b = rng.integers(0, 12, 6)
            te, tr = te.apply(TBatch(t(op), t(a), t(b)))
            je, jr = _apply_ref(je, JBatch(j(op), j(a), j(b)))
            same_result(tr, jr)
            same_engine(te, je)
            want = apply_op_batch_oracle(g, op, a, b, acyclic=True,
                                         method="partial")
            np.testing.assert_array_equal(tr.ok.numpy(), want)
            assert bool(te.is_acyclic())
        live = set(te.state.keys[te.state.alive].tolist())
        assert live == g.vertices


# ---------------------------------------------------- SGT serving ticks

_TICKS = {"steady": tserve.steady_tick, "insheavy": tserve.insert_heavy_tick,
          "delheavy": tserve.churn_tick, "delheavy_rebuild": tserve.churn_tick,
          "mixed_auto": tserve.churn_tick}
_REF_TICKS = {k: jax.jit(f) for k, f in _TICKS.items()}


def sgt_stream(profile, ticks=SGT_TICKS):
    """The port's numpy stream, checked equal to the reference's."""
    if profile == "steady":
        mine = tserve._sgt_tick_inputs(SGT_C, SGT_B, ticks, 0)
        ref = jserve._sgt_tick_inputs(SGT_C, SGT_B, ticks, 0)
    elif profile == "insheavy":
        mine = tserve._sgt_insert_heavy_inputs(SGT_C, SGT_B, ticks, 0)
        ref = jserve._sgt_insert_heavy_inputs(SGT_C, SGT_B, ticks, 0)
    else:
        churn = "mixed" if profile == "mixed_auto" else "delheavy"
        mine = tserve._sgt_churn_inputs(SGT_C, SGT_B, ticks, 0, churn)
        ref = jserve._sgt_churn_inputs(SGT_C, SGT_B, ticks, 0, churn)
    for xs, ys in zip(mine, ref):
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(x, np.asarray(y))
    return mine


def sgt_engines(profile):
    if profile == "delheavy_rebuild":
        return (TEngine.create(SGT_C, device="cpu", policy=TFixed(
                    "incremental", use_delete_repair=False)),
                JEngine.create(SGT_C, policy=JFixed(
                    "incremental", use_delete_repair=False)))
    method = "auto" if profile in ("steady", "mixed_auto") else "incremental"
    return (TEngine.create(SGT_C, method=method, device="cpu"),
            JEngine.create(SGT_C, method=method))


def replay(profile, te, je, inputs):
    """Replay ``inputs`` through both engines, comparing after each tick;
    returns the engines and the port's summed conflict row-products."""
    row_products = 0
    for xs in inputs:
        te, tres = _TICKS[profile](te, tuple(map(t, xs)))
        je, jres = _REF_TICKS[profile](je, tuple(map(j, xs)))
        for tr, jr in zip(tres, jres):
            same_result(tr, jr)
        same_engine(te, je)
        row_products += sum(r.stats.row_products for r in tres)
    return te, je, row_products


@pytest.mark.parametrize("profile", list(_TICKS))
def test_sgt_stream_matches_reference(profile):
    te, je = sgt_engines(profile)
    te, je, rp = replay(profile, te, je, sgt_stream(profile))
    assert tcc.cache_matches_state(te.cache, te.state.adj)
    assert bool(te.is_acyclic())
    if profile == "insheavy":
        assert rp == 0        # a clean cache decides with zero products


def test_sgt_work_counts_the_reference_pins():
    """Insert-heavy incremental does 0 row-products; the delete-maintained
    repair does fewer row-products than invalidate+rebuild."""
    kw = dict(capacity=SGT_C, batch=SGT_B, ticks=SGT_TICKS, device="cpu")
    ins = tserve.serve_sgt_insert_heavy(**kw)
    assert ins["row_products"] == 0 and ins["cache_clean"]
    rep = tserve.serve_sgt_churn(method="incremental", **kw)
    reb = tserve.serve_sgt_churn(method="incremental_rebuild", **kw)
    assert rep["accepted"] == reb["accepted"]
    assert rep["n_repairs"] > 0 and reb["n_repairs"] == 0
    assert rep["row_products"] < reb["row_products"]


def test_sgt_scheduler_surface_matches_engine_surface():
    """`serve_sgt(api="sgt")` (the scheduler) and `api="engine"` serve the
    steady stream to the same counters and the same graph."""
    kw = dict(capacity=SGT_C, batch=SGT_B, ticks=SGT_TICKS, device="cpu")
    via_sgt = tserve.serve_sgt(api="sgt", **kw)
    via_eng = tserve.serve_sgt(api="engine", **kw)
    for k in ("begun", "committed", "aborted"):
        assert via_sgt[k] == via_eng[k]
    assert torch.equal(via_sgt["engine"].state.adj,
                       via_eng["engine"].state.adj)


# ------------------------------------------------------- reads and views

def test_snapshot_isolation():
    """A snapshot's tensors and answers survive later writer commits
    (the port never writes a returned tensor in place)."""
    inputs = tserve._sgt_churn_inputs(SGT_C, SGT_B, 4, 1, "delheavy")
    eng = TEngine.create(SGT_C, method="incremental", device="cpu")
    for xs in inputs[:2]:
        eng, _ = tserve.churn_tick(eng, tuple(map(t, xs)))
    snap = eng.snapshot()
    saved = [x.clone() for x in (snap.state.keys, snap.state.alive,
                                 snap.state.adj, snap.closure)]
    q_from = t(np.arange(32))
    q_to = t(np.arange(32)[::-1])
    hits = snap.reachable(q_from, q_to)
    assert torch.equal(hits, eng.reachable(q_from, q_to))
    for xs in inputs[2:]:
        eng, _ = tserve.churn_tick(eng, tuple(map(t, xs)))
    assert eng.epoch > snap.epoch
    for before, now in zip(saved, (snap.state.keys, snap.state.alive,
                                   snap.state.adj, snap.closure)):
        assert torch.equal(before, now)
    assert torch.equal(snap.reachable(q_from, q_to), hits)
    got, stats = snap.reachable(q_from, q_to, with_stats=True)
    assert stats.row_products == 0
    assert bool(snap.is_acyclic())


def test_interop_round_trip_continues_a_reference_engine():
    """A reference engine mid-stream, flattened with numpy, continues in
    the port to the same results as the reference itself."""
    inputs = sgt_stream("delheavy")
    je = JEngine.create(SGT_C, method="incremental")
    for xs in inputs[:3]:
        je, _ = _REF_TICKS["delheavy"](je, tuple(map(j, xs)))
    arrays = {
        "keys": np.asarray(je.state.keys), "alive": np.asarray(je.state.alive),
        "adj": np.asarray(je.state.adj).view(np.int32),
        "n_overflow": np.asarray(je.state.n_overflow),
        "depth_ema": np.asarray(je.depth_ema),
        "cache.closure": np.asarray(je.cache.closure),
        "cache.dirty": np.asarray(je.cache.dirty),
        "cache.repair_ema": np.asarray(je.cache.repair_ema),
        "epoch": np.asarray(je.epoch)}
    te = interop.engine_from_arrays(arrays, {"method": "incremental"},
                                    device="cpu")
    same_engine(te, je)
    replay("delheavy", te, je, inputs[3:])
    back = interop.engine_to_arrays(te)
    assert set(back) == set(interop.LEAVES)
    again = interop.engine_from_arrays(back, {"method": "incremental"},
                                       device="cpu")
    for k, v in interop.engine_to_arrays(again).items():
        np.testing.assert_array_equal(v, back[k], err_msg=k)


def test_grow_and_options_match_reference():
    te = TEngine.create(64, device="cpu")
    je = JEngine.create(64)
    keys = np.arange(40)
    te, _ = te.add_vertices(t(keys))
    je, _ = jax.jit(lambda e, k: e.add_vertices(k))(je, j(keys))
    te, tr = te.add_edges_acyclic(t(keys[:-1]), t(keys[1:]))
    je, jr = jax.jit(lambda e, u, v: e.add_edges_acyclic(u, v))(
        je, j(keys[:-1]), j(keys[1:]))
    same_result(tr, jr)
    te, je = te.grow(128), jax.jit(lambda e: e.grow(128))(je)
    same_engine(te, je)
    q = [0, 5, 39, 12], [39, 0, 1, 13]
    for m in ("closure", "partial", "incremental"):
        want = jax.jit(lambda e, f, to: e.with_options(method=m).reachable(
            f, to))(je, j(q[0]), j(q[1]))
        np.testing.assert_array_equal(
            te.with_options(method=m).reachable(t(q[0]), t(q[1])).numpy(),
            np.asarray(want))
    with pytest.raises(ValueError, match="nearest valid capacity is 160"):
        te.grow(150)


# ------------------------------------ auto_grow inside and outside a tick

def _overflowing_batch():
    """40 vertex adds (keys 1..40) and 4 edge adds among the first keys:
    8 adds more than a 32-slot engine holds."""
    keys = np.arange(1, 41)
    return (np.concatenate([np.full(40, jdag.ADD_VERTEX),
                            np.full(4, jdag.ADD_EDGE)]).astype(np.int32),
            np.concatenate([keys, [1, 2, 3, 5]]).astype(np.int32),
            np.concatenate([np.zeros(40), [2, 3, 4, 6]]).astype(np.int32))


@pytest.fixture(scope="module")
def auto_grow_reference():
    """The reference's jitted ``add_vertices`` and ``apply`` of the
    overflowing batch on a fresh ``auto_grow`` engine of capacity 32 (where
    they report and drop) and on that engine grown to 64 (what its eager
    calls re-run on): one jitted function for both calls, compiled once
    per capacity."""
    keys = np.arange(1, 41, dtype=np.int32)
    op, a, b = _overflowing_batch()

    def calls(e):
        return e.add_vertices(keys), e.apply(JBatch(op, a, b))

    run = jax.jit(lambda grown: calls(
        JEngine.create(32, auto_grow=True).grow(64) if grown
        else JEngine.create(32, auto_grow=True)), static_argnums=0)
    return {32: run(False), 64: run(True)}


def _check_auto_grow(te_res, j_res, capacity, n_overflow, n_ok):
    (te, tr), (je, jr) = te_res, j_res
    assert te.capacity == capacity == je.config.capacity
    assert int(tr.n_overflow) == n_overflow
    assert int(tr.ok[:40].sum()) == n_ok
    same_result(tr, jr)
    same_engine(te, je)


@pytest.mark.parametrize("call", ["add_vertices", "apply"])
def test_auto_grow_reports_and_drops_inside_as_compiled(
        call, auto_grow_reference):
    """Inside `as_compiled` an ``auto_grow`` engine keeps its capacity and
    reports the 8 adds it dropped, as the reference's jitted call does."""
    from repro_torch.core.engine import as_compiled
    te = TEngine.create(32, auto_grow=True, device="cpu")
    with as_compiled():
        got = (te.add_vertices(t(np.arange(1, 41))) if call == "add_vertices"
               else te.apply(TBatch(*map(t, _overflowing_batch()))))
    want = auto_grow_reference[32][call == "apply"]
    _check_auto_grow(got, want, 32, 8, 32)


@pytest.mark.parametrize("call", ["add_vertices", "apply"])
def test_auto_grow_grows_eagerly(call, auto_grow_reference):
    """Outside `as_compiled` the engine doubles to 64 and re-runs the
    batch, as the reference's eager call re-runs it on ``grow(64)``."""
    te = TEngine.create(32, auto_grow=True, device="cpu")
    got = (te.add_vertices(t(np.arange(1, 41))) if call == "add_vertices"
           else te.apply(TBatch(*map(t, _overflowing_batch()))))
    want = auto_grow_reference[64][call == "apply"]
    _check_auto_grow(got, want, 64, 0, 40)


# --------------------------------------------------- device and scope

def test_create_defaults_to_the_card():
    """``device=None`` means the card; without one, create raises rather
    than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error cannot occur")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine.create(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve_sgt(capacity=64, batch=16, ticks=1)


def test_unported_options_raise_naming_the_roadmap():
    # the sharded backend is ported (tests/test_torch_sharded.py): its
    # default mesh is every card, so without one it raises; a mesh of CPU
    # shards runs
    from repro_torch.core.sharded import make_dag_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine.create(64, backend="sharded", device="cpu")
    eng = TEngine.create(64, backend="sharded",
                         mesh=make_dag_mesh("cpu", n_shards=2))
    assert eng.config.n_devices == 2 and eng.depth_ema.shape == (2,)
    # the tiled layout is ported (tests/test_torch_tiled_engine.py); an
    # unknown layout still raises
    assert TEngine.create(64, closure_layout="tiled",
                          device="cpu").closure_region == 64
    with pytest.raises(ValueError, match="closure_layout"):
        TEngine.create(64, closure_layout="sparse", device="cpu")
    with pytest.raises(ValueError, match="nearest valid method"):
        TEngine.create(64, method="incremntal", device="cpu")
