"""The tiled half of the port's closure cache (`repro_torch.core.
closure_cache`) against the reference's (`repro.core.closure_cache`), on
the CPU at C=256 with a 64-slot window.

One scenario, written once over either package's module, drives every
tiled operation on the same seeded graph (made with numpy): the window
rebuild of `refresh_closure` (clean and stale), `insert_update_tiled`
(a fold and a spill), `commit` (a repair, an invalidation, the default
delete arm, a blocked out-of-window seed, a spilling add, and a merged
repair + fold), `apply_delta`, `grow_region`, `grow_closure`, `dense_of`
/ `tiled_of`, `summary_from_occ` / `build_summary`, the tiled
`candidate_hop_matrix`, `incremental_cycle_check`, `closure_bit_get` and
`cache_matches_state`.  The reference runs the scenario once, under one
``jax.jit`` (one compilation); the port runs it eagerly.  Every output —
packed words, summaries, occupancy, dirty flags, stats, bits — must be
identical (the EMA within 1e-6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import closure_cache as jcc  # noqa: E402
from repro_torch.core import closure_cache as tcc  # noqa: E402

C, R = 256, 64
EMA_ATOL = 1e-6


def _graph():
    """A seeded DAG on slots < 48 (forward edges only, so every fold is
    acyclic) and the scenario's edge batches."""
    rng = np.random.default_rng(14)
    dense = np.triu(rng.random((48, 48)) < 0.08, 1)
    adj0 = np.zeros((C, C), bool)
    adj0[:48, :48] = dense
    free = [(u, v) for u in range(48) for v in range(u + 1, 48)
            if not dense[u, v]]
    pick = rng.choice(len(free), 12, replace=False)
    fold = np.array([free[i] for i in pick], np.int32)
    fold_ok = np.ones(12, bool)
    fold_ok[5] = False                   # a rejected candidate folds nothing
    adj1 = adj0.copy()
    adj1[fold[fold_ok, 0], fold[fold_ok, 1]] = True
    us, vs = np.nonzero(adj1)
    rem = np.stack([us, vs], 1)[rng.choice(len(us), 4, replace=False)]
    adj2 = adj1.copy()
    adj2[rem[:, 0], rem[:, 1]] = False
    add3 = np.array([[1, 40], [2, 47], [30, 31]], np.int32)
    adj3 = adj2.copy()
    adj3[add3[:, 0], add3[:, 1]] = True
    adj_spill = adj1.copy()
    adj_spill[5, 70] = True              # an accepted edge past the window
    return {"adj0": adj0, "adj1": adj1, "adj2": adj2, "adj3": adj3,
            "adj_spill": adj_spill, "fold": fold, "fold_ok": fold_ok,
            "rem": rem.astype(np.int32), "add3": add3}


def _pack(bits):
    return np.packbits(bits, axis=-1, bitorder="little").view("<u4")


class _Jax:
    cc = jcc
    true, false = jnp.asarray(True), jnp.asarray(False)

    @staticmethod
    def words(bits):
        return jnp.asarray(_pack(bits).astype(np.uint32))

    @staticmethod
    def ints(a):
        return jnp.asarray(np.asarray(a, np.int32))

    @staticmethod
    def mask(a):
        return jnp.asarray(np.asarray(a, bool))

    @staticmethod
    def cache(closure, dirty):
        return jcc.ClosureCache(closure, jnp.asarray(dirty),
                                jnp.zeros((), jnp.float32))


class _Torch:
    cc = tcc
    true, false = True, False

    @staticmethod
    def words(bits):
        return torch.from_numpy(_pack(bits).view(np.int32).copy())

    @staticmethod
    def ints(a):
        return torch.from_numpy(np.asarray(a, np.int32).copy())

    @staticmethod
    def mask(a):
        return torch.from_numpy(np.asarray(a, bool).copy())

    @staticmethod
    def cache(closure, dirty):
        return tcc.ClosureCache(closure, dirty,
                                torch.zeros((), dtype=torch.float32))


def scenario(x, g):
    """Every tiled operation on graph ``g`` through package adapter ``x``;
    returns {name: tuple of outputs}."""
    cc = x.cc
    out = {}
    adj = {k: x.words(v) for k, v in g.items() if k.startswith("adj")}
    empty = cc.empty_tiled_cache(C, R, dirty=True)
    cl0, n = cc.refresh_closure(empty.closure, empty.dirty, adj["adj0"])
    out["empty_tiled_cache"] = (empty.closure.tiles, empty.closure.summary)
    out["refresh_rebuilds_the_window"] = (cl0.tiles, cl0.summary, n)
    stale, n = cc.refresh_closure(cl0, x.true, adj["adj_spill"])
    out["refresh_keeps_a_stale_window"] = (stale.tiles, n)

    fold, ok = g["fold"], g["fold_ok"]
    cl1, spilled = cc.insert_update_tiled(cl0, x.ints(fold[:, 0]),
                                          x.ints(fold[:, 1]), x.mask(ok))
    out["insert_update_tiled_fold"] = (cl1.tiles, cl1.summary, spilled)
    sp, spilled = cc.insert_update_tiled(
        cl1, x.ints([3, 5]), x.ints([9, 70]), x.mask([True, True]))
    out["insert_update_tiled_spill"] = (sp.tiles, sp.summary, spilled)

    cache1 = x.cache(cl1, False)
    rem = g["rem"]
    d_rem = cc.CacheDelta.edges_removed(x.ints(rem[:, 0]), x.ints(rem[:, 1]),
                                        x.mask(np.ones(len(rem), bool)))
    for name, fn in (("repair", lambda n, d: x.true),
                     ("invalidate", lambda n, d: x.false),
                     ("default_arm", None)):
        c, st = cc.commit(cache1, d_rem, adj["adj2"], prefer_repair_fn=fn,
                          with_stats=True)
        out[f"commit_{name}"] = (c.closure.tiles, c.closure.summary,
                                 c.dirty, c.repair_ema, st["n_products"],
                                 st["row_products"], st["n_repair"])
    d_blocked = cc.CacheDelta.vertices_cleared(x.ints([3, 200]),
                                               x.mask([True, True]))
    c, st = cc.commit(cache1, d_blocked, adj["adj1"], with_stats=True)
    out["commit_blocked_seed"] = (c.closure.tiles, c.dirty, st["n_repair"])
    d_spill = cc.CacheDelta.edges_added(x.ints([1, 5]), x.ints([2, 70]),
                                        x.mask([True, True]))
    c = cc.commit(cache1, d_spill, adj["adj_spill"])
    out["commit_spilling_add"] = (c.closure.tiles, c.closure.summary,
                                  c.dirty)
    add3 = g["add3"]
    d_add = cc.CacheDelta.edges_added(x.ints(add3[:, 0]), x.ints(add3[:, 1]),
                                      x.mask(np.ones(len(add3), bool)))
    merged = cc.CacheDelta.merge(d_rem, d_add)
    c, st = cc.commit(cache1, merged, adj["adj3"],
                      prefer_repair_fn=lambda n, d: x.true, with_stats=True)
    out["commit_merged_repair_and_fold"] = (
        c.closure.tiles, c.closure.summary, c.dirty, st["n_products"],
        st["row_products"], cc.cache_matches_state(c, adj["adj3"]))
    applied = cc.apply_delta(cl1, adj["adj3"], merged)
    out["apply_delta"] = (applied.tiles, applied.summary)

    wide = cc.grow_region(cl1, 128)
    out["grow_region"] = (wide.tiles, wide.summary)
    grown = cc.grow_closure(cl1, 512)
    out["grow_closure"] = (grown.tiles, grown.summary)
    dense = cc.dense_of(cl1)
    back = cc.tiled_of(dense, R)
    out["dense_of_and_tiled_of"] = (dense, back.tiles, back.summary)
    occ = cc.summary_from_occ(
        (cl1.tiles.reshape(R // 32, 32, R // 32) != 0).any(1), C)
    out["summary_from_occ_and_build_summary"] = (
        occ, cc.build_summary(cl1.tiles, C))
    us, vs = x.ints([0, 3, 70, 9, 47, 40]), x.ints([47, 70, 3, 2, 0, 1])
    cand = x.mask([True, True, True, True, True, False])
    out["candidate_hop_matrix"] = (cc.candidate_hop_matrix(cl1, us, vs, cand),
                                   cc.incremental_cycle_check(cl1, us, vs,
                                                              cand))
    out["closure_bit_get"] = (cc.closure_bit_get(cl1, us, vs),
                              cc.closure_bit_get(cl1, vs, us))
    out["cache_matches_state"] = (
        cc.cache_matches_state(cache1, adj["adj1"]),
        cc.cache_matches_state(cache1, adj["adj2"]),
        cc.cache_matches_state(cache1, adj["adj_spill"]),
        cc.cache_matches_state(x.cache(cl1, True), adj["adj2"]))
    return out


def _np(v):
    """One output as a numpy array; packed words compare as int32."""
    a = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
    return a.view(np.int32) if a.dtype == np.uint32 else a


@pytest.fixture(scope="module")
def outputs():
    g = _graph()
    ref = jax.jit(lambda: scenario(_Jax, g))()
    mine = scenario(_Torch, g)
    return ref, mine


NAMES = ["empty_tiled_cache", "refresh_rebuilds_the_window",
         "refresh_keeps_a_stale_window", "insert_update_tiled_fold",
         "insert_update_tiled_spill", "commit_repair", "commit_invalidate",
         "commit_default_arm", "commit_blocked_seed", "commit_spilling_add",
         "commit_merged_repair_and_fold", "apply_delta", "grow_region",
         "grow_closure", "dense_of_and_tiled_of",
         "summary_from_occ_and_build_summary", "candidate_hop_matrix",
         "closure_bit_get", "cache_matches_state"]


@pytest.mark.parametrize("name", NAMES)
def test_tiled_operation_matches_reference(name, outputs):
    ref, mine = outputs
    assert set(ref) == set(mine) == set(NAMES)
    assert len(ref[name]) == len(mine[name])
    for i, (want, got) in enumerate(zip(ref[name], mine[name])):
        want, got = _np(want), _np(got)
        if want.dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=0, atol=EMA_ATOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{name}[{i}]")


def test_the_scenario_reaches_every_branch(outputs):
    """The graph is chosen so that each guard fires where it should."""
    _, mine = outputs
    assert mine["insert_update_tiled_spill"][2] is True
    assert mine["insert_update_tiled_fold"][2] is False
    assert mine["commit_repair"][2] is False and mine["commit_repair"][6] == 1
    assert mine["commit_invalidate"][2] is True
    assert mine["commit_blocked_seed"][1] is True
    assert mine["commit_spilling_add"][2] is True
    assert mine["commit_merged_repair_and_fold"][5] is True
    assert mine["refresh_rebuilds_the_window"][2] > 0
    assert mine["refresh_keeps_a_stale_window"][1] == 0
    assert mine["cache_matches_state"] == (True, False, False, True)
