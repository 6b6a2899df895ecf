"""The port's dense closure cache (`repro_torch.core.closure_cache`)
against the reference (`repro.core.closure_cache`).

Inputs are random DAGs and edit streams made from a seed with numpy.
Closure words, affected rows, product counts and the repair-vs-invalidate
choice are bit- or integer-valued and must be identical; the float32
``repair_ema`` must agree within 1e-6 absolute (both sides compute it in
float32 from the same integer depths, so in practice it is identical).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the tensors here are small: one intra-op thread each keeps the test
# workers from contending for the cores
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bitset as jb  # noqa: E402
from repro.core import closure_cache as jcc  # noqa: E402
from repro.core import dag as jdag  # noqa: E402
from repro.core import reachability as jreach  # noqa: E402
from repro_torch.core import closure_cache as tcc  # noqa: E402
from repro_torch.core import dag as tdag  # noqa: E402
from repro_torch.core import reachability as treach  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CAP = 64
EMA_ATOL = 1e-6

_closure_ref = jax.jit(jreach.transitive_closure)
_insert_ref = jax.jit(jcc.insert_update)
_affected_ref = jax.jit(jcc.affected_rows)
_scan_ref = jax.jit(jcc.masked_delete_scan)
_remove_ref = jax.jit(jdag.remove_edges_delta)
_commit_ref = jax.jit(lambda cache, delta, adj: jcc.commit(
    cache, delta, adj, with_stats=True))


def t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def u32(x):
    return x.numpy().view(np.uint32)


def dag_adj(rng, density):
    return np.asarray(jb.pack_bits(jnp.asarray(
        np.triu(rng.random((CAP, CAP)) < density, 1))))


@pytest.mark.parametrize("seed", range(3))
def test_insert_update_matches_reference(seed):
    """The rank-B fold (hop graph, Sstar, mask, padded rows), with chained
    accepted edges and a non-multiple-of-32 batch."""
    rng = np.random.default_rng(seed)
    adj = dag_adj(rng, 0.04)
    closure = np.asarray(_closure_ref(jnp.asarray(adj)))
    b = 20
    u = rng.integers(0, CAP, b).astype(np.int32)
    v = rng.integers(0, CAP, b).astype(np.int32)
    u[1], v[0] = v[0], 5                   # a chain of accepted edges
    acc = rng.random(b) < 0.7
    want = _insert_ref(jnp.asarray(closure), jnp.asarray(u), jnp.asarray(v),
                       jnp.asarray(acc))
    got = tcc.insert_update(t(closure), t(u), t(v), t(acc))
    np.testing.assert_array_equal(u32(got), np.asarray(want))
    np.testing.assert_array_equal(
        tcc.incremental_cycle_check(t(closure), t(u), t(v), t(acc)).numpy(),
        np.asarray(jcc.incremental_cycle_check(
            jnp.asarray(closure), jnp.asarray(u), jnp.asarray(v),
            jnp.asarray(acc))))


@pytest.mark.parametrize("seed", range(3))
def test_affected_rows_and_masked_scan_match_reference(seed):
    rng = np.random.default_rng(20 + seed)
    a = np.triu(rng.random((CAP, CAP)) < 0.06, 1)
    adj = np.asarray(jb.pack_bits(jnp.asarray(a)))
    closure = np.asarray(_closure_ref(jnp.asarray(adj)))
    us, vs = np.nonzero(a)
    pick = rng.choice(len(us), 4, replace=False)
    a2 = a.copy()
    a2[us[pick], vs[pick]] = False
    adj2 = np.asarray(jb.pack_bits(jnp.asarray(a2)))
    seeds = np.concatenate([us[pick], [0]]).astype(np.int32)
    mask = np.asarray([True, True, False, True, True])
    want_aff = _affected_ref(jnp.asarray(closure), jnp.asarray(seeds),
                             jnp.asarray(mask))
    got_aff = tcc.affected_rows(t(closure), t(seeds), t(mask))
    np.testing.assert_array_equal(got_aff.numpy(), np.asarray(want_aff))
    want, n, rows = _scan_ref(jnp.asarray(adj2), jnp.asarray(closure),
                              want_aff)
    got, got_n, got_rows = tcc.masked_delete_scan(t(adj2), t(closure),
                                                  got_aff)
    np.testing.assert_array_equal(u32(got), np.asarray(want))
    assert (got_n, got_rows) == (int(n), int(rows))
    # with every affected seed enabled the repair is the full closure
    all_aff = tcc.affected_rows(t(closure), t(seeds[:4]),
                                torch.ones(4, dtype=torch.bool))
    fixed, _, _ = tcc.masked_delete_scan(t(adj2), t(closure), all_aff)
    assert torch.equal(fixed, treach.transitive_closure(t(adj2)))


@pytest.mark.parametrize("seed", range(4))
def test_commit_sequence_matches_reference(seed):
    """Edge-removal commits on a clean cache: after every commit the
    closure words, the repair-vs-invalidate choice (dirty, n_repair), the
    product counts and repair_ema (float32, within 1e-6) equal the
    reference's; a dirty cache is refreshed on both sides and the stream
    goes on."""
    rng = np.random.default_rng(40 + seed)
    # dense enough that some removals have too many ancestors to repair
    density = 0.05 + 0.1 * (seed % 2)
    ts = tdag.new_state(CAP)
    js = jdag.new_state(CAP)
    keys = np.arange(CAP, dtype=np.int32)
    ts, _ = tdag.add_vertices(ts, t(keys))
    js, _ = jdag.add_vertices(js, jnp.asarray(keys))
    a = np.triu(rng.random((CAP, CAP)) < density, 1)
    us, vs = (x.astype(np.int32) for x in np.nonzero(a))
    ts, _ = tdag.add_edges(ts, t(us), t(vs))
    js, _ = jdag.add_edges(js, jnp.asarray(us), jnp.asarray(vs))
    jcache = jcc.rebuild_cache(js.adj)
    tcache = tcc.rebuild_cache(ts.adj)
    choices = []
    for _ in range(8):
        pick = rng.choice(len(us), 6, replace=False)
        du, dv = us[pick], vs[pick]
        ts, _, tdelta = tdag.remove_edges_delta(ts, t(du), t(dv))
        js, _, jdelta = _remove_ref(js, jnp.asarray(du), jnp.asarray(dv))
        jcache, jst = _commit_ref(jcache, jdelta, js.adj)
        tcache, tst = tcc.commit(tcache, tdelta, ts.adj, with_stats=True)
        assert tcache.dirty == bool(jcache.dirty)
        np.testing.assert_array_equal(u32(tcache.closure),
                                      np.asarray(jcache.closure))
        assert abs(float(tcache.repair_ema) - float(jcache.repair_ema)) \
            <= EMA_ATOL
        assert {k: int(v) for k, v in jst.items()} == tst
        choices.append(tst["n_repair"])
        if tcache.dirty:
            assert tcc.cache_matches_state(tcache, ts.adj)
            jcache = jcc.ClosureCache(_closure_ref(js.adj),
                                      jnp.asarray(False), jcache.repair_ema)
            tcache = tcache._replace(
                closure=treach.transitive_closure(ts.adj), dirty=False)
        else:
            assert tcc.cache_matches_state(tcache, ts.adj)
    assert 1 in choices                      # at least one repair ran


def test_commit_repair_and_invalidate_both_occur():
    """The delete dispatch arm declines when the affected region is large
    (every row is an ancestor of the removed edge's source)."""
    c = 64
    ts = tdag.new_state(c)
    ts, _ = tdag.add_vertices(ts, torch.arange(c, dtype=torch.int32))
    chain_u = torch.arange(c - 1, dtype=torch.int32)
    ts, _ = tdag.add_edges(ts, chain_u, chain_u + 1)
    cache = tcc.rebuild_cache(ts.adj)
    ts2, _, delta = tdag.remove_edges_delta(
        ts, torch.tensor([c - 2], dtype=torch.int32),
        torch.tensor([c - 1], dtype=torch.int32))
    out, st = tcc.commit(cache, delta, ts2.adj, with_stats=True)
    assert out.dirty and st["n_repair"] == 0       # 63 ancestors: invalidate
    ts3, _, delta = tdag.remove_edges_delta(
        ts, torch.tensor([0], dtype=torch.int32),
        torch.tensor([1], dtype=torch.int32))
    out, st = tcc.commit(cache, delta, ts3.adj, with_stats=True)
    assert not out.dirty and st["n_repair"] == 1   # 1 affected row: repair
    assert tcc.cache_matches_state(out, ts3.adj)
    assert float(out.repair_ema) == st["n_products"]


def test_chunked_update_impl_matches_default():
    rng = np.random.default_rng(8)
    closure = t(dag_adj(rng, 0.1))
    mask = t(np.asarray(jb.pack_bits(jnp.asarray(rng.random((CAP, 32))
                                                 < 0.2))))
    rows = t(np.asarray(jb.pack_bits(jnp.asarray(rng.random((32, CAP))
                                                 < 0.1))))
    want = ops.closure_update(closure, mask, rows, impl="ref")
    assert torch.equal(tcc.chunked_update_impl(16)(closure, mask, rows), want)
    assert torch.equal(tcc.chunked_update_impl(48)(closure, mask, rows), want)
