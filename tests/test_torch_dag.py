"""The port's slab (`repro_torch.core.dag`) against the reference
(`repro.core.dag`) and against the sequential oracle.

Randomized mixed batches, made from a seed with numpy, go through both
packages; keys, alive, adj, n_overflow, ok bits and the emitted
`CacheDelta`s must be identical (all bit- or integer-valued).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the tensors here are small: one intra-op thread each keeps the test
# workers from contending for the cores
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dag as jdag  # noqa: E402
from repro.core.oracle import SeqGraph, apply_op_batch_oracle  # noqa: E402
from repro_torch.core import dag as tdag  # noqa: E402
from repro_torch.core import oracle as toracle  # noqa: E402

CAP = 64
B = 12
OPS = [tdag.REMOVE_VERTEX, tdag.ADD_VERTEX, tdag.REMOVE_EDGE, tdag.ADD_EDGE,
       tdag.CONTAINS_VERTEX, tdag.CONTAINS_EDGE]


def t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def same_state(ts, js):
    np.testing.assert_array_equal(ts.keys.numpy(), np.asarray(js.keys))
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    np.testing.assert_array_equal(ts.adj.numpy().view(np.uint32),
                                  np.asarray(js.adj))
    assert int(ts.n_overflow) == int(js.n_overflow)


def same_delta(td, jd):
    for name, tv, jv in zip(jd._fields, td, jd):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                      err_msg=name)


def rand_batch(rng, key_space=20):
    op = rng.choice(OPS, B).astype(np.int32)
    a = rng.integers(0, key_space, B).astype(np.int32)
    b = rng.integers(0, key_space, B).astype(np.int32)
    return op, a, b


_apply_ref = jax.jit(lambda st, op, a, b: jdag.apply_op_batch_impl(
    st, op, a, b, acyclic=False))
# the reference's ops, compiled once each (eager dispatch of every small
# op costs far more than one compile)
J = {name: jax.jit(getattr(jdag, name)) for name in (
    "add_vertices", "add_edges", "remove_edges_delta",
    "remove_vertices_delta", "contains_edges", "edge_count",
    "live_vertex_count")}


def test_op_codes_match_reference():
    for name in ("REMOVE_VERTEX", "ADD_VERTEX", "REMOVE_EDGE", "ADD_EDGE",
                 "CONTAINS_VERTEX", "CONTAINS_EDGE"):
        assert getattr(tdag, name) == getattr(jdag, name)
    assert tdag.EMPTY_KEY == int(jdag.EMPTY_KEY)


@pytest.mark.parametrize("seed", range(3))
def test_mixed_batches_match_reference_and_oracle(seed):
    """Unconstrained mixed batches (rv -> av -> re -> ae -> reads) on a
    slab small enough to overflow: same state and ok bits as the
    reference after every batch, and the same ok bits as sequential
    replay."""
    rng = np.random.default_rng(seed)
    cap = 32
    ts, js = tdag.new_state(cap), jdag.new_state(cap)
    g = SeqGraph(capacity=cap)
    for _ in range(8):
        op, a, b = rand_batch(rng, key_space=48)
        ts, tok = tdag.apply_op_batch_impl(ts, t(op), t(a), t(b))
        js, jok = _apply_ref(js, jnp.asarray(op), jnp.asarray(a),
                             jnp.asarray(b))
        same_state(ts, js)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        want = apply_op_batch_oracle(g, op, a, b)
        np.testing.assert_array_equal(tok.numpy(), want)
    assert int(ts.n_overflow) == g.n_overflow


@pytest.mark.parametrize("seed", range(2))
def test_delta_variants_match_reference(seed):
    """`remove_edges_delta` / `remove_vertices_delta` emit the same
    adjacency-diff exact deltas (duplicated and absent pairs included)."""
    rng = np.random.default_rng(10 + seed)
    ts, js = tdag.new_state(CAP), jdag.new_state(CAP)
    keys = np.arange(40, dtype=np.int32)
    ts, _ = tdag.add_vertices(ts, t(keys))
    js, _ = J["add_vertices"](js, jnp.asarray(keys))
    us = rng.integers(0, 40, 60).astype(np.int32)
    vs = rng.integers(0, 40, 60).astype(np.int32)
    ts, _ = tdag.add_edges(ts, t(us), t(vs))
    js, _ = J["add_edges"](js, jnp.asarray(us), jnp.asarray(vs))
    same_state(ts, js)
    du = np.concatenate([us[:10], us[:3], [45, 46]]).astype(np.int32)
    dv = np.concatenate([vs[:10], vs[:3], [1, 2]]).astype(np.int32)
    dv[9] = (dv[9] + 1) % 40                      # likely absent pair
    ts, tok, tdelta = tdag.remove_edges_delta(ts, t(du), t(dv))
    js, jok, jdelta = J["remove_edges_delta"](js, jnp.asarray(du),
                                              jnp.asarray(dv))
    same_state(ts, js)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    same_delta(tdelta, jdelta)
    fins = np.asarray([3, 3, 7, 50, 11, 39], np.int32)
    ts, tok, tdelta = tdag.remove_vertices_delta(ts, t(fins))
    js, jok, jdelta = J["remove_vertices_delta"](js, jnp.asarray(fins))
    same_state(ts, js)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    same_delta(tdelta, jdelta)


def test_grow_state_and_reads_match_reference():
    rng = np.random.default_rng(3)
    ts, js = tdag.new_state(32), jdag.new_state(32)
    keys = rng.permutation(100)[:30].astype(np.int32)
    ts, _ = tdag.add_vertices(ts, t(keys))
    js, _ = J["add_vertices"](js, jnp.asarray(keys))
    us, vs = keys[:20], keys[10:30]
    ts, _ = tdag.add_edges(ts, t(us), t(vs))
    js, _ = J["add_edges"](js, jnp.asarray(us), jnp.asarray(vs))
    ts = tdag.grow_state(ts, 96)
    js = jax.jit(jdag.grow_state, static_argnums=1)(js, 96)
    same_state(ts, js)
    q = rng.choice(keys, 16).astype(np.int32)
    np.testing.assert_array_equal(
        tdag.contains_edges(ts, t(q), t(q[::-1].copy())).numpy(),
        np.asarray(J["contains_edges"](js, jnp.asarray(q),
                                       jnp.asarray(q[::-1].copy()))))
    assert int(tdag.edge_count(ts)) == int(J["edge_count"](js))
    assert int(tdag.live_vertex_count(ts)) == int(J["live_vertex_count"](js))
    with pytest.raises(ValueError, match="cannot shrink"):
        tdag.grow_state(ts, 32)


def test_sequential_baseline_matches_port_oracle():
    """`apply_op_sequential` (one op at a time, cycle-checked) against the
    port's own copy of the oracle replayed one op per batch."""
    rng = np.random.default_rng(4)
    st = tdag.new_state(CAP)
    g = toracle.SeqGraph(capacity=CAP)
    for _ in range(3):
        op, a, b = rand_batch(rng, key_space=10)
        st, res = tdag.apply_op_sequential(st, t(op), t(a), t(b),
                                           acyclic=True,
                                           method="incremental")
        want = []
        for i in range(B):
            want += toracle.apply_op_batch_oracle(
                g, op[i:i + 1], a[i:i + 1], b[i:i + 1], acyclic=True)
        np.testing.assert_array_equal(res.numpy(), want)
    assert g.is_acyclic()
