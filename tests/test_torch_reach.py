"""Algorithms 1 and 2 of the port (`repro_torch.core.reachability`,
`repro_torch.core.snapshot`) against the reference.

Random DAGs and cyclic graphs made from a seed with numpy; reach sets,
closures, hit bits, product counts and per-query deciding depths are
integer- or bit-valued and must be identical.
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
from repro.core import reachability as jreach  # noqa: E402
from repro.core import snapshot as jsnap  # noqa: E402
from repro_torch.core import bitset as tb  # noqa: E402
from repro_torch.core import reachability as treach  # noqa: E402
from repro_torch.core import snapshot as tsnap  # noqa: E402

CAP = 128

_closure_ref = jax.jit(lambda a: jreach.transitive_closure(a, with_stats=True))
_reach_ref = jax.jit(jreach.reach_sets)
_decided_ref = jax.jit(lambda a, s, tg: jsnap.reach_until_decided(
    a, s, tg, with_depths=True))
_acyclic_ref = jax.jit(jreach.is_acyclic)


def graph(seed, density=0.03, dag=True):
    rng = np.random.default_rng(seed)
    a = rng.random((CAP, CAP)) < density
    a = np.triu(a, 1) if dag else a
    return rng, np.asarray(jb.pack_bits(jnp.asarray(a)))


def t(a):
    return torch.from_numpy(np.array(a).view(np.int32))


def u32(x):
    return x.numpy().view(np.uint32)


@pytest.mark.parametrize("seed,dag", [(0, True), (1, True), (2, False)])
def test_transitive_closure_and_product_count(seed, dag):
    _, adj = graph(seed, dag=dag)
    want, want_n = _closure_ref(jnp.asarray(adj))
    got, got_n = treach.transitive_closure(t(adj), with_stats=True)
    np.testing.assert_array_equal(u32(got), np.asarray(want))
    assert got_n == int(want_n)
    assert bool(treach.is_acyclic(t(adj))) == bool(
        _acyclic_ref(jnp.asarray(adj))) == dag


@pytest.mark.parametrize("seed", [3, 4])
def test_reach_sets_and_path_exists(seed):
    rng, adj = graph(seed, density=0.05)
    src_bits = rng.random((16, CAP)) < 0.03
    src = np.asarray(jb.pack_bits(jnp.asarray(src_bits)))
    want = _reach_ref(jnp.asarray(adj), jnp.asarray(src))
    got = treach.reach_sets(t(adj), t(src))
    np.testing.assert_array_equal(u32(got), np.asarray(want))
    # reach == rows of the strict closure for one-hot sources
    slots = rng.integers(0, CAP, 16).astype(np.int32)
    onehot = tb.onehot_rows(torch.from_numpy(slots), CAP)
    closure = treach.transitive_closure(t(adj))
    assert torch.equal(treach.reach_sets(t(adj), onehot),
                       closure[torch.from_numpy(slots).long()])


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_reach_until_decided_depths(seed):
    """Hit bits, n_products and the per-query deciding hop equal the
    reference's, dead (all-zero) seeds included."""
    rng, adj = graph(seed, density=0.04)
    src_bits = rng.random((24, CAP)) < 0.02
    src_bits[:3] = False                        # never-seeded rows
    src = np.asarray(jb.pack_bits(jnp.asarray(src_bits)))
    tgt = rng.integers(0, CAP, 24).astype(np.int32)
    hit, n, depth = _decided_ref(jnp.asarray(adj), jnp.asarray(src),
                                 jnp.asarray(tgt))
    got_hit, got_n, got_depth = tsnap.reach_until_decided(
        t(adj), t(src), torch.from_numpy(tgt), with_depths=True)
    np.testing.assert_array_equal(got_hit.numpy(), np.asarray(hit))
    assert got_n == int(n)
    np.testing.assert_array_equal(got_depth.numpy(), np.asarray(depth))
    # partial and full scans answer PathExists identically
    full = treach.reach_sets(t(adj), t(src))
    rows = torch.arange(24)
    assert torch.equal(got_hit, tb.bit_get(full, rows,
                                           torch.from_numpy(tgt)))


def test_iteration_bound_matches_reference():
    for c in (1, 2, 3, 32, 33, 1024, 16384, 65536):
        assert treach.closure_iteration_bound(c) == \
            jreach.closure_iteration_bound(c)
