"""The port's sharded engine (`repro_torch.core.sharded`, ``DagEngine.create(
..., backend="sharded")``) against the reference, on the CPU.

A mesh here is D row shards of the CPU (``make_dag_mesh("cpu",
n_shards=D)``), the counterpart of the reference's fake host devices.  The
reference's own sharded engine does not run in this process (its first
``add_vertices`` on a mesh fails on this jax), so the port's sharded engine
is held against the reference's LOCAL engine, and the port's schedule
functions against the reference's single-device functions, which is the
equality the reference's tests assert:
  * every schedule function at D in {1, 2, 4} on the seeded 2%-dense C=256
    adjacency of `tests/test_sharded_dag.py`, against `reachability.
    reach_sets` / `transitive_closure` / `is_acyclic`, `snapshot.
    reach_until_decided`, `closure_cache.masked_delete_scan`,
    `kernels/ref.closure_update_ref` and `acyclic.acyclic_add_edges_impl`
    (a DAG with back edges); at D = 1 also against the
    reference's explicit sharded functions on a one-device mesh;
  * the delete scan's counters at D > 1 against the reference's
    `closure_delete_impl` on a one-device mesh run once per row block,
    with ``affected`` cleared outside the block: its hops are that
    block's own (``pmax`` / ``psum`` over blocks);
  * one jitted reference stream per configuration (methods auto, closure,
    partial, incremental; subbatches 1 and 4; each layout an item) through
    the reference's local engine and the port's D = 4 sharded engine:
    every leaf but ``depth_ema``, ok bits, ``n_overflow``, epoch, the
    stats (``row_products`` where no delete repair ran: a sharded repair
    counts each block's own hops; the largest per-shard deciding depth),
    ``reachable`` on both scan plans and ``is_acyclic``; the D-entry
    ``depth_ema`` is the policy's fold of the per-shard depths;
  * the per-shard deciding depths and the D-entry EMA against the
    reference's ``acyclic_add_edges_impl(..., n_shards=4)``;
  * ``grow`` / ``auto_grow`` / ``with_closure_layout`` / ``snapshot`` on
    the mesh against the local engine; the capacity and ``B % D`` errors;
  * a writer on the mesh ships the local writer's log entry for entry, and
    a `shard_replica` replays it to the same bits;
  * a checkpoint saved from a local engine restores onto a sharded one
    (also grown forward and across layouts) and back, byte for byte.
Every reference stream is jitted and run once (67 XLA compilations).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import DagEngine as JEngine  # noqa: E402
from repro.api import OpBatch as JBatch  # noqa: E402
from repro.core import acyclic as jacy  # noqa: E402
from repro.core import closure_cache as jcc  # noqa: E402
from repro.core import dag as jdag  # noqa: E402
from repro.core import dispatch as jdisp  # noqa: E402
from repro.core import reachability as jreach  # noqa: E402
from repro.core import sharded as jsh  # noqa: E402
from repro.core import snapshot as jsnap  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import replica as trep  # noqa: E402
from repro_torch.core import closure_cache as tcc  # noqa: E402
from repro_torch.core import dispatch as tdisp  # noqa: E402
from repro_torch.core import sharded as tsh  # noqa: E402
from repro_torch.core import snapshot as tsnap  # noqa: E402
from repro_torch.core.dag import DagState as TState  # noqa: E402
from repro_torch.core.engine import DagEngine as TEngine  # noqa: E402
from repro_torch.core.engine import OpBatch as TBatch  # noqa: E402
from repro_torch.core.engine import as_compiled  # noqa: E402
from repro_torch.ft import checkpoint as tckpt  # noqa: E402

C = 256
SHARDS = (1, 2, 4)
EMA_ATOL = 1e-6
OP_CODES = [jdag.REMOVE_VERTEX, jdag.ADD_VERTEX, jdag.REMOVE_EDGE,
            jdag.ADD_EDGE, jdag.CONTAINS_VERTEX, jdag.CONTAINS_EDGE]
OP_P = [0.05, 0.2, 0.15, 0.4, 0.1, 0.1]


@pytest.fixture(scope="module", autouse=True)
def _fresh_xla_caches():
    # the executables cached before and during this module hold memory
    # maps; free them so this worker stays far from the kernel's limit
    jax.clear_caches()
    yield
    jax.clear_caches()


def mesh(d):
    return tsh.make_dag_mesh("cpu", n_shards=d)


def pack(bits):
    """bool (..., n) -> uint32 (..., n/32), LSB first (the bit layout)."""
    return np.packbits(bits, axis=-1, bitorder="little").view("<u4") \
        .astype(np.uint32)


def t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def words(x):
    """A port or reference bit matrix as numpy uint32 (bool stays bool)."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
        return x.view(np.uint32) if x.dtype == np.int32 else x
    return np.asarray(x)


def same_bits(got, want, what):
    np.testing.assert_array_equal(words(got), words(want), err_msg=what)


def seeded_adj(seed=0):
    """`tests/test_sharded_dag.py`'s input: C=256, 2% dense, no loops."""
    rng = np.random.default_rng(seed)
    a = rng.random((C, C)) < 0.02
    np.fill_diagonal(a, False)
    return pack(a)


def queries(n, mult_src, mult_tgt):
    src = pack(np.eye(C, dtype=bool)[np.arange(n) * mult_src % C])
    tgt = (np.arange(n, dtype=np.int32)[::-1] * mult_tgt) % C
    return src, tgt


def delete_inputs():
    """(adj_after, closure, affected): the closure of a seeded 2%-dense
    DAG, a fifth of its edges removed, and the removed edges' sources and
    their ancestors as affected."""
    rng = np.random.default_rng(3)
    bits = np.triu(rng.random((C, C)) < 0.02, 1)
    closure = np.asarray(jax.jit(jreach.transitive_closure)(
        jnp.asarray(pack(bits))))
    rows, cols = np.nonzero(bits)
    pick = np.random.default_rng(1).random(rows.size) < 0.2
    cut = bits.copy()
    cut[rows[pick], cols[pick]] = 0
    seeds = jnp.asarray(rows[pick], jnp.int32)
    affected = np.asarray(jax.jit(jcc.affected_rows)(
        jnp.asarray(closure), seeds, jnp.asarray(np.ones(seeds.shape, bool))))
    return pack(cut.astype(bool)), closure, affected


# ---------------------------------------------------- schedule functions

def test_schedule_functions_match_reference():
    adj = seeded_adj()
    ja = jnp.asarray(adj)
    src16, tgt16 = queries(16, 1, 7)
    src64, tgt64 = queries(64, 3, 5)
    reach = np.asarray(jax.jit(jreach.reach_sets)(ja, jnp.asarray(src16)))
    closure = np.asarray(jax.jit(jreach.transitive_closure)(ja))
    decided = jax.jit(jsnap.reach_until_decided)
    hit16 = np.asarray(decided(ja, jnp.asarray(src16), jnp.asarray(tgt16)))
    hit64 = np.asarray(decided(ja, jnp.asarray(src64), jnp.asarray(tgt64)))
    acyclic = bool(jax.jit(jreach.is_acyclic)(ja))
    hop16 = np.asarray(jax.jit(jref.bitmm_ref)(jnp.asarray(src16), ja))
    adj_after, cl, affected = delete_inputs()
    del_r, del_n, _ = jax.jit(jcc.masked_delete_scan)(
        jnp.asarray(adj_after), jnp.asarray(cl), jnp.asarray(affected))
    rng = np.random.default_rng(2)
    mask = pack(rng.random((C, 64)) < 0.05)
    rows = pack(rng.random((64, C)) < 0.05)
    # AcyclicAddEdge on the DAG, with back edges that close cycles
    keys = np.arange(C, dtype=np.int32)
    us, vs = (rng.integers(0, C, 64).astype(np.int32) for _ in range(2))
    js, jok = jax.jit(functools.partial(
        jacy.acyclic_add_edges_impl, method="partial"))(
            jdag.DagState(*map(jnp.asarray, (keys, np.ones(C, bool), adj_after,
                                            np.int32(0)))),
            jnp.asarray(us), jnp.asarray(vs))
    state = TState(t(keys), torch.ones(C, dtype=torch.bool),
                         t(adj_after), torch.zeros((), dtype=torch.int32))
    upd = jax.jit(jref.closure_update_ref)(jnp.asarray(closure),
                                           jnp.asarray(mask),
                                           jnp.asarray(rows))
    a, s16, s64 = t(adj), t(src16), t(src64)
    got = {}
    for d in SHARDS:
        m = mesh(d)
        at = f"at D={d}"
        got[d] = {
            "reach": tsh.reach_sets_sharded(m, a, s16),
            "closure": tsh.transitive_closure_sharded(m, a),
            "frontier16": tsh.reach_until_decided_sharded(m, a, s16,
                                                          t(tgt16)),
            "batch64": tsh.reach_until_decided_batch_sharded(m, a, s64,
                                                             t(tgt64)),
            "update": tsh.closure_update_impl(m)(t(closure), t(mask),
                                                 t(rows)),
        }
        same_bits(got[d]["reach"], reach, f"reach_sets {at}")
        same_bits(got[d]["closure"], closure, f"transitive_closure {at}")
        np.testing.assert_array_equal(got[d]["frontier16"].numpy(), hit16)
        np.testing.assert_array_equal(got[d]["batch64"].numpy(), hit64)
        for n, (s, tg, want) in {16: (s16, tgt16, hit16),
                                 64: (s64, tgt64, hit64)}.items():
            auto = tsh.reach_until_decided_auto_sharded(m, a, s, t(tg))
            np.testing.assert_array_equal(auto.numpy(), want,
                                          err_msg=f"auto, B={n} {at}")
        # the partial scan through each plan's per-hop product
        for plan in ("frontier", "batch"):
            hit = tsnap.reach_until_decided(
                a, s64, t(tgt64), tsh.partial_scan_matmul_impl(m, plan))
            np.testing.assert_array_equal(hit.numpy(), hit64,
                                          err_msg=f"{plan} plan {at}")
        same_bits(tsh.expand_frontier_sharded(m, a, s16), hop16,
                  f"a hop {at}")
        # the engine's product: rows split when they divide, else frontier
        k = d * 3 + 1
        same_bits(tsh.engine_matmul_impl(m)(t(src16[:k]), a), hop16[:k],
                  f"engine product on {k} rows {at}")
        assert bool(tsh.is_acyclic_sharded(m, a)) == acyclic
        same_bits(got[d]["update"], upd, f"closure_update_impl {at}")
        r, n, _ = tsh.closure_delete_impl(m)(t(adj_after), t(cl),
                                             t(affected))
        same_bits(r, del_r, f"closure_delete_impl {at}")
        assert n == int(del_n), f"delete hops {at}"
        for policy in (None, tdisp.FixedPolicy("incremental")):
            out = tsh.acyclic_add_edges_sharded(m, state, t(us), t(vs),
                                                policy=policy)
            np.testing.assert_array_equal(out[1].numpy(), np.asarray(jok),
                                          err_msg=f"{policy} {at}")
            same_bits(out[0].adj, js.adj, f"{policy} {at}")
        assert tcc.cache_matches_state(out[2], out[0].adj)
        if d > 1:
            with pytest.raises(ValueError, match="not divisible by mesh"):
                tsh.reach_until_decided_batch_sharded(m, a, s16[:d + 1],
                                                      t(tgt16[:d + 1]))
    # D = 1 against the reference's explicit schedules on a one-device mesh
    jm = jsh.make_dag_mesh(jax.devices()[:1])
    ref1 = {
        "reach": jax.jit(functools.partial(jsh.reach_sets_sharded, jm))(
            ja, jnp.asarray(src16)),
        "closure": jax.jit(functools.partial(
            jsh.transitive_closure_sharded, jm))(ja),
        "frontier16": jax.jit(functools.partial(
            jsh.reach_until_decided_sharded, jm))(
                ja, jnp.asarray(src16), jnp.asarray(tgt16)),
        "batch64": jax.jit(functools.partial(
            jsh.reach_until_decided_batch_sharded, jm))(
                ja, jnp.asarray(src64), jnp.asarray(tgt64)),
        "update": jax.jit(jsh.closure_update_impl(jm))(
            jnp.asarray(closure), jnp.asarray(mask), jnp.asarray(rows)),
    }
    for k, want in ref1.items():
        same_bits(got[1][k], want,
                  f"{k} vs the reference's sharded function at D=1")
    for plan in ("frontier", "batch"):
        # one hop of each plan (inside the reference's scan the batch plan's
        # row-sharded frontier meets a gather this jax refuses)
        want = jax.jit(jsh.partial_scan_matmul_impl(jm, plan))(
            jnp.asarray(src64), ja)
        same_bits(tsh.partial_scan_matmul_impl(mesh(1), plan)(s64, a), want,
                  f"the {plan} plan's hop vs the reference's at D=1")
    want_r, want_n, want_w = jax.jit(jsh.closure_delete_impl(jm))(
        jnp.asarray(adj_after), jnp.asarray(cl), jnp.asarray(affected))
    r, n, w = tsh.closure_delete_impl(mesh(1))(
        t(adj_after), t(cl), t(affected))
    same_bits(r, want_r, "closure_delete_impl vs the reference's at D=1")
    assert (n, w) == (int(want_n), int(want_w))


def test_delete_scan_counters_match_per_block_reference():
    """At D > 1 the scan's hop count is the largest block's and its work
    the sum of each block's hops x affected rows: the reference's
    `closure_delete_impl` on a one-device mesh, run once per row block
    with ``affected`` cleared outside it, gives each block's own.  Its hop
    matrix S is built from the whole mask, so the per-block runs get S
    as both matrices (``where(block, S, S)`` is S)."""
    adj_after, cl, affected = delete_inputs()
    ref = jax.jit(jsh.closure_delete_impl(jsh.make_dag_mesh(
        jax.devices()[:1])))
    full_r, _, _ = ref(jnp.asarray(adj_after), jnp.asarray(cl),
                       jnp.asarray(affected))
    s = jnp.asarray(np.where(affected[:, None], adj_after, cl))
    for d in SHARDS[1:]:
        hops, work = [], []
        rows = C // d
        for k in range(d):
            block = np.zeros(C, bool)
            block[k * rows:(k + 1) * rows] = True
            r, i, w = ref(s, s, jnp.asarray(affected & block))
            same_bits(np.asarray(r)[block], np.asarray(full_r)[block],
                      f"block {k} of {d}")
            hops.append(int(i))
            work.append(int(w))
        assert len(set(hops)) > 1, "the blocks' own depths should differ"
        r, n, w = tsh.closure_delete_impl(mesh(d))(
            t(adj_after), t(cl), t(affected))
        same_bits(r, full_r, f"closure at D={d}")
        assert (n, w) == (max(hops), sum(work)), (d, hops, work)


# ------------------------------------------------------- engine streams

def _stream(seed, n_calls=10, b=32, keys=48):
    """Mixed OpBatches: a batch of vertex adds, then every op kind."""
    rng = np.random.default_rng(seed)
    out = [(np.full(b, jdag.ADD_VERTEX), rng.permutation(keys)[:b],
            np.zeros(b))]
    for _ in range(n_calls - 1):
        out.append((rng.choice(OP_CODES, b, p=OP_P),
                    rng.integers(0, keys, b), rng.integers(0, keys, b)))
    return [tuple(np.asarray(x, np.int32) for x in xs) for xs in out]


def same_engine(te, je, ema, what):
    """Every leaf but depth_ema identical to the local engine's; the
    mesh's D-entry depth_ema within EMA_ATOL of ``ema``."""
    arrays = interop.engine_to_arrays(te)
    leaves = jax.tree_util.tree_leaves(je)
    names = interop.TILED_LEAVES if "cache.closure.tiles" in arrays \
        else interop.LEAVES
    for name, want in zip(names, leaves):
        got = arrays[name]
        if name == "depth_ema":
            np.testing.assert_array_equal(got, ema.numpy(), err_msg=what)
            continue
        got = got.view(np.uint32) if got.dtype == np.int32 \
            and np.asarray(want).dtype == np.uint32 else got
        np.testing.assert_array_equal(got, np.asarray(want),
                                      err_msg=f"{what}: leaf {name}")


_apply_ref = jax.jit(lambda e, b: e.apply(b))
# every method's reachable() is the exact answer: one program for all
_path_exists_ref = jax.jit(jreach.path_exists)


@pytest.mark.parametrize("layout", ["dense", "tiled"])
def test_engine_stream_matches_local_reference(layout):
    m4 = mesh(4)
    kw = {"closure_layout": layout}
    if layout == "tiled":
        kw["closure_region"] = 128
    rng = np.random.default_rng(9)
    f_keys = rng.integers(0, 48, 32).astype(np.int32)
    g_keys = rng.integers(0, 48, 32).astype(np.int32)
    for method in ("auto", "closure", "partial", "incremental"):
        for sb in (1, 4):
            what = f"{layout} {method} subbatches={sb}"
            je = JEngine.create(C, method=method, subbatches=sb, **kw)
            te = TEngine.create(C, backend="sharded", mesh=m4, method=method,
                                subbatches=sb, **kw)
            assert te.config.n_devices == 4 and te.device.type == "cpu"
            ema = torch.zeros(4)
            for i, xs in enumerate(_stream(40 + sb)):
                with as_compiled():
                    te, tr = te.apply(TBatch(*map(t, xs)))
                je, jr = _apply_ref(je, JBatch(*map(jnp.asarray, xs)))
                at = f"{what}, call {i}"
                np.testing.assert_array_equal(tr.ok.numpy(),
                                              np.asarray(jr.ok), err_msg=at)
                assert int(tr.n_overflow) == int(jr.n_overflow), at
                for field in ("n_products", "n_partial", "n_incremental",
                              "n_repair"):
                    assert getattr(tr.stats, field) == int(
                        getattr(jr.stats, field)), f"{at}: {field}"
                if tr.stats.n_repair == 0:
                    assert tr.stats.row_products == int(
                        jr.stats.row_products), at
                assert tr.stats.deciding_depth.shape == (4,)
                assert int(tr.stats.deciding_depth.max()) == int(
                    np.max(np.asarray(jr.stats.deciding_depth))), at
                # the engine folds the per-shard depths it reports (the
                # fold itself is held against the reference's below)
                ema = te.config.policy.update_depth_ema(
                    ema, tr.stats.deciding_depth)
                same_engine(te, je, ema, at)
            for n in (32, 12):    # the batch plan, then the frontier plan
                want = np.asarray(_path_exists_ref(
                    je.state, jnp.asarray(f_keys[:n]),
                    jnp.asarray(g_keys[:n])))
                np.testing.assert_array_equal(
                    te.reachable(t(f_keys[:n]), t(g_keys[:n])).numpy(), want,
                    err_msg=f"{what}: reachable, {n} queries")
            assert bool(te.is_acyclic())
            assert tcc.cache_matches_state(te.cache, te.state.adj)


_ema_fold = jax.jit(lambda pol, ema, d: pol.update_depth_ema(ema, d),
                    static_argnums=0)


def test_per_shard_stats_match_reference():
    """The sharded engine's per-shard deciding depths and its D-entry EMA
    equal the reference's ``acyclic_add_edges_impl(..., n_shards=4)`` and
    its policy's EMA fold, call by call, on the same state."""
    m4 = mesh(4)
    policies = {"partial": (tdisp.FixedPolicy("partial"),
                            jdisp.FixedPolicy("partial")),
                "auto": (tdisp.CostModelPolicy(use_incremental=False),
                         jdisp.CostModelPolicy(use_incremental=False))}
    base = TEngine.create(C, backend="sharded", mesh=m4, device="cpu")
    base, _ = base.add_vertices(t(np.arange(96, dtype=np.int32)))
    for name, (tpol, jpol) in policies.items():
        for sb in (1, 4):
            te = TEngine.create(C, backend="sharded", mesh=m4, policy=tpol,
                                subbatches=sb)
            te = TEngine(base.state, te.depth_ema, te.cache, te.config)
            ref = jax.jit(lambda st, us, vs, ema, sb=sb, name=name,
                          jpol=jpol: jacy.acyclic_add_edges_impl(
                st, us, vs, subbatches=sb, method=name, with_stats=True,
                n_shards=4, prefer_partial_fn=None if name == "partial"
                else lambda a, b: jpol.prefer_partial(a, b, depth_hint=ema)))
            ema = jnp.asarray(np.zeros(4, np.float32))
            rng = np.random.default_rng(sb)
            for i in range(4):
                us = rng.integers(0, 96, 32).astype(np.int32)
                vs = rng.integers(0, 96, 32).astype(np.int32)
                st = jdag.DagState(*(jnp.asarray(x) for x in (
                    te.state.keys.numpy(), te.state.alive.numpy(),
                    te.state.adj.numpy().view(np.uint32),
                    te.state.n_overflow.numpy())))
                js, jok, jst = ref(st, jnp.asarray(us), jnp.asarray(vs), ema)
                te, tr = te.add_edges_acyclic(t(us), t(vs))
                at = f"{name} subbatches={sb}, call {i}"
                np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jok),
                                              err_msg=at)
                same_bits(te.state.adj, js.adj, at)
                assert tr.stats.n_partial == int(jst["n_partial"]), at
                np.testing.assert_array_equal(
                    tr.stats.deciding_depth.numpy(),
                    np.asarray(jst["deciding_depth"]), err_msg=at)
                ema = _ema_fold(jpol, ema, jst["deciding_depth"])
                np.testing.assert_allclose(te.depth_ema.numpy(),
                                           np.asarray(ema), rtol=0,
                                           atol=EMA_ATOL, err_msg=at)
            assert int(te.state.adj.ne(0).sum()) > 0


# ------------------------------------------- growth, options and errors

def _leaves_equal(a, b, what):
    la, lb = interop.engine_to_arrays(a), interop.engine_to_arrays(b)
    assert la.keys() == lb.keys(), what
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=f"{what}: {k}")


def test_mesh_grow_options_and_errors():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsh.make_dag_mesh()
    with pytest.raises(ValueError, match="repeats one device"):
        tsh.make_dag_mesh(["cpu", "cpu"], n_shards=2)
    m8 = tsh.make_dag_mesh(["cpu"] * 8)
    assert m8.n_devices == 8 and m8 == mesh(8)
    with pytest.raises(ValueError, match="nearest valid capacity is 256"):
        TEngine.create(192, backend="sharded", mesh=m8)
    with pytest.raises(ValueError, match="multiple of 128"):
        TEngine.create(96, backend="sharded", mesh=mesh(4))
    with pytest.raises(ValueError, match="mesh's first device"):
        TEngine.create(C, backend="sharded", mesh=mesh(4), device="meta")
    # the reference's sharded grow script, on 8 CPU shards, and each step
    # against the local engine
    us, vs = t([0, 1, 2, 5]), t([1, 2, 3, 9])
    engines = {}
    for backend, m in (("sharded", m8), ("local", None)):
        eng = TEngine.create(C, backend=backend, mesh=m, device="cpu",
                             method="incremental")
        if backend == "sharded":
            with pytest.raises(ValueError,
                               match="nearest valid capacity is 512"):
                eng.grow(384)
        eng, _ = eng.add_vertices(t(np.arange(30, dtype=np.int32)))
        eng, r = eng.add_edges_acyclic(us, vs)
        assert bool(torch.all(r.ok))
        grown = eng.grow(512)
        fresh = TEngine.create(512, backend=backend, mesh=m, device="cpu",
                               method="incremental")
        fresh, _ = fresh.add_vertices(t(np.arange(30, dtype=np.int32)))
        fresh, _ = fresh.add_edges_acyclic(us, vs)
        g2, rg = grown.add_edges_acyclic(t([9, 3]), t([12, 0]))
        f2, rf = fresh.add_edges_acyclic(t([9, 3]), t([12, 0]))
        assert torch.equal(rg.ok, rf.ok) and not bool(rg.ok[1])
        _leaves_equal(g2, f2, f"{backend}: grown vs fresh")
        assert tcc.cache_matches_state(g2.cache, g2.state.adj)
        engines[backend] = g2
    for k, v in interop.engine_to_arrays(engines["sharded"]).items():
        if k != "depth_ema":
            np.testing.assert_array_equal(
                v, interop.engine_to_arrays(engines["local"])[k], err_msg=k)
    # auto_grow, eager (grow and re-run) and inside as_compiled (report
    # and drop), a tiled window widened on the 32 x D grid, layouts and
    # snapshots, each against the local engine
    keys = t(np.arange(300, dtype=np.int32))
    for backend, m in (("sharded", mesh(4)), ("local", None)):
        kw = dict(backend=backend, mesh=m, device="cpu", auto_grow=True)
        eng, r = TEngine.create(C, **kw).add_vertices(keys)
        assert eng.capacity == 512 and bool(torch.all(r.ok))
        with as_compiled():
            small, r = TEngine.create(C, **kw).add_vertices(keys)
        assert small.capacity == C and int(r.n_overflow) == 44
        engines[backend] = (eng, small)
    for a, b in zip(engines["sharded"], engines["local"]):
        assert a.capacity == b.capacity
        assert torch.equal(a.state.adj, b.state.adj)
    for backend, m in (("sharded", mesh(4)), ("local", None)):
        eng = TEngine.create(512, backend=backend, mesh=m, device="cpu",
                             closure_layout="tiled", closure_region=32,
                             method="incremental")
        if backend == "sharded":
            assert eng.closure_region == 128
        eng, _ = eng.add_vertices(t(np.arange(200, dtype=np.int32)))
        eng, _ = eng.add_edges_acyclic(t(np.arange(0, 190, 5)),
                                       t(np.arange(3, 193, 5)))
        if backend == "sharded":
            assert eng.closure_region % 128 == 0
        dense = eng.with_closure_layout("dense")
        back = dense.with_closure_layout("tiled")
        snap = back.snapshot()
        engines[backend] = (eng.cache.closure, dense.cache.closure, snap,
                            back)
    sh, lo = engines["sharded"], engines["local"]
    assert torch.equal(tcc.dense_of(sh[0]), tcc.dense_of(lo[0]))
    assert torch.equal(sh[1], lo[1])
    f, g = t(np.arange(0, 200, 7)), t(np.arange(199, 0, -7))
    assert torch.equal(sh[2].reachable(f, g), lo[2].reachable(f, g))
    assert torch.equal(sh[3].reachable(f, g), lo[3].reachable(f, g))
    assert sh[3].closure_region % 128 == 0


# ------------------------------------------------ replicas, checkpoints

def _writer_stream(p, seed=0, n=14):
    """`tests/test_replica.py`'s sharded-replica stream, on a writer."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        kind = i % 4
        if kind == 0:
            p.add_vertices(t(rng.integers(0, 64, 8)))
        elif kind == 1:
            p.add_edges_acyclic(t(rng.integers(0, 64, 8)),
                                t(rng.integers(0, 64, 8)))
        elif kind == 2:
            p.remove_edges(t(rng.integers(0, 64, 4)),
                           t(rng.integers(0, 64, 4)))
        else:
            p.remove_vertices(t(rng.integers(0, 64, 3)))
    return p


def test_shard_replica_replays_the_writers_log():
    m4 = mesh(4)
    for layout in ("dense", "tiled"):
        kw = dict(method="incremental", closure_layout=layout, device="cpu")
        local = _writer_stream(trep.Primary.create(C, **kw))
        sharded = _writer_stream(trep.Primary.create(
            C, backend="sharded", mesh=m4, **kw))
        assert len(local.log) == len(sharded.log) > 0
        for a, b in zip(local.log, sharded.log):
            assert interop.log_entry_to_arrays(a).keys() \
                == interop.log_entry_to_arrays(b).keys()
            assert (a.epoch, a.grow_to, a.prev_epoch, a.crc) \
                == (b.epoch, b.grow_to, b.prev_epoch, b.crc), layout
        rep = tsh.shard_replica(m4, trep.Replica.from_engine(
            TEngine.create(C, **kw)))
        assert rep.update_impl is not None and rep.delete_impl is not None
        rep = rep.replay(sharded.log)
        assert rep.converged_with(local.engine), layout
        assert rep.converged_with(sharded.engine), layout
        assert rep.epoch == local.epoch
        views = tsh.replicate_snapshot(m4, sharded.engine.snapshot())
        assert len(views) == 4
        rng = np.random.default_rng(5)
        f, g = t(rng.integers(0, 64, 32)), t(rng.integers(0, 64, 32))
        want = local.engine.reachable(f, g)
        for v in views:
            hit, stats = v.reachable(f, g, with_stats=True)
            assert torch.equal(hit, want) and stats.row_products == 0
        assert torch.equal(sharded.engine.reachable(f, g), want)


def test_checkpoint_restores_across_backends(tmp_path):
    m4 = mesh(4)
    stream = _stream(7, n_calls=6)
    local = TEngine.create(C, method="incremental", device="cpu")
    for xs in stream[:4]:
        local, _ = local.apply(TBatch(*map(t, xs)))
    tckpt.save_engine_checkpoint(str(tmp_path / "local"), 4, local)
    like = TEngine.create(C, backend="sharded", mesh=m4,
                          method="incremental")
    onto = tckpt.restore_engine_checkpoint(str(tmp_path / "local"), like)
    assert onto.config.backend == "sharded" and onto.config.mesh == m4
    _leaves_equal(onto, local, "local checkpoint on the mesh")
    # it serves on as the local engine does
    for xs in stream[4:]:
        local, rl = local.apply(TBatch(*map(t, xs)))
        onto, rs = onto.apply(TBatch(*map(t, xs)))
        assert torch.equal(rl.ok, rs.ok)
    tckpt.save_engine_checkpoint(str(tmp_path / "sharded"), 6, onto)
    tckpt.save_engine_checkpoint(str(tmp_path / "again"), 6, local)
    back = tckpt.restore_engine_checkpoint(
        str(tmp_path / "sharded"),
        TEngine.create(C, method="incremental", device="cpu"))
    assert back.config.backend == "local"
    for k, v in interop.engine_to_arrays(onto).items():
        if k != "depth_ema":
            np.testing.assert_array_equal(
                v, interop.engine_to_arrays(local)[k], err_msg=k)
    _leaves_equal(back, onto, "the mesh's checkpoint restored locally")
    # restored grown forward (C -> 2C) and across layouts onto the mesh
    for layout in ("dense", "tiled"):
        big = TEngine.create(2 * C, backend="sharded", mesh=m4,
                             method="incremental", closure_layout=layout)
        got = tckpt.restore_engine_checkpoint(str(tmp_path / "local"), big)
        want = TEngine.create(2 * C, method="incremental", device="cpu",
                              closure_layout=layout)
        want = tckpt.restore_engine_checkpoint(str(tmp_path / "local"), want)
        assert got.capacity == 2 * C and got.config.mesh == m4
        _leaves_equal(got, want, f"grown onto the mesh, {layout}")
