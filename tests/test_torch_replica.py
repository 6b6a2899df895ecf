"""The port's replication and durability (`repro_torch.replica`,
`repro_torch.ft.checkpoint`) against the reference's (`repro.replica`,
`repro.ft.checkpoint`), on the CPU.

One seeded mixed stream (vertex adds, acyclic edge adds that include
cycle attempts, edge and vertex removals, one grow) drives both writers,
dense and tiled, C=64:
  * the port's eager `Primary` and its ``defer_flush`` + ``jit`` one write
    the reference's log entry for entry: epoch, grow_to, prev_epoch, crc
    and every delta array with its dtype.  The eager port is held against
    the reference's ``jit=True`` writer without ``defer_flush`` (the same
    entries, one a call): the reference's eager writer compiles ~300 XLA
    programs op by op at this size, past what one test worker survives;
  * `save_delta_log` files are byte-identical, and each package loads the
    other's file and replays it to the same adjacency and closure;
  * engine checkpoints: equal leaves give byte-identical ``arrays.npz``
    files and equal manifests, and each package restores the other's at
    the same capacity, grown forward and across layouts;
  * `Replica.converged_with` says False on one differing closure bit,
    inside the common window or past the narrower one, and its window to
    window comparison agrees with comparing the dense closures on seeded
    dense / tiled pairs of any windows;
  * `CheckpointManager` (async, keep-last-2) keeps the same steps as the
    reference's and writes the same ``arrays.npz`` bytes;
  * the log's integrity errors (torn tail, mid-file corruption, bad
    magic, unsupported version, legacy v1, epoch gap, duplicate
    redelivery, missed grow) carry the reference's types, messages and
    byte offsets.
Every reference stream is jitted and run once, in a module-scoped fixture.
"""
import io
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import replica as jrep  # noqa: E402
from repro.core import closure_cache as jcc  # noqa: E402
from repro.core.engine import DagEngine as JEngine  # noqa: E402
from repro.ft import checkpoint as jckpt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import replica as trep  # noqa: E402
from repro_torch.core import bitset as tbitset  # noqa: E402
from repro_torch.core import closure_cache as tcc  # noqa: E402
from repro_torch.core.engine import DagEngine as TEngine  # noqa: E402
from repro_torch.ft import checkpoint as tckpt  # noqa: E402

C, B, ROUNDS = 64, 8, 6
LAYOUTS = ("dense", "tiled")
HOT = {"defer_flush": True, "jit": True}


@pytest.fixture(scope="module", autouse=True)
def _fresh_xla_caches():
    # the executables cached before and during this module hold memory
    # maps; free them so this worker stays far from the kernel's limit
    jax.clear_caches()
    yield
    jax.clear_caches()


def stream(seed=0):
    """Rounds in the front-end's phase order (vertex removals, vertex
    adds, edge removals, edge adds), so a deferred writer ships one
    coalesced entry a round."""
    rng = np.random.default_rng(seed)
    out = []
    prev_lo = prev_hi = np.zeros(B, np.int32)
    for r in range(ROUNDS):
        if r == ROUNDS // 2:
            out.append(("grow", 2 * C))
        lo = rng.integers(0, 40, B).astype(np.int32)
        hi = (lo + rng.integers(1, 8, B)).astype(np.int32)
        out.append(("remove_vertices",
                    rng.integers(0, 48, 2).astype(np.int32)))
        out.append(("add_vertices", rng.integers(0, 48, B).astype(np.int32)))
        out.append(("remove_edges", prev_lo[:B // 2], prev_hi[:B // 2]))
        out.append(("add_edges_acyclic", lo, hi))
        out.append(("add_edges_acyclic", hi, lo))  # cycle attempts
        prev_lo, prev_hi = lo, hi
    return out


def drive(p, conv):
    for op, *args in stream():
        if op == "grow":
            p.grow(args[0])
        else:
            getattr(p, op)(*[conv(a) for a in args])
    p.flush()
    return p


def port_primary(layout, **opts):
    return drive(trep.Primary.create(C, method="incremental",
                                     closure_layout=layout, device="cpu",
                                     **opts), torch.from_numpy)


@pytest.fixture(scope="module")
def ref():
    """The reference's writers, jitted: {(layout, deferred): Primary}."""
    return {(layout, deferred): drive(
        jrep.Primary.create(C, method="incremental", closure_layout=layout,
                            jit=True, defer_flush=deferred), jnp.asarray)
        for layout in LAYOUTS for deferred in (False, True)}


def same_log(tlog, jlog):
    assert len(tlog) == len(jlog)
    for te, je in zip(tlog, jlog):
        assert (te.epoch, te.grow_to, te.prev_epoch, te.crc) == \
            (int(je.epoch), int(je.grow_to), int(je.prev_epoch), int(je.crc))
        for name, x, y in zip(tcc.CacheDelta._fields, te.delta, je.delta):
            y = np.asarray(y)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def same_replica(trp, jrp):
    """Identical epoch, adjacency and closure bits (any layouts)."""
    assert trp.epoch == int(jrp.epoch)
    np.testing.assert_array_equal(trp.adj.numpy().view(np.uint32),
                                  np.asarray(jrp.adj))
    np.testing.assert_array_equal(
        tcc.dense_of(trp.closure).numpy().view(np.uint32),
        np.asarray(jcc.dense_of(jrp.closure)))


def ref_arrays(je):
    """A reference engine's leaves, named as `interop.LEAVES`."""
    leaves = jax.tree_util.tree_leaves(je)
    names = interop.TILED_LEAVES if jcc.is_tiled(je.cache.closure) \
        else interop.LEAVES
    return {n: np.asarray(x) for n, x in zip(names, leaves)}


def flipped(closure, i, j):
    """A copy of ``closure`` with bit (i, j) flipped; a tiled closure's
    window is widened first to hold it."""
    if tcc.is_tiled(closure):
        closure = tcc.grow_region(closure, max(i, j) + 1)
        tiles = closure.tiles.clone()
        tiles[i, j // 32] ^= 1 << (j % 32)
        return tcc.TiledClosure(tiles, closure.summary)
    out = closure.clone()
    out[i, j // 32] ^= 1 << (j % 32)
    return out


def bits_differ_check(seed=0, cap=256, trials=64):
    """`_same_bits` against `torch.equal` of the dense closures, on seeded
    pairs: dense or tiled, windows of 32..cap, equal bits or one bit apart
    anywhere in the wider window.  Returns how many pairs differed and
    how many of those differed past the narrower window."""
    rng = np.random.default_rng(seed)
    regions = (32, 64, 128, cap)
    n_diff = n_past = 0
    for t in range(trials):
        ra, rb = rng.choice(regions, 2)
        lo, hi = min(ra, rb), max(ra, rb)
        bits = np.zeros((cap, cap), bool)
        bits[:lo, :lo] = rng.random((lo, lo)) < 0.05
        other = bits.copy()
        if t % 2:
            i, j = rng.integers(0, hi, 2)
            other[i, j] ^= True
            n_diff += 1
            n_past += bool(max(i, j) >= lo)
        x, y = (tbitset.pack_bits(torch.from_numpy(b))
                for b in (bits, other))
        a = tcc.tiled_of(x, lo) if rng.random() < 0.75 else x
        b = tcc.tiled_of(y, hi) if rng.random() < 0.75 else y
        if rng.random() < 0.5:
            a, b = b, a
        want = torch.equal(tcc.dense_of(a), tcc.dense_of(b))
        assert want == (t % 2 == 0)
        assert trep._same_bits(a, b) == want, t
    # closures of two capacities hold different bits, as dense_of says
    small = tcc.tiled_of(torch.zeros((cap, cap // 32), dtype=torch.int32),
                         32)
    assert not trep._same_bits(small, tcc.grow_closure(small, 2 * cap))
    return n_diff, n_past


def test_writer_log_matches_reference(ref):
    for layout in LAYOUTS:
        eager = port_primary(layout)
        hot = port_primary(layout, **HOT)
        same_log(eager.log, ref[layout, False].log)
        same_log(hot.log, ref[layout, True].log)
        assert len(hot.log) < len(eager.log)  # coalesced: one entry a round
        for p in (eager, hot):
            assert p.epoch == int(ref[layout, True].epoch)
            rep = trep.Replica.from_engine(
                TEngine.create(C, method="incremental",
                               closure_layout=layout, device="cpu"))
            assert rep.replay(p.log).converged_with(p.engine)
        # one planted bit, inside the common window or past the
        # engine's, makes the replica diverge
        eng = hot.engine.grow(4 * C)
        good = trep.Replica.from_engine(eng)
        assert good.converged_with(eng)
        spots = [(3, 5), (11, 4 * C - 2)]
        if layout == "tiled":
            # a wider replica window holding no bit past the engine's
            # converges; a bit past the engine's window does not
            region = eng.cache.closure.region
            assert region < 4 * C
            wide = trep.Replica(good.epoch, good.adj,
                                tcc.grow_region(good.closure, 4 * C))
            assert wide.converged_with(eng)
            spots.append((region + 9, 7))
        for i, j in spots:
            bad = trep.Replica(good.epoch, good.adj,
                               flipped(good.closure, i, j))
            assert not bad.converged_with(eng), (layout, i, j)
        # interop round trip of every entry, both ways
        for te, je in zip(hot.log, ref[layout, True].log):
            back = interop.log_entry_from_arrays(
                interop.log_entry_to_arrays(je))
            same_log([back], [je])
            assert interop.log_entry_to_arrays(te)["crc"] == te.crc
    n_diff, n_past = bits_differ_check()
    assert n_diff and n_past


def test_log_files_byte_identical_and_cross_replay(ref, tmp_path):
    hot = port_primary("dense", **HOT)
    jlog = ref["dense", True].log
    tpath = trep.save_delta_log(str(tmp_path / "port.log"), hot.log)
    jpath = jrep.save_delta_log(str(tmp_path / "ref.log"), jlog)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    # the port replays the reference's file ...
    t_rep = trep.Replica.from_engine(
        TEngine.create(C, method="incremental", device="cpu"))
    t_rep = t_rep.replay(trep.load_delta_log(jpath))
    assert t_rep.converged_with(hot.engine)
    # ... and the reference the port's, through its compiled apply
    from repro.serve.frontend import _advance_replica
    j_rep = jrep.Replica(jnp.asarray(0, jnp.int32),
                         jnp.zeros((C, C // 32), jnp.uint32),
                         jnp.zeros((C, C // 32), jnp.uint32))
    j_rep = _advance_replica(j_rep, jrep.load_delta_log(tpath))
    same_replica(t_rep, j_rep)
    # recovery from the reference's base image (a fresh engine at C,
    # grown forward into 2C) and its log file
    jckpt.save_engine_checkpoint(str(tmp_path / "ckpt"), 0,
                                 JEngine.create(C, method="incremental"))
    rec = trep.recover_replica(
        str(tmp_path / "ckpt"),
        TEngine.create(2 * C, method="incremental", device="cpu"),
        trep.load_delta_log(jpath))
    assert rec.converged_with(hot.engine)


def test_engine_checkpoints_cross_restore(ref, tmp_path):
    ports = {}
    for layout in LAYOUTS:
        je = ref[layout, True].engine
        arrays = ref_arrays(je)
        te = ports[layout] = interop.engine_from_arrays(
            arrays, {"method": "incremental"}, device="cpu")
        jdir, tdir = str(tmp_path / f"j_{layout}"), str(tmp_path / layout)
        jckpt.save_engine_checkpoint(jdir, 7, je)
        tckpt.save_engine_checkpoint(tdir, 7, te)
        jfile, tfile = (os.path.join(d, "step_00000007", f)
                        for d, f in ((jdir, "arrays.npz"),
                                     (tdir, "arrays.npz")))
        assert open(jfile, "rb").read() == open(tfile, "rb").read()
        jman, tman = (tckpt._engine_manifest(d, 7) for d in (jdir, tdir))
        for key in ("step", "n_leaves", "dtypes", "shapes", "crc32"):
            assert jman[key] == tman[key], key
        # the port restores the reference's image: same capacity, grown
        # forward, and into the other layout; the reference the port's
        for like_layout in LAYOUTS:
            for cap in (2 * C, 4 * C):
                like = TEngine.create(cap, method="incremental",
                                      closure_layout=like_layout,
                                      device="cpu")
                got = tckpt.restore_engine_checkpoint(jdir, like)
                assert got.capacity == cap and got.epoch == te.epoch
                assert tcc.is_tiled(got.cache.closure) == \
                    (like_layout == "tiled")
                assert trep.Replica.from_engine(got).converged_with(
                    te.grow(cap).with_closure_layout(like_layout))
        back = jckpt.restore_engine_checkpoint(
            tdir, JEngine.create(2 * C, method="incremental",
                                 closure_layout=layout))
        for name, a in ref_arrays(back).items():
            np.testing.assert_array_equal(a, arrays[name], err_msg=name)
    # CheckpointManager, async, keeping 2 of 4 steps whose layouts
    # alternate: the same surviving steps, byte for byte
    jdir, tdir = str(tmp_path / "j_mgr"), str(tmp_path / "mgr")
    jmgr = jckpt.CheckpointManager(jdir, keep=2)
    tmgr = tckpt.CheckpointManager(tdir, keep=2)
    for step in range(1, 5):
        layout = LAYOUTS[step % 2]
        jmgr.save(step, ref[layout, True].engine)
        tmgr.save(step, ports[layout])
    jmgr.finalize()
    tmgr.finalize()
    assert tckpt.all_steps(tdir) == jckpt.all_steps(jdir) == [3, 4]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for step in (3, 4):
        jfile, tfile = (os.path.join(d, f"step_{step:08d}", "arrays.npz")
                        for d in (jdir, tdir))
        assert open(jfile, "rb").read() == open(tfile, "rb").read()
        jman, tman = (tckpt._engine_manifest(d, step) for d in (jdir, tdir))
        for key in ("step", "n_leaves", "dtypes", "shapes", "crc32"):
            assert jman[key] == tman[key], (step, key)
    # a generic tree (dict of tensors) round-trips with dtypes restored
    tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "n": torch.tensor(3, dtype=torch.int32)}
    tckpt.save_checkpoint(str(tmp_path / "tree"), 1, tree)
    got = tckpt.restore_checkpoint(str(tmp_path / "tree"), tree)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"],
                                                             tree["w"])


def _raised(fn):
    try:
        fn()
    except Exception as err:  # noqa: BLE001 — the type is compared
        return type(err).__name__, str(err), getattr(err, "offset", None)
    return None


def test_log_errors_match_reference(ref, tmp_path):
    hot = port_primary("dense", **HOT)
    good = open(trep.save_delta_log(str(tmp_path / "g.log"), hot.log),
                "rb").read()
    rec = struct.Struct("<II")
    first_len = rec.unpack_from(good, 16)[0]
    second = 16 + rec.size + first_len
    torn = good[:-5]
    mid = bytearray(good)
    mid[second - 3] ^= 0x10  # inside entry 0's payload, records follow
    bad_magic = b"NOTADLOG" + good[8:]
    hdr = struct.pack("<8sI", b"NBDAGLOG", 7)
    bad_version = hdr + struct.pack("<I", __import__("zlib").crc32(hdr)) \
        + good[16:]
    buf = io.BytesIO()
    np.savez(buf, n_entries=np.asarray(1),
             e0_meta=np.asarray([1, 0], np.int64),
             **{f"e0_{k}": np.asarray(v) for k, v in
                zip(tcc.CacheDelta._fields, hot.log[0].delta)})
    legacy = buf.getvalue()
    files = {"torn": torn, "mid": bytes(mid), "magic": bad_magic,
             "version": bad_version, "legacy": legacy,
             "legacy_cut": legacy[:40]}
    for name, data in files.items():
        path = str(tmp_path / f"{name}.log")
        with open(path, "wb") as f:
            f.write(data)
        for strict in (False, True):
            got_t = _raised(lambda: trep.load_delta_log(path, strict))
            got_j = _raised(lambda: jrep.load_delta_log(path, strict))
            assert got_t == got_j, (name, strict)
        if _raised(lambda: jrep.load_delta_log(path)) is None:
            same_log(trep.load_delta_log(path), jrep.load_delta_log(path))
    # the replica-side gate: gap, duplicate, missed grow, bad crc
    jlog = ref["dense", True].log
    t_base = trep.Replica.from_engine(
        TEngine.create(C, method="incremental", device="cpu"))
    j_base = jrep.Replica(jnp.asarray(0, jnp.int32),
                          jnp.zeros((C, C // 32), jnp.uint32),
                          jnp.zeros((C, C // 32), jnp.uint32))
    grow_at = next(i for i, e in enumerate(hot.log) if e.grow_to)
    t_mid = t_base.replay(hot.log[:grow_at])
    j_mid = jrep.Replica(jnp.asarray(t_mid.epoch, jnp.int32),
                         jnp.asarray(t_mid.adj.numpy().view(np.uint32)),
                         jnp.asarray(t_mid.closure.numpy().view(np.uint32)))
    flipped = hot.log[1]._replace(epoch=hot.log[1].epoch + 1_000_000)
    # an entry past the grow that addresses slot 100 of the grown slab,
    # shipped without its grow entry
    past = {"epoch": t_mid.epoch + 1, "grow_to": 0,
            "prev_epoch": t_mid.epoch, "crc": 0,
            "delta": interop.delta_to_arrays(tcc.CacheDelta.edges_added(
                torch.tensor([100], dtype=torch.int32),
                torch.tensor([5], dtype=torch.int32),
                torch.tensor([True])))}
    j_past = jrep.LogEntry(past["epoch"], 0, jcc.CacheDelta(
        **past["delta"]), past["prev_epoch"])
    cases = {"gap": (t_base, j_base, hot.log[2], jlog[2]),
             "dup": (t_mid, j_mid, hot.log[0], jlog[0]),
             "crc": (t_base, j_base, flipped,
                     jlog[1]._replace(epoch=jlog[1].epoch + 1_000_000)),
             "missed_grow": (t_mid, j_mid,
                             interop.log_entry_from_arrays(past), j_past)}
    for name, (trp, jrp, te, je) in cases.items():
        got_t = _raised(lambda: trp._admits(te))
        got_j = _raised(lambda: jrp._admits(je))
        assert got_t == got_j, name
        if got_t is None:
            assert trp._admits(te) == bool(jrp._admits(je))
    assert t_mid.apply(hot.log[0]) is t_mid  # a duplicate skips
