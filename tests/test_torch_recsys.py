"""The port's recsys stack (`repro_torch.models.recsys`, xDeepFM) against
the reference (`repro.models.recsys`), on the CPU.

At the reduced config of `tests/test_recsys.py` (`small_cfg`: 6 fields,
embed 8, CIN 16-16, MLP 32-32, 128 items) both packages take the same
params (the reference's, carried over by
`interop.xdeepfm_params_from_arrays`) and the same ids (numpy, seeded):
`forward`, `loss` and `retrieval_score` agree within 1e-5 absolute in
float32 (the same float32 arithmetic summed in other orders; the logits
are ~0.1).  The port's linear term is an embedding bag (kernel B6's
plain version here) and equals the reference's lookup-sum within that
tolerance, and its own lookup-sum within 1e-7 (sum order only).  Also:
`lookup` (exactly) and `embedding_bag` against the reference's; the
vocabularies, offsets and row count of the full-width config; the params'
interop round trip, bit for bit; the full-width param tree on the meta
device against `jax.eval_shape` of the reference's (nothing allocated,
nothing compiled); the smoke run on the CPU.

The reference is jitted once per function group in module fixtures, with
numpy inputs: 3 XLA compilations in all.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402

from repro.configs import xdeepfm as jconfig  # noqa: E402
from repro.models.recsys import embedding as jemb  # noqa: E402
from repro.models.recsys import xdeepfm as JX  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs import xdeepfm as tconfig  # noqa: E402
from repro_torch.models.recsys import embedding as temb  # noqa: E402
from repro_torch.models.recsys import xdeepfm as TX  # noqa: E402

ATOL = 1e-5
BATCH, N_CAND = 16, 128
SMALL = dict(name="t", n_fields=6, embed_dim=8, cin_layers=(16, 16),
             mlp_dims=(32, 32), vocab_sizes=(16, 32, 8, 64, 16, 8),
             n_items=N_CAND, retrieval_dim=16)   # tests/test_recsys.py


def inputs(cfg):
    """ids (BATCH, F) int32 within each field's vocabulary, 0/1 labels,
    candidates 0..N_CAND-1, as numpy (seed 1, as test_recsys.py)."""
    rng = np.random.default_rng(1)
    ids = np.stack([rng.integers(0, v, BATCH) for v in cfg.vocab_sizes],
                   1).astype(np.int32)
    labels = rng.integers(0, 2, BATCH).astype(np.int32)
    return ids, labels, np.arange(N_CAND, dtype=np.int32)


@pytest.fixture(scope="module")
def small():
    """(reference cfg, port cfg, the reference's params as numpy, its
    forward, loss and retrieval scores on `inputs`): one jitted init and
    one jitted evaluation."""
    jcfg, tcfg = JX.XDeepFMConfig(**SMALL), TX.XDeepFMConfig(**SMALL)
    params = jax.jit(lambda: JX.init_params(jcfg, jax.random.key(0)))()
    arrays = jax.tree.map(np.asarray, params)
    ids, labels, cand = inputs(jcfg)
    want = jax.jit(lambda p, i, y, c: (
        JX.forward(jcfg, p, i), JX.loss(jcfg, p, {"ids": i, "labels": y}),
        JX.retrieval_score(jcfg, p, i[:1], c)))(arrays, ids, labels, cand)
    return jcfg, tcfg, arrays, [np.asarray(x) for x in want]


def port_run(tcfg, arrays):
    params = interop.xdeepfm_params_from_arrays(arrays, device="cpu")
    ids, labels, cand = (torch.from_numpy(x) for x in inputs(tcfg))
    return params, ids, (
        TX.forward(tcfg, params, ids),
        TX.loss(tcfg, params, {"ids": ids, "labels": labels}),
        TX.retrieval_score(tcfg, params, ids[:1], cand))


def test_forward_loss_retrieval_match_reference(small):
    _, tcfg, arrays, want = small
    _, _, got = port_run(tcfg, arrays)
    for name, g, w in zip(("forward", "loss", "retrieval_score"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL,
                                   err_msg=name)
    assert got[0].shape == (BATCH,) and got[2].shape == (N_CAND,)


def test_linear_term_is_the_lookup_sum(small):
    """The bag over the fields (unit weights, D = 1) that `forward` runs
    equals the reference's ``lookup(...)[..., 0].sum(-1)``."""
    jcfg, tcfg, arrays, _ = small
    params, ids, _ = port_run(tcfg, arrays)
    offsets = torch.from_numpy(temb.field_offsets(tcfg.vocab_sizes))
    lin = TX.linear_term(params, ids, offsets)
    assert lin.shape == (BATCH,)
    rows = np.asarray(arrays["linear_table"])[
        ids.numpy() + jemb.field_offsets(jcfg.vocab_sizes)[None, :], 0]
    np.testing.assert_allclose(lin.numpy(), rows.sum(-1), rtol=0, atol=ATOL)
    own = temb.lookup(params["linear_table"], ids, offsets)[..., 0].sum(-1)
    torch.testing.assert_close(lin, own, rtol=0, atol=1e-7)


def test_lookup_and_embedding_bag_match_reference():
    rng = np.random.default_rng(4)
    vocab = (16, 32, 8, 64)
    table = rng.standard_normal((sum(vocab), 8)).astype(np.float32)
    ids = np.stack([rng.integers(0, v, 5) for v in vocab], 1).astype(np.int32)
    idx = rng.integers(0, sum(vocab), (6, 3)).astype(np.int32)
    w = rng.random((6, 3)).astype(np.float32)
    offsets = jemb.field_offsets(vocab)
    want_look, want_bag = jax.jit(lambda t, i, o, x, wt: (
        jemb.lookup(t, i, o), jemb.embedding_bag(t, x, wt)))(
            table, ids, offsets, idx, w)
    t = torch.from_numpy(table)
    got_look = temb.lookup(t, torch.from_numpy(ids),
                           torch.from_numpy(temb.field_offsets(vocab)))
    np.testing.assert_array_equal(got_look.numpy(), np.asarray(want_look))
    got_bag = temb.embedding_bag(t, torch.from_numpy(idx),
                                 torch.from_numpy(w))
    np.testing.assert_allclose(got_bag.numpy(), np.asarray(want_bag),
                               rtol=0, atol=1e-6)


def test_full_width_vocabularies_offsets_and_rows_match_reference():
    for n, total in ((39, 33_000_000), (39, 20_000_000), (6, 1000)):
        assert TX.default_vocab_sizes(n, total) == JX.default_vocab_sizes(
            n, total)
    cfg, jcfg = tconfig.CFG, jconfig.CFG
    assert cfg.vocab_sizes == jcfg.vocab_sizes
    np.testing.assert_array_equal(temb.field_offsets(cfg.vocab_sizes),
                                  jemb.field_offsets(jcfg.vocab_sizes))
    assert temb.field_offsets(cfg.vocab_sizes).dtype == np.int32
    assert temb.total_rows(cfg.vocab_sizes) == jemb.total_rows(
        jcfg.vocab_sizes) == cfg.total_rows() == 33_001_472
    assert tconfig.SHAPES == jconfig.SHAPES
    for shape in tconfig.SHAPES.values():
        assert tconfig._fwd_flops(cfg, shape["batch"]) == jconfig._fwd_flops(
            jcfg, shape["batch"])
    for f in ("n_fields", "embed_dim", "cin_layers", "mlp_dims", "n_items",
              "retrieval_dim"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_xdeepfm_params_interop_round_trip_is_bit_exact(small):
    _, _, arrays, _ = small
    params = interop.xdeepfm_params_from_arrays(arrays, device="cpu")
    assert isinstance(params["dnn"], list)
    assert isinstance(params["dnn"][0], tuple)
    back = interop.xdeepfm_params_to_arrays(params)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(arrays))
    for b, a in zip(jax.tree.leaves(back), jax.tree.leaves(arrays)):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)


def test_full_width_param_tree_matches_reference_on_meta():
    """xDeepFM at full width: the port's param tree on the meta device has
    the reference's structure, leaf shapes and types, with 33,001,472 rows
    in both tables."""
    want = jax.eval_shape(lambda: JX.init_params(jconfig.CFG,
                                                 jax.random.key(0)))
    got = TX.init_params(tconfig.CFG, device=torch.device("meta"))
    assert got["table"].device.type == "meta"
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        assert g.dtype == torch.float32 and w.dtype == np.float32
    assert got["table"].shape == (33_001_472, 10)
    assert got["linear_table"].shape == (33_001_472, 1)
    assert got["item_table"].shape == (1_000_000, 64)


def test_run_smoke_on_cpu_and_the_registry():
    out = registry.run_smoke("xdeepfm", device="cpu")
    assert np.isfinite(out["loss"]) and out["loss"] > 0
    assert registry.ARCHS == {"qwen2-1.5b": "lm", "xdeepfm": "recsys"}
    assert registry.shapes_for("xdeepfm") == ["train_batch", "serve_p99",
                                              "serve_bulk", "retrieval_cand"]
    assert registry.shapes_for("qwen2-1.5b") == [
        "train_4k", "prefill_32k", "decode_32k", "long_500k"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        registry.run_smoke("qwen2-1.5b", device="cpu")
    with pytest.raises(ValueError, match="arch"):
        registry.shapes_for("egnn")
    if not torch.cuda.is_available():   # None means the card: no fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            registry.run_smoke("xdeepfm")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TX.init_params(tconfig.smoke_cfg())
