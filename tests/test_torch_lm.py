"""The port's dense LM (`repro_torch.models.transformer`) against the
reference (`repro.models.transformer`), on the CPU.

At the reference's smoke width (`configs.lm_common.smoke_cfg` of
qwen2-1.5b: 2 layers, d_model 64, 4 query heads over 2 KV heads, d_ff
128, vocab 512) both packages take the same params (the reference's,
carried over by `interop.lm_params_from_arrays`) and the same prompt
(numpy, seed 0), run `prefill` and 8 greedy `decode_step`s, and must
give:
  * float32: last-token logits and the KV cache within 1e-4 absolute (the
    same float32 arithmetic summed in other orders), and identical greedy
    tokens;
  * bfloat16: logits within 5e-2 absolute; bf16 rounds at other places in
    the two frameworks, so tokens are not compared.
`forward` over the prompt (every position's logits and the cache) is
held against the reference's the same way in float32.
Also: RMSNorm, RoPE and SwiGLU against the reference, the params' interop
round trip (bfloat16 bit for bit), the full-width qwen2-1.5b param tree
on the meta device against `jax.eval_shape` of the reference's (nothing
allocated, nothing compiled), and `serve_lm` at smoke width on the CPU.

The reference is jitted once per function and type in module fixtures,
with numpy inputs; its outputs are cast and its greedy argmax taken with
numpy.  7 XLA compilations in all.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import qwen2_1_5b as jqwen  # noqa: E402
from repro.configs.lm_common import smoke_cfg as jsmoke  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import qwen2_1_5b as tqwen  # noqa: E402
from repro_torch.configs.lm_common import smoke_cfg as tsmoke  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

B, PROMPT, STEPS = 2, 16, 8
ATOL_F32, ATOL_BF16 = 1e-4, 5e-2
# the leaves that init_params makes in cfg.dtype (the norms are float32)
CFG_DTYPE_LEAVES = ("embed", "unembed", "wq", "wk", "wv", "wo", "bq", "bk",
                    "bv", "w_gate", "w_up", "w_down")


def prompt():
    vocab = tsmoke(tqwen.CFG).vocab
    return np.random.default_rng(0).integers(
        0, vocab, (B, PROMPT)).astype(np.int32)


def tree_map(fn, params):
    out = {k: fn(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: fn(k, v) for k, v in params["layers"].items()}
    return out


def run_reference(cfg, params, tokens):
    """The reference's prefill and ``STEPS`` greedy decode steps, each
    function jitted once; -> (prefill logits, prefill cache, per-step
    logits, tokens (B, STEPS + 1), final cache) as numpy."""
    max_len = PROMPT + STEPS + 1
    prefill = jax.jit(lambda p, t: JT.prefill(cfg, p, t, max_len=max_len))
    decode = jax.jit(lambda p, c, t, pos: JT.decode_step(cfg, p, c, t, pos))
    logits, cache = prefill(params, tokens)
    first = np.asarray(logits).astype(np.float32)
    first_cache = {k: np.asarray(v).astype(np.float32)
                   for k, v in cache.items()}
    cur = np.argmax(first, -1).astype(np.int32)
    toks, steps = [cur], []
    for i in range(STEPS):
        logits, cache = decode(params, cache, cur, np.int32(PROMPT + i))
        steps.append(np.asarray(logits).astype(np.float32))
        cur = np.argmax(steps[-1], -1).astype(np.int32)
        toks.append(cur)
    return (first, first_cache, steps, np.stack(toks, 1),
            {k: np.asarray(v).astype(np.float32) for k, v in cache.items()})


def run_port(cfg, arrays, tokens):
    params = interop.lm_params_from_arrays(arrays, device="cpu")
    max_len = PROMPT + STEPS + 1
    logits, cache = TT.prefill(cfg, params, torch.from_numpy(tokens),
                               max_len=max_len)
    first = logits.float().numpy()
    first_cache = {k: v.float().numpy().copy() for k, v in cache.items()}
    cur = torch.argmax(logits, -1).to(torch.int32)
    toks, steps = [cur], []
    for i in range(STEPS):
        logits, cache = TT.decode_step(cfg, params, cache, cur, PROMPT + i)
        steps.append(logits.float().numpy())
        cur = torch.argmax(logits, -1).to(torch.int32)
        toks.append(cur)
    return (first, first_cache, steps, torch.stack(toks, 1).numpy(),
            {k: v.float().numpy() for k, v in cache.items()})


@pytest.fixture(scope="module")
def smoke_params():
    """The reference's float32 smoke params as numpy (one jitted init),
    and the same params cast to bfloat16 where the reference's bf16 init
    makes bfloat16 (it draws in float32 and casts, so the cast of the
    float32 draw is its bf16 init)."""
    cfg = dataclasses.replace(jsmoke(jqwen.CFG), dtype=jnp.float32)
    params = jax.jit(lambda: JT.init_params(cfg, jax.random.key(0)))()
    f32 = tree_map(lambda k, v: np.asarray(v), params)
    bf16 = tree_map(lambda k, v: v.astype(jnp.bfloat16)
                    if k in CFG_DTYPE_LEAVES else v, f32)
    return f32, bf16


@pytest.fixture(scope="module")
def smoke_runs(smoke_params):
    f32, bf16 = smoke_params
    tokens = prompt()
    out = {}
    for name, arrays, jdtype, tdtype in (
            ("f32", f32, jnp.float32, torch.float32),
            ("bf16", bf16, jnp.bfloat16, torch.bfloat16)):
        jcfg = dataclasses.replace(jsmoke(jqwen.CFG), dtype=jdtype)
        tcfg = dataclasses.replace(tsmoke(tqwen.CFG), dtype=tdtype)
        out[name] = (run_reference(jcfg, arrays, tokens),
                     run_port(tcfg, arrays, tokens))
    return out


def test_prefill_and_greedy_decode_match_reference_f32(smoke_runs):
    want, got = smoke_runs["f32"]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL_F32)
    for k in ("k", "v"):
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=0,
                                   atol=ATOL_F32, err_msg=f"prefill {k}")
        np.testing.assert_allclose(got[4][k], want[4][k], rtol=0,
                                   atol=ATOL_F32, err_msg=f"final {k}")
    for i, (g, w) in enumerate(zip(got[2], want[2])):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL_F32,
                                   err_msg=f"decode step {i}")
    np.testing.assert_array_equal(got[3], want[3])


def test_forward_matches_reference_f32(smoke_params):
    """`forward` over the prompt: every position's logits, the cache and
    aux (0 for the dense FFN) within 1e-4 of the reference's; without
    ``return_cache``, the same logits."""
    f32, _ = smoke_params
    tokens = prompt()
    jcfg = dataclasses.replace(jsmoke(jqwen.CFG), dtype=jnp.float32)
    want = jax.jit(lambda p, t: JT.forward(jcfg, p, t, return_cache=True))(
        f32, tokens)
    tcfg = dataclasses.replace(tsmoke(tqwen.CFG), dtype=torch.float32)
    params = interop.lm_params_from_arrays(f32, device="cpu")
    logits, cache, aux = TT.forward(tcfg, params, torch.from_numpy(tokens),
                                    return_cache=True)
    assert logits.shape == (B, PROMPT, tcfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want[0]), rtol=0,
                               atol=ATOL_F32)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(want[1][k]),
                                   rtol=0, atol=ATOL_F32, err_msg=k)
    assert float(aux) == float(want[2]) == 0.0
    alone, _ = TT.forward(tcfg, params, torch.from_numpy(tokens))
    assert torch.equal(alone, logits)


def test_prefill_and_decode_match_reference_bf16(smoke_runs):
    """Prefill logits and cache within 5e-2; then every decode step's
    logits as long as both sides were fed the same tokens (from the
    first step on which their greedy tokens differ, the inputs differ)."""
    want, got = smoke_runs["bf16"]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL_BF16)
    vocab = tsmoke(tqwen.CFG).vocab
    assert np.all(got[0][:, vocab:] == np.float32(-1e30))  # padded vocab
    for k in ("k", "v"):
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=0,
                                   atol=ATOL_BF16, err_msg=k)
    fed_alike = np.cumprod(np.all(got[3] == want[3], axis=0))[:STEPS]
    for i in np.flatnonzero(fed_alike):
        np.testing.assert_allclose(got[2][i], want[2][i], rtol=0,
                                   atol=ATOL_BF16, err_msg=f"step {i}")


def test_norm_rope_swiglu_match_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    xr = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 2080, (2, 5)).astype(np.int32)  # the main path's
    wg, wu = (rng.standard_normal((64, 128)).astype(np.float32) / 8
              for _ in range(2))
    wd = rng.standard_normal((128, 64)).astype(np.float32) / 11

    want = jax.jit(lambda x, w, xr, pos, wg, wu, wd: (
        jcommon.rms_norm(x, w), jcommon.apply_rope(xr, pos, 1e6),
        jcommon.swiglu(x, wg, wu, wd)))(x, w, xr, pos, wg, wu, wd)
    t = torch.from_numpy
    got = (tcommon.rms_norm(t(x), t(w)),
           tcommon.apply_rope(t(xr), t(pos), 1e6),
           tcommon.swiglu(t(x), t(wg), t(wu), t(wd)))
    for name, g, wnt in zip(("rms_norm", "apply_rope", "swiglu"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_lm_params_interop_round_trip_is_bit_exact(smoke_params):
    _, bf16 = smoke_params
    params = interop.lm_params_from_arrays(bf16, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert params["layers"]["ln1"].dtype == torch.float32
    back = interop.lm_params_to_arrays(params, jnp.bfloat16)
    for leaves, b in ((bf16, back), (bf16["layers"], back["layers"])):
        for k, v in leaves.items():
            if k == "layers":
                continue
            assert b[k].dtype == v.dtype, k
            np.testing.assert_array_equal(
                b[k].view(np.uint16) if v.dtype.name == "bfloat16" else b[k],
                v.view(np.uint16) if v.dtype.name == "bfloat16" else v,
                err_msg=k)


def test_full_width_param_tree_matches_reference_on_meta():
    """qwen2-1.5b at full width: the port's param tree on the meta device
    has the reference's leaf shapes, and its element count is
    param_count() plus the vocab padding of embed and unembed."""
    want = jax.eval_shape(lambda: JT.init_params(jqwen.CFG,
                                                 jax.random.key(0)))
    cfg = tqwen.CFG
    got = TT.init_params(cfg, device=torch.device("meta"))
    assert got["embed"].device.type == "meta"
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    n = 0
    for k in ("embed", "unembed", "final_norm"):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        n += got[k].numel()
    for k, leaf in got["layers"].items():
        assert tuple(leaf.shape) == tuple(want["layers"][k].shape), k
        assert (leaf.dtype == torch.float32) == (
            want["layers"][k].dtype == jnp.float32), k
        n += leaf.numel()
    assert cfg.param_count() == jqwen.CFG.param_count()
    assert n == cfg.param_count() + 2 * (cfg.padded_vocab - cfg.vocab) \
        * cfg.d_model
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
            cfg.d_ff, cfg.padded_vocab) == (28, 1536, 12, 2, 128, 8960,
                                            152064)


def test_serve_lm_at_smoke_width_on_cpu():
    out = tserve.serve_lm(batch=2, prompt_len=12, gen=4, width="smoke",
                          device="cpu")
    assert out["tok_per_s"] > 0
    assert out["tokens"].shape == (2, 4)
    assert int(out["tokens"].max()) < out["cfg"].vocab
    assert torch.isfinite(out["prefill_logits"][:, :512]).all()
    assert out["cache"]["k"].shape == (2, 2, 16, 2, 16)
    with pytest.raises(ValueError, match="width"):
        tserve.serve_lm(width="wide", device="cpu")


def test_unported_lm_options_raise_naming_the_roadmap():
    cfg = tsmoke(tqwen.CFG)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.init_params(dataclasses.replace(cfg, full_sp=True),
                       device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.forward(dataclasses.replace(cfg, moe=object()), {},
                   torch.zeros((1, 2), dtype=torch.int64))
