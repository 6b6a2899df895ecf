"""Kernel B7 of the port (GQA causal flash attention) and the decode
attention: the plain versions against the reference, the dispatcher's
routing, and — on a card only — the CUDA kernel against its plain
version.

On the CPU, `ops.flash_attention` runs its plain version; it is held
against the reference's `kernels.ref.flash_attention_ref` and its
`models.attention.flash_chunked` (the jnp path its LM runs off the TPU)
at three shapes: GQA groups 1 and 3, Tq = Tk and Tq < Tk, and a ragged
T; `decode_attention` against the reference's with a per-row cache
length.  Both compute in float32 from the same float32 inputs (made from
a seed with numpy) and sum in other orders, so they agree within 1e-5.
The reference is jitted once per shape in a module fixture, with numpy
inputs (4 XLA compilations), and imported there: the machine with the
card has no JAX, and ``pytest -m cuda tests/test_torch_attention.py``
runs only the card tests, which compare with the plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

ATOL = 1e-5
# (B, Hq, Hkv, Tq, Tk, d)
SHAPES = {"group1": (2, 2, 2, 32, 32, 16),
          "group3_tq_lt_tk": (1, 6, 2, 24, 40, 32),
          "ragged": (1, 3, 1, 37, 37, 16)}
DECODE = (2, 40, 6, 2, 16, np.array([17, 40], np.int32))  # B, S, Hq, Hkv, d


def qkv(b, hq, hkv, tq, tk, d, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, tq, d)).astype(dtype),
            rng.standard_normal((b, hkv, tk, d)).astype(dtype),
            rng.standard_normal((b, hkv, tk, d)).astype(dtype))


def decode_inputs():
    b, s, hq, hkv, d, lens = DECODE
    rng = np.random.default_rng(1)
    return (rng.standard_normal((b, 1, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32), lens)


@pytest.fixture(scope="module")
def reference():
    """{shape name: (flash_attention_ref causal, flash_chunked causal,
    flash_attention_ref non-causal)} and the reference decode attention,
    each from one jitted function."""
    jax = pytest.importorskip("jax")
    from repro.kernels.ref import flash_attention_ref
    from repro.models.attention import decode_attention, flash_chunked

    def both(q, k, v):
        t = (0, 2, 1, 3)   # flash_chunked takes (B, T, H, d)
        chunked = flash_chunked(q.transpose(t), k.transpose(t),
                                v.transpose(t), causal=True, q_chunk=16,
                                kv_chunk=16).transpose(t)
        return (flash_attention_ref(q, k, v), chunked,
                flash_attention_ref(q, k, v, causal=False))

    run = jax.jit(both)
    out = {name: tuple(np.asarray(x) for x in run(*qkv(*shape)))
           for name, shape in SHAPES.items()}
    out["decode"] = np.asarray(jax.jit(decode_attention)(*decode_inputs()))
    return out


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_flash_attention_matches_reference(name, reference):
    q, k, v = map(torch.from_numpy, qkv(*SHAPES[name]))
    want_ref, want_chunked, want_full = reference[name]
    got = ops.flash_attention(q, k, v).numpy()
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_chunked, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        ops.flash_attention(q, k, v, causal=False).numpy(), want_full,
        rtol=0, atol=ATOL)


def test_decode_attention_matches_reference(reference):
    q, kc, vc, lens = decode_inputs()
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), reference["decode"], rtol=0,
                               atol=ATOL)


def test_plain_flash_attention_takes_strided_views_and_masks_to_zero():
    """The model passes (B, T, H, d) activations transposed; a query row
    that sees no key (causal, Tq > Tk) gives 0, not NaN."""
    q, k, v = map(torch.from_numpy, qkv(2, 4, 2, 12, 12, 16, seed=3))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    torch.testing.assert_close(ops.flash_attention(*views),
                               ops.flash_attention(q, k, v), rtol=0, atol=0)
    q, k, v = map(torch.from_numpy, qkv(1, 2, 1, 6, 4, 16, seed=4))
    out = ops.flash_attention(q, k, v)
    assert torch.isfinite(out).all()
    assert torch.equal(out[:, :, :2], torch.zeros_like(out[:, :, :2]))
    # rows 2..5 see keys 0..k: each is the softmax-weighted mean of v
    s = torch.einsum("bhd,bkd->bhk", q[:, :, 5], k[:, 0]) / 4.0
    want = torch.einsum("bhk,bkd->bhd", torch.softmax(s, -1), v[:, 0])
    torch.testing.assert_close(out[:, :, 5], want, rtol=0, atol=ATOL)


def test_dispatcher_routes_cpu_tensors_to_the_plain_version():
    q, k, v = map(torch.from_numpy, qkv(1, 2, 2, 8, 8, 16))
    before = ops.LAUNCHES["flash_attention"]
    assert torch.equal(ops.flash_attention(q, k, v),
                       ops.flash_attention(q, k, v, impl="ref"))
    assert ops.LAUNCHES["flash_attention"] == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, v, impl="pallas")


# ------------------------------------------------------------ on a card

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B7 has no CPU or interpret "
                    "mode")
    return torch.device("cuda")


# Per element |got - want| <= out |want| + prob sum_j p_j |v_j| + atol,
# and never more than cap, as (out, prob, atol, cap).  Kernel and plain
# version both compute in float32 from the same inputs.  Both round a
# bf16 / f16 output to 8 / 11 bits: together at most one ulp, 2^-7 /
# 2^-10 of the value.  The kernel also rounds each probability to that
# type before the P.V product (half an ulp, 2^-8 / 2^-11 of p_j), which
# moves the sum by at most that share of sum_j p_j |v_j|.  float32 agrees
# to 1e-4; cap is the absolute bound of each type.
TOL = {torch.bfloat16: (2 ** -7, 2 ** -8, 1e-6, 2e-2),
       torch.float16: (2 ** -10, 2 ** -11, 1e-6, 4e-3),
       torch.float32: (0.0, 0.0, 1e-4, 1e-4)}
CARD_SHAPES = [(2, 12, 2, 256, 256, 128), (1, 12, 2, 100, 100, 128),
               (2, 4, 2, 1, 300, 64), (1, 6, 3, 70, 200, 64),
               (2, 4, 2, 130, 130, 16), (1, 2, 1, 33, 65, 32),
               (1, 4, 2, 80, 50, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain_on_card(shape, dtype, causal):
    dev = _need_card()
    q, k, v = (torch.from_numpy(x).to(dev, dtype) for x in qkv(*shape))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, impl="cuda")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ops.flash_attention(q, k, v, causal=causal, impl="ref")
    assert got.dtype == dtype and got.shape == want.shape
    out, prob, atol, cap = TOL[dtype]
    err = (got.float() - want.float()).abs()
    tol = out * want.float().abs() + atol
    if prob:        # sum_j p_j |v_j|: the plain version on |v|, in f32
        tol += prob * ops.flash_attention(q.float(), k.float(),
                                          v.float().abs(), causal=causal,
                                          impl="ref")
    ratio = float((err / tol.clamp(max=cap)).max())
    assert ratio <= 1, (f"error {ratio:.3g} times its bound (max abs err "
                        f"{float(err.max())})")


@pytest.mark.cuda
def test_flash_attention_kernel_on_strided_views_on_card():
    dev = _need_card()
    q, k, v = (torch.from_numpy(x).to(dev, torch.bfloat16)
               for x in qkv(2, 12, 2, 96, 96, 128, seed=5))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    got = ops.flash_attention(*views, impl="cuda")
    torch.cuda.synchronize()
    assert got.stride() == views[0].stride()
    torch.testing.assert_close(got, ops.flash_attention(q, k, v, impl="cuda"),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_bad_operands_on_card():
    dev = _need_card()
    q, k, v = (torch.from_numpy(x).to(dev, torch.bfloat16)
               for x in qkv(1, 4, 2, 16, 16, 16))
    with pytest.raises(TypeError, match="expected"):
        ops.flash_attention(q, k.float(), v, impl="cuda")
    with pytest.raises(ValueError, match="d in"):
        ops.flash_attention(q[..., :8], k[..., :8], v[..., :8], impl="cuda")
    with pytest.raises(ValueError, match="Hq % Hkv"):
        ops.flash_attention(q[:, :3], k, v, impl="cuda")
