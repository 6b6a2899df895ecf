"""Kernels B1-B3 of the port: the plain versions against the reference's
Pallas kernels (interpret mode) and jnp oracles, the dispatcher's
routing, and — on a card only — the CUDA kernels against their plain
versions.

Shapes and densities are those of `tests/test_kernels.py`; inputs are
made from a seed with numpy.  Every output is bit-valued, so agreement is
exact.  Tests marked ``cuda`` decide inside the test whether a card is
present and skip with a reason when it is not; run them on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels.py``.
The machine with the card has no JAX, so this file imports the reference
inside the tests that compare with it, not at the top.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the tensors here are small: one intra-op thread each keeps the test
# workers from contending for the cores
torch.set_num_threads(1)

from repro_torch.core import bitset as tb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

BITMM_SHAPES = [(128, 128, 128), (64, 256, 512), (256, 512, 256),
                (8, 1024, 1024)]
UPDATE_SHAPES = [(128, 32), (256, 64), (512, 256), (1024, 32)]
DELETE_CAPS = [128, 320, 512, 1024]


def packed(rng, shape, density):
    """Random packed words as a numpy uint32 array (LSB-first, packed with
    numpy so no JAX compile is spent on making inputs)."""
    bits = np.packbits(rng.random(shape) < density, axis=-1,
                       bitorder="little")
    return np.ascontiguousarray(bits).view("<u4").astype(np.uint32)


def t(a, device="cpu"):
    return torch.from_numpy(np.array(a).view(np.int32)).to(device)


def u32(x):
    return x.cpu().numpy().view(np.uint32)


def bitmm_inputs(m, k, n, density):
    rng = np.random.default_rng(m * 7 + n)
    return packed(rng, (m, k), density), packed(rng, (k, n), 0.05)


def update_inputs(c, b, density):
    rng = np.random.default_rng(c + b)
    return (packed(rng, (c, c), density), packed(rng, (c, b), 0.2),
            packed(rng, (b, c), 0.1))


def delete_inputs(c, aff_frac):
    rng = np.random.default_rng(c + int(aff_frac * 10))
    return (packed(rng, (c, c), 0.05), packed(rng, (c, c), 0.05),
            packed(rng, (c,), aff_frac))


def _check_against_reference(name, args):
    """Port plain version == reference Pallas (interpret) == jnp oracle."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops

    jfn = {"bitmm": jops.bitmm_packed, "closure_update": jops.closure_update,
           "closure_delete": jops.closure_delete}[name]
    tfn = {"bitmm": ops.bitmm_packed, "closure_update": ops.closure_update,
           "closure_delete": ops.closure_delete}[name]
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jfn(*jargs, impl="ref"))
    np.testing.assert_array_equal(
        np.asarray(jfn(*jargs, impl="pallas_interpret")), want)
    np.testing.assert_array_equal(u32(tfn(*map(t, args), impl="ref")), want)


@pytest.mark.parametrize("m,k,n", BITMM_SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.02, 0.5])
def test_bitmm_plain_matches_reference(m, k, n, density):
    _check_against_reference("bitmm", bitmm_inputs(m, k, n, density))


@pytest.mark.parametrize("c,b", UPDATE_SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.05, 0.5])
def test_closure_update_plain_matches_reference(c, b, density):
    _check_against_reference("closure_update", update_inputs(c, b, density))


@pytest.mark.parametrize("c", DELETE_CAPS)
@pytest.mark.parametrize("aff_frac", [0.0, 0.25, 1.0])
def test_closure_delete_plain_matches_reference(c, aff_frac):
    _check_against_reference("closure_delete", delete_inputs(c, aff_frac))


def test_dispatcher_routes_cpu_tensors_to_plain_versions():
    """impl="auto" on CPU tensors is the plain version and launches
    nothing; impl="cuda" on CPU tensors raises; unknown impls raise."""
    lhs, rhs = map(t, bitmm_inputs(64, 256, 512, 0.02))
    closure, mask, rows = map(t, update_inputs(128, 32, 0.05))
    r, s, aff = map(t, delete_inputs(128, 0.25))
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.bitmm_packed(lhs, rhs),
                       ops.bitmm_packed(lhs, rhs, impl="ref"))
    assert torch.equal(ops.closure_update(closure, mask, rows),
                       ops.closure_update(closure, mask, rows, impl="ref"))
    assert torch.equal(ops.closure_delete(r, s, aff),
                       ops.closure_delete(r, s, aff, impl="ref"))
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.bitmm_packed(lhs, rhs, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.closure_update(closure, mask, rows, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.closure_delete(r, s, aff, impl="cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.bitmm_packed(lhs, rhs, impl="pallas")
    assert ops.LAUNCHES == before


def test_plain_closure_delete_is_the_masked_scan_hop():
    """The plain hop drives `masked_delete_scan` to the from-scratch
    closure of the post-delete graph (the reference's drop-in check)."""
    from repro_torch.core import closure_cache, reachability
    rng = np.random.default_rng(9)
    cap = 128
    a = np.triu(rng.random((cap, cap)) < 0.04, 1)
    adj = tb.pack_bits(torch.from_numpy(a))
    closure = reachability.transitive_closure(adj)
    us, vs = np.nonzero(a)
    a2 = a.copy()
    a2[us[0], vs[0]] = a2[us[7], vs[7]] = False
    adj2 = tb.pack_bits(torch.from_numpy(a2))
    seeds = torch.tensor([int(us[0]), int(us[7])], dtype=torch.int32)
    affected = closure_cache.affected_rows(closure, seeds,
                                           torch.tensor([True, True]))
    got, n, _ = closure_cache.masked_delete_scan(
        adj2, closure, affected,
        hop_impl=lambda r, s, fp: ops.closure_delete(r, s, fp, impl="ref"))
    assert torch.equal(got, reachability.transitive_closure(adj2))
    assert n >= 1


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", BITMM_SHAPES + [(33, 96, 160)])
@pytest.mark.parametrize("density", [0.0, 0.02, 0.5])
def test_bitmm_kernel_matches_plain_on_card(m, k, n, density):
    dev = _need_card()
    lhs, rhs = (t(a, dev) for a in bitmm_inputs(m, k, n, density))
    before = ops.LAUNCHES["bitmm"]
    got = ops.bitmm_packed(lhs, rhs, impl="cuda")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["bitmm"] == before + 1
    assert torch.equal(got, ops.bitmm_packed(lhs, rhs, impl="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("c,b", UPDATE_SHAPES + [(320, 64)])
@pytest.mark.parametrize("density", [0.0, 0.05, 0.5])
def test_closure_update_kernel_matches_plain_on_card(c, b, density):
    dev = _need_card()
    args = [t(a, dev) for a in update_inputs(c, b, density)]
    got = ops.closure_update(*args, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, ops.closure_update(*args, impl="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("c", DELETE_CAPS)
@pytest.mark.parametrize("aff_frac", [0.0, 0.25, 1.0])
def test_closure_delete_kernel_matches_plain_on_card(c, aff_frac):
    dev = _need_card()
    args = [t(a, dev) for a in delete_inputs(c, aff_frac)]
    got = ops.closure_delete(*args, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, ops.closure_delete(*args, impl="ref"))


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_operands_on_card():
    dev = _need_card()
    lhs, rhs = (t(a, dev) for a in bitmm_inputs(64, 256, 512, 0.02))
    with pytest.raises(TypeError, match="int32"):
        ops.bitmm_packed(lhs.to(torch.int64), rhs)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bitmm_packed(lhs.t(), lhs)
    with pytest.raises(ValueError, match="rows"):
        ops.bitmm_packed(lhs, rhs[:128])
