"""Kernels B4 (`closure_update_tiled`) and B5 (`closure_delete_tiled`) of
the port: the plain versions against the reference's oracles
`repro.kernels.ref.closure_*_tiled_ref`, the dispatcher's routing, and —
on a card only — the CUDA kernels against their plain versions.

Inputs are made from a seed with numpy.  Every output (the packed words
and the per-tile occupancy plane ``occ``) is bit-valued, so agreement is
exact.  The reference runs once for all cases, under one ``jax.jit``,
so the file adds one compilation to the process that runs it.  Tests
marked ``cuda`` decide inside the test whether a card is present and skip
with a reason when it is not; run them on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_tiled_kernels.py``.
The machine with the card has no JAX, so the reference is imported inside
the fixture that runs it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the tensors here are small: one intra-op thread each keeps the test
# workers from contending for the cores
torch.set_num_threads(1)

from repro_torch.kernels import ops  # noqa: E402

# (kind, R, B or affected fraction, density) — R = 96 is not a multiple
# of 256, the reference kernel's column block
CASES = ([("update", r, b, d) for r in (64, 96) for b in (32, 64)
          for d in (0.0, 0.05, 0.5)]
         + [("delete", r, f, 0.05) for r in (64, 96) for f in (0.0, 0.25, 1.0)])


def case_id(case):
    kind, r, x, d = case
    return f"{kind}-R{r}-{x}-{d}"


def packed(rng, shape, density):
    """Random packed words as a numpy uint32 array (LSB-first)."""
    bits = np.packbits(rng.random(shape) < density, axis=-1,
                       bitorder="little")
    return np.ascontiguousarray(bits).view("<u4").astype(np.uint32)


def inputs(case):
    kind, r, x, d = case
    rng = np.random.default_rng(r * 131 + int(x * 100) + int(d * 1000))
    if kind == "update":
        return (packed(rng, (r, r), d), packed(rng, (r, x), 0.2),
                packed(rng, (x, r), 0.1))
    return (packed(rng, (r, r), d), packed(rng, (r, r), d),
            packed(rng, (r,), x))


def t(a, device="cpu"):
    return torch.from_numpy(np.array(a).view(np.int32)).to(device)


def u32(x):
    return x.cpu().numpy().view(np.uint32)


def plain(kind, args, impl="ref"):
    fn = ops.closure_update_tiled if kind == "update" \
        else ops.closure_delete_tiled
    return fn(*args, impl=impl)


@pytest.fixture(scope="module")
def reference():
    """{case id: (words, occ)} from the reference's oracles, all cases in
    one jitted call."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    def run(all_args):
        return [(jref.closure_update_tiled_ref if c[0] == "update"
                 else jref.closure_delete_tiled_ref)(*a)
                for c, a in zip(CASES, all_args)]

    all_args = [tuple(jnp.asarray(a) for a in inputs(c)) for c in CASES]
    outs = jax.jit(run)(all_args)
    return {case_id(c): (np.asarray(o[0]), np.asarray(o[1]))
            for c, o in zip(CASES, outs)}


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_tiled_kernel_matches_reference(case, reference):
    out, occ = plain(case[0], [t(a) for a in inputs(case)])
    want_out, want_occ = reference[case_id(case)]
    np.testing.assert_array_equal(u32(out), want_out)
    np.testing.assert_array_equal(occ.numpy(), want_occ.astype(np.int32))
    assert occ.dtype == torch.int32 and tuple(occ.shape) == (
        case[1] // 32, case[1] // 32)


def test_tiled_dispatcher_routes_cpu_tensors_to_plain_versions():
    """impl="auto" on CPU tensors is the plain version and launches
    nothing; impl="cuda" on CPU tensors raises."""
    upd = [t(a) for a in inputs(CASES[1])]
    dele = [t(a) for a in inputs(CASES[-2])]
    before = dict(ops.LAUNCHES)
    for kind, args in (("update", upd), ("delete", dele)):
        got, want = plain(kind, args, "auto"), plain(kind, args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        with pytest.raises(ValueError, match="CUDA tensor"):
            plain(kind, args, "cuda")
    assert ops.LAUNCHES == before
    assert "closure_update_tiled" in before and "closure_delete_tiled" in before


# ------------------------------------------------------------ on the card

CARD_REGIONS = (32, 96, 1024, 4096)
CARD_DENSITIES = (0.0, 0.01, 0.25, 1.0)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda")


def _card_inputs(kind, r, density, band_live, dev):
    """Inputs at window R: ``band_live`` False empties every other 32-row
    band of the fold mask / the affected mask (no-live bands)."""
    rng = np.random.default_rng(r + int(density * 100))
    if kind == "update":
        args = [packed(rng, (r, r), density), packed(rng, (r, 128), density),
                packed(rng, (128, r), density)]
        if not band_live:
            args[1][(np.arange(r) // 32) % 2 == 1] = 0
    else:
        args = [packed(rng, (r, r), density), packed(rng, (r, r), density),
                packed(rng, (r,), 1.0 if band_live else 0.5)]
        if not band_live:
            args[2][1::2] = 0   # one affected word per band of 32 rows
    return [t(a, dev) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["update", "delete"])
@pytest.mark.parametrize("r", CARD_REGIONS)
@pytest.mark.parametrize("density", CARD_DENSITIES)
@pytest.mark.parametrize("band_live", [True, False])
def test_tiled_kernel_matches_plain_on_card(kind, r, density, band_live):
    dev = _need_card()
    args = _card_inputs(kind, r, density, band_live, dev)
    name = f"closure_{kind}_tiled"
    before = ops.LAUNCHES[name]
    out, occ = plain(kind, args, "cuda")
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 1
    want_out, want_occ = plain(kind, args)
    assert torch.equal(out, want_out)
    assert torch.equal(occ, want_occ)


@pytest.mark.cuda
def test_tiled_kernel_wrappers_reject_bad_operands_on_card():
    dev = _need_card()
    tiles, mask, rows = _card_inputs("update", 96, 0.25, True, dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.closure_update_tiled(tiles.t(), mask, rows)
    with pytest.raises(ValueError, match="shapes"):
        ops.closure_update_tiled(tiles[:64], mask, rows)
    r, s, aff = _card_inputs("delete", 96, 0.25, True, dev)
    with pytest.raises(ValueError, match="shapes"):
        ops.closure_delete_tiled(r, s, aff[:2])
