"""Kernel B6 of the port (the weighted embedding bag): its plain version
against the reference, the dispatcher's routing, and — on a card only —
the CUDA kernel against its plain version.

On the CPU, `ops.embedding_bag` runs its plain version
(`kernels/ref.embbag_ref`); it is held against the reference's
`kernels.ref.embbag_ref` at the shapes of `tests/test_kernels.py`
(R, D, B, K) in float32 and bfloat16, with random weights and about a
fifth of the entries 0-weight padding, and against the reference's
Pallas kernel in interpret mode in one float32 and one bfloat16 case.
Both sides compute w * t in float32 and sum over k in float32, in other
orders, so each element agrees within its rounding bound: K 2^-23
sum_k |w_k t_k| (float32 summation), plus one bfloat16 ulp of the
output, 2^-7 |want|, where the two float32 sums may round to neighbouring
bfloat16 values.  The same bound holds the kernel on the card.

The reference is imported and jitted inside fixtures and tests, not at
module level: the machine with the card has no JAX, and ``pytest -m cuda
tests/test_torch_embbag.py`` runs only the card tests there.  4 XLA
compilations: one jit of every reference case, two Pallas calls, and a
scalar conversion that JAX compiles on first use.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ops  # noqa: E402

SHAPES = [(64, 16, 8, 4), (256, 128, 16, 8), (1024, 32, 32, 2)]  # R, D, B, K
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def case(rows, d, b, k, seed=None):
    """float32 table (R, D), int32 idx (B, K) and float32 weights (B, K),
    about a fifth of them 0 (padding), from a seed with numpy."""
    rng = np.random.default_rng(rows + b if seed is None else seed)
    table = rng.standard_normal((rows, d)).astype(np.float32)
    idx = rng.integers(0, rows, (b, k)).astype(np.int32)
    w = (rng.random((b, k)) * (rng.random((b, k)) < 0.8)).astype(np.float32)
    return table, idx, w


def rounding_bound(table, idx, w, want):
    """Per-element bound of |got - want| for two float32 bags of the same
    inputs (torch tensors, table in its type): K 2^-23 sum_k |w_k t_k|,
    plus 2^-7 |want| when the output is bfloat16."""
    k = idx.shape[1]
    mag = (table[idx.long()].double().abs()
           * w.double().abs()[..., None]).sum(1)
    tol = k * 2.0 ** -23 * mag
    if table.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.double().abs()
    return tol


def assert_within_bound(got, want, table, idx, w):
    err = (got.double() - want.double()).abs()
    tol = rounding_bound(table, idx, w, want)
    assert bool((err <= tol).all()), (
        f"{table.dtype}: max abs err {float(err.max())}, largest error over "
        f"its bound {float((err / tol.clamp(min=1e-300)).max())}")


def port_inputs(table, idx, w, dtype, device="cpu"):
    return (torch.from_numpy(table).to(device, DTYPES[dtype]),
            torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device))


@pytest.fixture(scope="module")
def reference():
    """The reference's `embbag_ref` on every (shape, type) case, in one
    jitted function; -> {(shape, type): float32 numpy output}."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref as jref

    keys = [(s, dt) for s in SHAPES for dt in DTYPES]
    inputs = [case(*s) for s, _ in keys]

    def run(cases):
        outs = []
        for (_, dt), (table, idx, w) in zip(keys, cases):
            t = table.astype(jnp.bfloat16) if dt == "bfloat16" else table
            outs.append(jref.embbag_ref(t, idx, w).astype(jnp.float32))
        return outs

    outs = jax.jit(run)(inputs)
    return {key: np.asarray(o) for key, o in zip(keys, outs)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_embbag_plain_matches_reference(reference, shape, dtype):
    table, idx, w = port_inputs(*case(*shape), dtype)
    got = ops.embedding_bag(table, idx, w)
    assert got.dtype == DTYPES[dtype] and got.shape == (shape[2], shape[1])
    want = torch.from_numpy(np.array(reference[(shape, dtype)]))
    assert_within_bound(got.float(), want, table, idx, w)


@pytest.mark.parametrize("dtype,shape", [("float32", SHAPES[0]),
                                         ("bfloat16", SHAPES[2])])
def test_embbag_plain_matches_pallas_interpret(dtype, shape):
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    table, idx, w = case(*shape)
    jtable = table.astype(jnp.bfloat16) if dtype == "bfloat16" else table
    want = np.asarray(jops.embedding_bag(jtable, idx, w,
                                         impl="pallas_interpret"))
    want = torch.from_numpy(want.astype(np.float32))
    t, i, wt = port_inputs(table, idx, w, dtype)
    assert_within_bound(ops.embedding_bag(t, i, wt).float(), want, t, i, wt)


def test_embbag_plain_any_width_and_empty_batch():
    """D = 1 (the xDeepFM linear term: K = 39, unit weights), an odd D,
    K = 1, and B = 0, against a float64 sum of the same float32 terms."""
    for rows, d, b, k in [(500, 1, 12, 39), (40, 3, 5, 7), (9, 6, 4, 1),
                          (9, 4, 0, 3)]:
        table, idx, w = (torch.from_numpy(x) for x in case(rows, d, b, k, 7))
        got = ops.embedding_bag(table, idx, w)
        assert got.shape == (b, d) and got.dtype == torch.float32
        want = (table[idx.long()].double() * w.double()[..., None]).sum(1)
        assert_within_bound(got, want, table, idx, w)


def test_dispatcher_routes_cpu_tensors_to_the_plain_version():
    table, idx, w = (torch.from_numpy(x) for x in case(*SHAPES[0]))
    before = ops.LAUNCHES["embbag"]
    assert torch.equal(ops.embedding_bag(table, idx, w),
                       ops.embedding_bag(table, idx, w, impl="ref"))
    assert ops.LAUNCHES["embbag"] == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.embedding_bag(table, idx, w, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.embedding_bag(table, idx, w, impl="pallas")


# ------------------------------------------------------------ on a card

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B6 has no CPU or interpret "
                    "mode")
    return torch.device("cuda")


# (R, D, B, K): the test_kernels.py shapes, the xDeepFM linear term (D=1,
# K=39), odd D (scalar loads), K past one staged tile, D past one round
# of 256 chunks (float32 1100, bfloat16 2056), and B = 0
CARD_SHAPES = SHAPES + [(5000, 1, 512, 39), (300, 3, 7, 5), (64, 40, 9, 33),
                        (64, 1100, 4, 5), (64, 2056, 3, 5), (16, 8, 0, 3)]


# Parametrized over shapes, each looping over both types inside: the
# count of card cases, which only skip on the CPU, is held down (ROADMAP
# "How this round works").
@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_embbag_kernel_matches_plain_on_card(shape):
    dev = _need_card()
    for dtype in DTYPES:
        table, idx, w = port_inputs(*case(*shape), dtype, device=dev)
        before = ops.LAUNCHES["embbag"]
        got = ops.embedding_bag(table, idx, w, impl="cuda")
        torch.cuda.synchronize()
        assert ops.LAUNCHES["embbag"] == before + (shape[2] > 0), dtype
        want = ops.embedding_bag(table, idx, w, impl="ref")
        assert got.dtype == want.dtype and got.shape == want.shape, dtype
        assert_within_bound(got.float(), want.float(), table, idx, w)


@pytest.mark.cuda
def test_embbag_kernel_on_an_unaligned_table_on_card():
    """A table that starts 4 bytes past a 16-byte boundary takes the
    scalar loads; the result equals the aligned copy's."""
    dev = _need_card()
    table, idx, w = port_inputs(*case(64, 16, 8, 4), "float32", device=dev)
    flat = torch.cat([table.new_zeros(1), table.reshape(-1)])
    view = flat[1:].view(64, 16)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    got = ops.embedding_bag(view, idx, w, impl="cuda")
    aligned = ops.embedding_bag(table, idx, w, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, aligned)


@pytest.mark.cuda
def test_embbag_kernel_rejects_bad_operands_on_card():
    dev = _need_card()
    table, idx, w = port_inputs(*case(*SHAPES[0]), "float32", device=dev)
    with pytest.raises(TypeError, match="idx"):
        ops.embedding_bag(table, idx.long(), w, impl="cuda")
    with pytest.raises(TypeError, match="weights"):
        ops.embedding_bag(table, idx, w.double(), impl="cuda")
    with pytest.raises(TypeError, match="table"):
        ops.embedding_bag(table.half(), idx, w, impl="cuda")
    with pytest.raises(ValueError, match="K >= 1"):
        ops.embedding_bag(table, idx, w[:, :2].contiguous(), impl="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        ops.embedding_bag(table.t(), idx, w, impl="cuda")
