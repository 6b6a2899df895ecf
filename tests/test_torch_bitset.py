"""The port's bit layer (`repro_torch.core.bitset`) against the reference
(`repro.core.bitset`).

Inputs are made from a seed with numpy and passed to both packages as
numpy arrays; packed words cross as int32 views of the uint32 words.
Every output here is bit-valued, so agreement must be exact.  Capacities
C in {32, 1024, 65536}; the cases include bit 31 (whose int32 mask is
INT32_MIN) and duplicated pairs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the tensors here are small: one intra-op thread each keeps the test
# workers from contending for the cores
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.core import bitset as jb  # noqa: E402
from repro_torch.core import bitset as tb  # noqa: E402

CAPS = [32, 1024, 65536]


def t(a):
    """numpy / jax array -> torch tensor (uint32 words as int32 views)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def u32(x):
    """torch tensor of packed words -> numpy uint32 with the same bits."""
    return x.cpu().numpy().view(np.uint32)


def _slots(rng, c, n):
    """n slots in [0, c), always including c - 1 (bit 31 of its word) and
    a bit-31 slot of word 0."""
    s = rng.integers(0, c, n).astype(np.int32)
    s[0], s[1] = c - 1, 31
    return s


@pytest.mark.parametrize("c", CAPS)
def test_pack_unpack_match_reference(c):
    rng = np.random.default_rng(c)
    bits = rng.random((3, c)) < 0.3
    bits[:, 31] = True                      # bit 31 of word 0
    bits[0, c - 1] = True                   # bit 31 of the last word
    want = np.asarray(jb.pack_bits(jnp.asarray(bits)))
    got = tb.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(tb.unpack_bits(got).numpy(), bits)
    np.testing.assert_array_equal(
        tb.unpack_bits(t(want)).numpy(),
        np.asarray(jb.unpack_bits(jnp.asarray(want))))
    assert tb.n_words(c) == jb.n_words(c)


@pytest.mark.parametrize("c", CAPS)
def test_bit_get_onehot_popcount_match_reference(c):
    rng = np.random.default_rng(c + 1)
    rows = min(c, 64)
    packed = np.asarray(jb.pack_bits(jnp.asarray(rng.random((rows, c)) < 0.2)))
    r = rng.integers(0, rows, 16).astype(np.int32)
    cols = _slots(rng, c, 16)
    np.testing.assert_array_equal(
        tb.bit_get(t(packed), t(r), t(cols)).numpy(),
        np.asarray(jb.bit_get(jnp.asarray(packed), jnp.asarray(r),
                              jnp.asarray(cols))))
    np.testing.assert_array_equal(
        u32(tb.onehot_rows(t(cols), c)),
        np.asarray(jb.onehot_rows(jnp.asarray(cols), c)))
    want = np.asarray(jb.popcount(jnp.asarray(packed)))
    np.testing.assert_array_equal(tb.popcount(t(packed)).numpy(), want)
    np.testing.assert_array_equal(tb.popcount_swar(t(packed)).numpy(),
                                  np.asarray(jb.popcount_swar(
                                      jnp.asarray(packed))))


def test_first_occurrence_and_dedupe_pick_lowest_batch_index():
    rng = np.random.default_rng(7)
    for _ in range(5):
        key = rng.integers(-4, 6, 40).astype(np.int32)
        np.testing.assert_array_equal(
            tb._first_occurrence(t(key)).numpy(),
            np.asarray(jb._first_occurrence(jnp.asarray(key))))
        rows = rng.integers(0, 4, 40).astype(np.int32)
        cols = rng.integers(0, 4, 40).astype(np.int32)
        en = rng.random(40) < 0.6
        np.testing.assert_array_equal(
            tb._dedupe_enabled(t(rows), t(cols), t(en), 64).numpy(),
            np.asarray(jb._dedupe_enabled(jnp.asarray(rows),
                                          jnp.asarray(cols),
                                          jnp.asarray(en), 64)))


@pytest.mark.parametrize("c", CAPS)
def test_scatter_set_and_clear_match_reference(c):
    """Duplicated pairs, already-set / already-clear bits and bit 31."""
    rng = np.random.default_rng(c + 2)
    rows_n = min(c, 64)
    packed = np.asarray(jb.pack_bits(
        jnp.asarray(rng.random((rows_n, c)) < 0.1)))
    n = 48
    r = rng.integers(0, rows_n, n).astype(np.int32)
    cols = _slots(rng, c, n)
    r[2:6], cols[2:6] = r[0], cols[0]       # duplicates of a bit-31 pair
    r[6:8], cols[6:8] = r[1], cols[1]
    en = rng.random(n) < 0.8
    en[:3] = True
    for name in ("scatter_set_bits", "scatter_clear_bits"):
        want = np.asarray(getattr(jb, name)(
            jnp.asarray(packed), jnp.asarray(r), jnp.asarray(cols),
            jnp.asarray(en)))
        got = getattr(tb, name)(t(packed), t(r), t(cols), t(en))
        np.testing.assert_array_equal(u32(got), want, err_msg=name)
    # the inputs were not written in place
    np.testing.assert_array_equal(u32(t(packed)), packed)
