"""The exact score histogram (``ops/score_runs._exact_hist``) against
``np.bincount``: every column count exact, invalid windows dropped."""

import jax
import numpy as np
import pytest

import grafimo_tpu.ops.score_runs as sr


def _ref_hist(scores: np.ndarray, hist_size: int) -> np.ndarray:
    m = scores.shape[-1]
    flat = scores.reshape(-1, m)
    out = np.zeros((hist_size, m), np.int64)
    for c in range(m):
        v = flat[:, c]
        v = v[(v >= 0) & (v < hist_size)]
        out[:, c] = np.bincount(v, minlength=hist_size)
    return out


def _check(scores: np.ndarray, hist_size: int) -> np.ndarray:
    got = np.asarray(
        jax.jit(sr._exact_hist, static_argnums=1)(scores, hist_size)
    )
    assert got.shape == (hist_size, scores.shape[-1])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _ref_hist(scores, hist_size))
    return got


@pytest.mark.parametrize("m", [1, 2, 8, 9, 24])
def test_hist_matches_bincount(m):
    rng = np.random.default_rng(m)
    hs = 19 * 1000 + 1
    scores = rng.integers(-1, hs, (3, 57, m)).astype(np.int32)
    # pile many windows into a few bins, as real score spectra do
    scores[0, :20] = rng.integers(9000, 9004, (20, m))
    got = _check(scores, hs)
    valid = (scores >= 0).reshape(-1, m).sum(axis=0)
    np.testing.assert_array_equal(got.sum(axis=0), valid)


def test_hist_all_invalid():
    scores = np.full((4, 33, 2), -1, np.int32)
    got = _check(scores, 1001)
    assert not got.any()


def test_hist_top_bin_and_out_of_range():
    """The top bin counts; scores past it spill like invalid windows
    instead of aliasing into the next column's bins."""
    hs = 500
    scores = np.zeros((2, 10, 3), np.int32)
    scores[..., 0] = hs - 1
    scores[..., 1] = hs  # one past the top bin: spills
    scores[0, :, 2] = 0
    scores[1, :, 2] = hs - 1
    got = _check(scores, hs)
    assert got[hs - 1, 0] == 20
    assert not got[:, 1].any()
    assert got[0, 2] == 10 and got[hs - 1, 2] == 10


def test_hist_many_rows_one_bin():
    """A large batch whose every window lands in one bin (the contention
    worst case for atomics) still counts exactly."""
    scores = np.full((64, 4096, 2), 7, np.int32)
    got = _check(scores, 19001)
    assert got[7].tolist() == [64 * 4096] * 2


def test_compressed_bins_with_hist_bases():
    """Compressed bins (``hist_bases``): bin 0 holds the N-window value,
    bin 1+i the score base+i, invalid windows drop — checked through the
    masking front end ``_finish_scores`` against a host remap."""
    rng = np.random.default_rng(4)
    b, noff, m, k = 4, 40, 3, 5
    bases = np.array([100, 250, 0], np.int32)
    tops = bases + 300
    scores = rng.integers(bases, tops + 1, (b, noff, m)).astype(np.int32)
    n_ind = (rng.random((b, noff + k - 1)) < 0.02).astype(np.int32)
    valid = rng.random((b, noff)) < 0.8
    vbits = sr.pack_bits(valid)
    mins = np.array([3, 7, 11], np.int32)
    cuts = np.full(m, 10**6, np.int32)
    comp = int((tops - bases).max()) + 2
    hist, _ = jax.jit(sr._finish_scores, static_argnums=(5, 6))(
        scores, n_ind, vbits, mins, cuts, k, comp, hist_bases=bases
    )
    # host: N windows score min_scores; absolute score s lands in bin
    # max(s - base + 1, 0) — bin 0 for the sub-base N value
    cum = np.concatenate(
        [np.zeros((b, 1), np.int64), np.cumsum(n_ind, axis=1)], axis=1
    )
    has_n = (cum[:, k:] - cum[:, :-k]) > 0
    want = np.zeros((comp, m), np.int64)
    for c in range(m):
        s = np.where(has_n, mins[c], scores[:, :, c])
        s = np.maximum(s - bases[c] + 1, 0)
        want[:, c] = np.bincount(s[valid], minlength=comp)
    assert want[0, :2].sum() > 0  # the N windows of columns 0, 1
    np.testing.assert_array_equal(np.asarray(hist), want)
