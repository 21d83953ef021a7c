"""Window scoring on the accelerator.

The scoring step replaces the reference's per-window numba loop
(``score_sequences.py:331-398``) with a batched one-hot x PWM contraction:

    scores[b, m] = sum_i  S_m[code[b, i], i]

expressed as ``(B, 4k) @ (4k, M)`` so it rides the matrix units.  All scaled scores
are integers in ``[0, RANGE]``; with float32 accumulation every intermediate
value is below 2^24 so the result is exact and bit-equal to the reference's
integer arithmetic.

Alongside the scores the kernel accumulates an integer histogram of scores
per motif.  The histogram is the key design move: because scaled
scores are bounded integers, the *entire* score distribution of a scan fits
in ``RANGE*k+1`` bins, which makes exact p-value thresholds, exact global
BH q-values and cross-device reduction (``psum`` over histograms) possible
without ever materialising per-window p-values (cf. SURVEY.md §5.8).

Windows containing any non-ACGT symbol score ``min_score`` exactly like the
reference (``score_sequences.py:376-378``).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from grafimo_tpu.utils.constants import N_CODE, PAD_CODE, RANGE


def pwm_to_flat(score_matrix: np.ndarray) -> np.ndarray:
    """``(4, k)`` int score matrix -> ``(4k,)`` f32 layout matching the
    one-hot flattening (position-major: row ``i*4 + code``)."""
    return np.ascontiguousarray(
        np.asarray(score_matrix, dtype=np.float32).T.reshape(-1)
    )


def pwms_to_flat(score_matrices) -> np.ndarray:
    """Stack M same-width score matrices into ``(4k, M)`` f32."""
    return np.stack([pwm_to_flat(m) for m in score_matrices], axis=1)


def score_hist_core(codes, pwm_flat, min_scores, hist_size: int):
    """The ONE scoring + exact-histogram core — shared verbatim by the
    plain jit path (:func:`score_and_histogram`) and the multi-chip
    shard_map window step (``parallel/pipeline.sharded_scan_step``), so
    the two cannot drift.

    ``codes (B, k)``: 0..3 bases, ``N_CODE`` (4) = N window -> scores
    ``min_score`` (reference ``score_sequences.py:376-378``),
    ``PAD_CODE`` (5) = padding row -> scores -1 and drops from the
    histogram.
    """
    b, k = codes.shape
    codes = codes.astype(jnp.int32)
    onehot = (
        codes[:, :, None] == jnp.arange(4, dtype=jnp.int32)[None, None, :]
    ).astype(jnp.float32)
    onehot = onehot.reshape(b, 4 * k)
    raw = jnp.dot(
        onehot, pwm_flat, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    scores = raw.astype(jnp.int32)
    has_n = jnp.any(codes >= N_CODE, axis=1)
    scores = jnp.where(has_n[:, None], min_scores[None, :], scores)
    is_pad = jnp.any(codes >= PAD_CODE, axis=1)
    scores = jnp.where(is_pad[:, None], jnp.int32(-1), scores)
    m_idx = jnp.broadcast_to(
        jnp.arange(scores.shape[1], dtype=jnp.int32)[None, :], scores.shape
    )
    valid = (scores >= 0).astype(jnp.int32)
    hist = jnp.zeros((hist_size, scores.shape[1]), jnp.int32)
    hist = hist.at[jnp.clip(scores, 0, hist_size - 1), m_idx].add(valid)
    return scores, hist


@partial(jax.jit, static_argnames=("hist_size",))
def score_and_histogram(codes, pwm_flat, min_scores, hist_size: int):
    """Score a batch against M same-width motifs and histogram the scores.

    Parameters
    ----------
    codes: ``(B, k)`` uint8/int32, values 0..3 (4 = N, 5 = padding)
    pwm_flat: ``(4k, M)`` float32 scaled score matrices
    min_scores: ``(M,)`` int32 per-motif ``min_score`` (N-window score)
    hist_size: static, ``RANGE * k + 1``

    Returns
    -------
    scores: ``(B, M)`` int32 exact integer scores (-1 on padding rows)
    hist: ``(hist_size, M)`` int32 score histogram (padding dropped)
    """
    return score_hist_core(codes, pwm_flat, min_scores, hist_size)


@jax.jit
def score_batch(codes, pwm_flat, min_scores):
    """Scores only (``(B, M)`` int32); see :func:`score_and_histogram`."""
    b, k = codes.shape
    codes = codes.astype(jnp.int32)
    onehot = (
        codes[:, :, None] == jnp.arange(4, dtype=jnp.int32)[None, None, :]
    ).astype(jnp.float32)
    onehot = onehot.reshape(b, 4 * k)
    raw = jnp.dot(
        onehot, pwm_flat, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    scores = raw.astype(jnp.int32)
    has_n = jnp.any(codes >= N_CODE, axis=1)
    return jnp.where(has_n[:, None], min_scores[None, :], scores)


@partial(jax.jit, static_argnames=("k", "hist_size"))
def score_and_histogram_packed(
    packed, flags, pwm_flat, min_scores, k: int, hist_size: int
):
    """Packed-input variant of :func:`score_and_histogram`.

    ``packed (B, ceil(k/4)) uint8`` carries 2-bit codes (4 bases/byte) and
    ``flags (B,) uint8`` marks N-windows (1 -> ``min_score``) and padding
    rows (2 -> score -1, dropped from the histogram).  This is the
    bandwidth-optimal streaming format: ~4x fewer bytes over the
    host->device link than byte codes (see ``ops/pack.py``).
    """
    b = packed.shape[0]
    packed = packed.astype(jnp.int32)
    shifts = jnp.arange(4, dtype=jnp.int32) * 2
    quads = (packed[:, :, None] >> shifts[None, None, :]) & 3
    codes = quads.reshape(b, -1)[:, :k]
    onehot = (
        codes[:, :, None] == jnp.arange(4, dtype=jnp.int32)[None, None, :]
    ).astype(jnp.float32)
    onehot = onehot.reshape(b, 4 * k)
    scores = jnp.dot(
        onehot, pwm_flat, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).astype(jnp.int32)
    flags = flags.astype(jnp.int32)
    scores = jnp.where((flags == 1)[:, None], min_scores[None, :], scores)
    scores = jnp.where((flags == 2)[:, None], jnp.int32(-1), scores)
    m_idx = jnp.broadcast_to(
        jnp.arange(scores.shape[1], dtype=jnp.int32)[None, :], scores.shape
    )
    valid = (scores >= 0).astype(jnp.int32)
    hist = jnp.zeros((hist_size, scores.shape[1]), jnp.int32)
    hist = hist.at[jnp.clip(scores, 0, hist_size - 1), m_idx].add(valid)
    return scores, hist


def reverse_complement_pwm(score_matrix: np.ndarray) -> np.ndarray:
    """PWM that scores the reverse-complement strand directly on forward
    window codes: ``S_rc[c, i] = S[3-c, k-1-i]``.

    Scoring forward codes with ``S_rc`` equals scoring the reverse-complement
    window with ``S`` — so both strands come out of ONE matmul with a
    ``(4k, 2M)`` PWM block, halving extraction and transfer work versus the
    reference's materialised reverse-strand windows.
    """
    return np.ascontiguousarray(np.asarray(score_matrix)[::-1, ::-1])


def hist_size_for_width(width: int) -> int:
    return RANGE * width + 1
