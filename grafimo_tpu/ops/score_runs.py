"""Device-side run scanning: expand + score every stride-1 window of a run
batch in one fused program.

Input per run (all bit-packed on the wire — this is what crosses the
host->device link instead of materialised windows):

* ``packed (B, R/4) uint8`` — 2-bit base codes, 4 bases/byte;
* ``nbits (B, R/8) uint8`` — N-base indicator bits;
* ``vbits (B, ceil(Noff/8)) uint8`` — window-validity bits
  (``Noff = R - k + 1`` stride-1 offsets).

The scan is a 1-D convolution of the one-hot sequence with the ``(k, 4,
M)`` PWM stack (forward + reverse-complement PWMs as extra M columns), so
the convolution does the window expansion implicitly — no (B*Noff, k)
window tensor ever exists in device memory.  N-windows are detected with a cumulative-sum trick and
scored ``min_score`` (reference ``score_sequences.py:376-378``); invalid
offsets score -1 and are excluded from the histogram and hit bits.

Outputs: the exact integer score histogram per motif column and a packed
hit bitmask (``score >= cutoff``), both tiny on the wire.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def pack_run_seqs(codes: np.ndarray) -> np.ndarray:
    """Pack ``(B, R)`` base codes (0..3; other values masked separately)
    into ``(B, R/4)`` uint8.  R must be a multiple of 4."""
    b, r = codes.shape
    assert r % 4 == 0
    quads = np.minimum(codes, 3).astype(np.uint8).reshape(b, r // 4, 4)
    return (
        quads[:, :, 0]
        | (quads[:, :, 1] << 2)
        | (quads[:, :, 2] << 4)
        | (quads[:, :, 3] << 6)
    ).astype(np.uint8)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack ``(B, L)`` booleans into ``(B, ceil(L/8))`` uint8
    (little-endian bit order)."""
    return np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")


def pwms_to_conv_kernel(score_matrices) -> np.ndarray:
    """Stack ``(4, k)`` integer score matrices into a ``(k, 4, M)`` f32
    convolution kernel.  Entries must stay in [0, 1020] — the bit-exact
    bf16 kernel split in :func:`_score_codes` depends on it (scaled PWMs
    are in [0, RANGE=1000] by construction, models/process.py)."""
    mats = [np.asarray(m, dtype=np.float32).T for m in score_matrices]
    kernel = np.ascontiguousarray(np.stack(mats, axis=-1))
    assert kernel.min() >= 0 and kernel.max() <= 1020, (
        "PWM kernel outside [0, 1020]: exact bf16 split would break"
    )
    return kernel


def _unpack2(packed: jnp.ndarray) -> jnp.ndarray:
    shifts = jnp.arange(4, dtype=jnp.int32) * 2
    quads = (packed.astype(jnp.int32)[:, :, None] >> shifts[None, None, :]) & 3
    return quads.reshape(packed.shape[0], -1)


def _unpack1(packed: jnp.ndarray, n: int) -> jnp.ndarray:
    shifts = jnp.arange(8, dtype=jnp.int32)
    bits = (packed.astype(jnp.int32)[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n]


def _unpack2_u8(packed: jnp.ndarray) -> jnp.ndarray:
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    quads = (packed[:, :, None] >> shifts[None, None, :]) & 3
    return quads.reshape(packed.shape[0], -1)


def _unpack1_u8(packed: jnp.ndarray) -> jnp.ndarray:
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(packed.shape[0], -1)


def bytes_to_words(packed: np.ndarray) -> np.ndarray:
    """HOST-side reinterpretation of a packed byte plane as uint32 words
    (little-endian: byte ``b`` -> bits ``8b``, so base ``16*w + j`` sits
    at bits ``2j`` of word ``w``).  The resident planes upload as words:
    gathering words instead of bytes quarters the gathered element count.
    uint32 so the expand's sub-word alignment shifts are logical."""
    pad = (-packed.shape[0]) % 4
    if pad:
        packed = np.concatenate([packed, np.zeros(pad, np.uint8)])
    return np.ascontiguousarray(packed).view(np.uint32)


def _aligned_words(g32: jnp.ndarray, word0, sb, nw: int):
    """Gather ``nw`` words per row starting at ``word0`` and funnel-shift
    each row right by ``sb`` bits (per-row, logical): output word ``i``
    holds bits ``[32*i + sb, 32*(i+1) + sb)`` of the row's word stream.
    The alignment runs on the (B, nw) WORDS — ~16x less elementwise work than
    selecting among per-code shifted copies of the decoded (B, r) rows.
    """
    idx = word0[:, None] + jnp.arange(nw + 1, dtype=word0.dtype)[None, :]
    idx = jnp.minimum(idx, g32.shape[0] - 1)  # tail rows are masked
    w = jnp.take(g32, idx, axis=0)  # (B, nw + 1) uint32
    sb = sb[:, None].astype(jnp.uint32)
    lo = w[:, :nw] >> sb
    # (32 - sb) & 31 keeps the shift defined at sb == 0; that case is
    # overridden by the where below
    hi = w[:, 1:] << ((jnp.uint32(32) - sb) & jnp.uint32(31))
    return jnp.where(sb == 0, w[:, :nw], lo | hi)


def _expand_resident(g32: jnp.ndarray, gstart: jnp.ndarray, r: int):
    """Device-side window expansion from the HBM-resident packed genome
    (uint32 words, :func:`bytes_to_words`): row i's codes are
    ``genome[gstart[i] : gstart[i] + r]``.  The genome crosses the
    host->device link ONCE per scan; each run then costs 4 bytes of
    descriptor instead of ``r/4`` bytes of sequence."""
    nw = (r + 15) // 16
    w = _aligned_words(g32, gstart // 16, (gstart % 16) * 2, nw)
    shifts = jnp.arange(16, dtype=jnp.uint32) * 2
    codes = ((w[:, :, None] >> shifts[None, None, :]) & 3).reshape(
        w.shape[0], -1
    )  # (B, nw * 16) uint32
    return jax.lax.slice(codes, (0, 0), (codes.shape[0], r)).astype(
        jnp.int32
    )


def _decode_span(
    g32: jnp.ndarray, lo, n_codes: int, bits: int
) -> jnp.ndarray:
    """Decode ``n_codes`` consecutive ``bits``-wide codes starting at
    element offset ``lo`` (a traced scalar) of the packed word plane —
    ONE dynamic slice + a scalar funnel shift + elementwise decode, no
    gather.  The word plane must carry >= 1 word of margin past the last
    read (``_resident_genome`` pads its planes)."""
    per = 32 // bits
    nw = (n_codes + per - 1) // per + 1
    w = jax.lax.dynamic_slice(g32, (lo // per,), (nw,))
    sb = ((lo % per) * bits).astype(jnp.uint32)
    shifted = (w[:-1] >> sb) | jnp.where(
        sb == 0, jnp.uint32(0), w[1:] << ((jnp.uint32(32) - sb) & 31)
    )
    shifts = jnp.arange(per, dtype=jnp.uint32) * bits
    mask = jnp.uint32((1 << bits) - 1)
    codes = ((shifted[:, None] >> shifts[None, :]) & mask).reshape(-1)
    return jax.lax.slice(codes, (0,), (n_codes,)).astype(jnp.int32)


def _expand_strided(
    g32: jnp.ndarray, lo, b: int, stride: int, r: int, bits: int
) -> jnp.ndarray:
    """Gather-free expansion for UNIFORMLY STRIDED rows: row ``i`` is
    ``genome[lo + i*stride : lo + i*stride + r]``.  Backbone chunks of a
    region step by exactly ``stride = r - k + 1``, so the dominant batch
    type needs one span decode + reshapes instead of a (B, r/16) word
    gather.  Requires ``stride <= r <= 2*stride``."""
    span = _decode_span(g32, lo, b * stride + r, bits)
    a = jax.lax.slice(span, (0,), (b * stride,)).reshape(b, stride)
    tail = jax.lax.slice(span, (stride,), (stride + b * stride,)).reshape(
        b, stride
    )
    return jnp.concatenate(
        [a, jax.lax.slice(tail, (0, 0), (b, r - stride))], axis=1
    )


@jax.jit
def onehot_genome(g32: jnp.ndarray) -> jnp.ndarray:
    """ONE-TIME device-side decode of the packed word genome into its
    ``(L, 4) bf16`` one-hot plane.  The per-dispatch expansion then
    becomes a dynamic slice + contiguous reshape feeding the conv
    directly — no word decode, no 2-bit interleave relayout, no one-hot
    build.  Cost: 8 bytes/base of HBM, paid once per scan per chromosome (the
    caller keeps at most one one-hot genome resident at a time)."""
    shifts = jnp.arange(16, dtype=jnp.uint32) * 2
    codes = ((g32[:, None] >> shifts[None, :]) & 3).reshape(-1)
    return (
        codes[:, None] == jnp.arange(4, dtype=jnp.uint32)[None, :]
    ).astype(jnp.bfloat16)


@jax.jit
def nplane_genome(n32: jnp.ndarray) -> jnp.ndarray:
    """One-time decode of the packed N-indicator words into an
    ``(L,) int8`` plane (companion of :func:`onehot_genome`)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return ((n32[:, None] >> shifts[None, :]) & 1).astype(jnp.int8).reshape(-1)


def _slice_strided_onehot(goh: jnp.ndarray, lo, b: int, stride: int, r: int):
    """(b, r, 4) one-hot rows for uniformly strided offsets, as one
    dynamic slice of the resident one-hot genome + contiguous reshapes
    (the `_expand_strided` overlap trick, lifted to the one-hot plane).
    Requires ``stride <= r <= 2*stride``."""
    span = jax.lax.dynamic_slice(
        goh, (lo, 0), (b * stride + r, 4)
    )
    a = jax.lax.slice(span, (0, 0), (b * stride, 4)).reshape(b, stride, 4)
    tail = jax.lax.slice(
        span, (stride, 0), (stride + b * stride, 4)
    ).reshape(b, stride, 4)
    return jnp.concatenate(
        [a, jax.lax.slice(tail, (0, 0, 0), (b, r - stride, 4))], axis=1
    )


def _slice_strided_plane(p8: jnp.ndarray, lo, b: int, stride: int, r: int):
    """Same overlap trick for a 1-D int8 per-base plane -> (b, r) int32."""
    span = jax.lax.dynamic_slice(p8, (lo,), (b * stride + r,))
    a = jax.lax.slice(span, (0,), (b * stride,)).reshape(b, stride)
    tail = jax.lax.slice(span, (stride,), (stride + b * stride,)).reshape(
        b, stride
    )
    return jnp.concatenate(
        [a, jax.lax.slice(tail, (0, 0), (b, r - stride))], axis=1
    ).astype(jnp.int32)


def _expand_resident_bits(g32: jnp.ndarray, gstart: jnp.ndarray, r: int):
    """Same word gather for the 1-bit-per-base N plane (uint32 words)."""
    nw = (r + 31) // 32
    w = _aligned_words(g32, gstart // 32, gstart % 32, nw)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((w[:, :, None] >> shifts[None, None, :]) & 1).reshape(
        w.shape[0], -1
    )  # (B, nw * 32) uint32
    return jax.lax.slice(bits, (0, 0), (bits.shape[0], r)).astype(
        jnp.int32
    )


def _exact_hist(scores: jnp.ndarray, hist_size: int) -> jnp.ndarray:
    """Exact integer score histogram ``(hist_size, M) int32`` of
    ``(B, Noff, M)`` scores: one int32 scatter-add over the flattened
    ``(column, bin)`` index.  Invalid windows (score -1) and anything
    outside ``[0, hist_size)`` count into a per-column spill bin that is
    dropped.  Integer adds are exact in any order, so the atomics XLA
    emits for the scatter give the same counts on every run and every
    backend.  On an H100 this replaced a one-hot einsum formulation at
    a fraction of its time (PERF.md, "Findings")."""
    m = scores.shape[-1]
    v = scores.reshape(-1, m)
    v = jnp.where((v >= 0) & (v < hist_size), v, jnp.int32(hist_size))
    idx = v + jnp.arange(m, dtype=jnp.int32)[None, :] * (hist_size + 1)
    counts = (
        jnp.zeros((m * (hist_size + 1),), jnp.int32)
        .at[idx.reshape(-1)]
        .add(1)
    )
    return counts.reshape(m, hist_size + 1)[:, :hist_size].T


def _scan_core(
    packed, nbits, vbits, pwm_kernel, min_scores, cutoffs, k: int,
    hist_size: int, hist_bases=None,
):
    """``nbits``/``vbits`` may be ``None`` (static, trace-time): a clean
    batch (no N bases / every offset valid) then skips the mask upload
    and the masking arithmetic entirely — in production scans most
    batches are clean and this trims ~40% off the host->device bytes."""
    r = packed.shape[1] * 4
    codes = _unpack2(packed)  # (B, R)
    n_ind = _unpack1(nbits, r) if nbits is not None else None
    return _score_codes(
        codes, n_ind, vbits, pwm_kernel, min_scores, cutoffs, k, hist_size,
        hist_bases=hist_bases,
    )


# motif-column count at or below which the window contraction runs as the
# select/LUT formulation instead of the conv.  Default 0 (always conv).
# Measured on an H100 (700 W) at B=2048, R=2048, k=19, the whole
# resident kernel: m=2 select 1.16 ms vs conv 1.56 ms, m=24 select
# 7.42 ms vs conv 3.44 ms (PERF.md, "Findings").  A crossover default is
# for a PR that measures it end to end: GRAFIMO_SELECT_CONV_MAX_M.
SELECT_CONV_MAX_M = int(__import__("os").environ.get(
    "GRAFIMO_SELECT_CONV_MAX_M", "0"
))


def _window_scores(codes, pwm_kernel, k: int) -> jnp.ndarray:
    """Integer scores of every stride-1 window: ``(B, R) codes`` x
    ``(k, 4, M) pwm -> (B, Noff, M) int32``, exact.

    Two formulations, picked by M (static):

    * **select/LUT (M <= SELECT_CONV_MAX_M)** — ``sum_j select_n(
      codes[:, j:j+Noff], K[j,0,:], .., K[j,3,:])``: k shifted
      elementwise 4-way selects accumulated in int32.  Exact in int32
      directly — no bf16 split needed.
    * **conv (M > SELECT_CONV_MAX_M)** — one-hot codes convolved
      with the PWM stack split into two bf16-exact planes (entries in
      [0, 1020]: hi = 4*floor(v/4) and lo = v mod 4 are both exactly
      representable in bf16; f32 accumulation makes the sum bit-exact,
      every partial sum being an integer below 2^24).  Neither operand
      is f32, so no TF32 rounding can enter.  At JASPAR-scale M the
      matrix unit amortises over M where the selects cost k*M*4 per
      window.
    """
    b, r = codes.shape
    noff = r - k + 1
    m_cols = pwm_kernel.shape[-1]
    if m_cols <= SELECT_CONV_MAX_M:
        pwm_i = pwm_kernel.astype(jnp.int32)  # (k, 4, M)
        acc = jnp.zeros((b, noff, m_cols), jnp.int32)
        for j in range(k):
            sl = jax.lax.slice(codes, (0, j), (b, j + noff))  # (B, Noff)
            sel = jnp.broadcast_to(sl[:, :, None], (b, noff, m_cols))
            cases = [
                jnp.broadcast_to(
                    pwm_i[j, c][None, None, :], (b, noff, m_cols)
                )
                for c in range(4)
            ]
            acc = acc + jax.lax.select_n(sel, *cases)
        return acc
    onehot = (
        codes[:, :, None] == jnp.arange(4, dtype=jnp.int32)[None, None, :]
    ).astype(jnp.bfloat16)
    return _conv_onehot(onehot, pwm_kernel)


def _conv_onehot(onehot: jnp.ndarray, pwm_kernel) -> jnp.ndarray:
    """The exact conv over an already one-hot ``(B, R, 4)`` bf16
    input (see :func:`_window_scores` for the bf16-exact plane split)."""
    m_cols = pwm_kernel.shape[-1]
    k_hi = jnp.floor(pwm_kernel / 4) * 4
    k_lo = pwm_kernel - k_hi
    split = jnp.concatenate([k_hi, k_lo], axis=-1).astype(jnp.bfloat16)
    both = jax.lax.conv_general_dilated(
        onehot,
        split,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.float32,
    )  # (B, Noff, 2M) f32-exact partial sums
    return (both[:, :, :m_cols] + both[:, :, m_cols:]).astype(jnp.int32)


def _score_codes(
    codes, n_ind, vbits, pwm_kernel, min_scores, cutoffs, k: int,
    hist_size: int, hist_bases=None,
):
    scores = _window_scores(codes, pwm_kernel, k)  # (B, Noff, M) int32
    return _finish_scores(
        scores, n_ind, vbits, min_scores, cutoffs, k, hist_size,
        hist_bases=hist_bases,
    )


def _finish_scores(
    scores, n_ind, vbits, min_scores, cutoffs, k: int, hist_size: int,
    hist_bases=None,
):
    """Masking + histogram + hit packing over raw window scores (shared
    by the codes and resident-one-hot front-ends)."""
    b, noff, m = scores.shape
    if n_ind is not None:
        # N-window detection via cumulative sums of the N indicator
        cum = jnp.concatenate(
            [jnp.zeros((b, 1), jnp.int32), jnp.cumsum(n_ind, axis=1)],
            axis=1,
        )
        has_n = (cum[:, k:] - cum[:, :-k]) > 0  # (B, Noff)
        scores = jnp.where(
            has_n[:, :, None], min_scores[None, None, :], scores
        )
    if vbits is not None:
        valid = _unpack1(vbits, noff).astype(bool)  # (B, Noff)
        scores = jnp.where(valid[:, :, None], scores, jnp.int32(-1))
    if hist_bases is not None:
        # Per-column histogram COMPRESSION (exact): real window scores
        # of column m can only fall in [base_m, top_m] with base_m =
        # sum_j min_nuc pwm[j,:,m] — typically ~40-50% of the full
        # [0, RANGE*k] span — so the histogram's bins shrink
        # proportionally.
        # Device bins: 0 = the N-window replacement value min_scores[m]
        # (the only possible sub-base score), 1+i = score base_m + i,
        # invalid stays -1 (kernel spill).  The host expands bins back
        # to absolute scores at each flush (runscan._flush) — a linear
        # remap, exact and psum-compatible.
        h = jnp.where(
            scores < 0,
            jnp.int32(-1),
            jnp.maximum(scores - hist_bases[None, None, :] + 1, 0),
        )
    else:
        h = scores
    hist = _exact_hist(h, hist_size)
    # packed hit bits
    hit = (scores >= cutoffs[None, None, :]) & (scores >= 0)
    pad = (-noff) % 8
    hit = jnp.pad(hit, ((0, 0), (0, pad), (0, 0)))
    hit = hit.reshape(b, -1, 8, m).astype(jnp.uint8)
    weights = (1 << jnp.arange(8, dtype=jnp.uint8))[None, None, :, None]
    hitbits = jnp.sum(hit * weights, axis=2).astype(jnp.uint8)
    return hist, hitbits


@partial(jax.jit, static_argnames=("k", "hist_size"))
def scan_runs_device(
    packed, nbits, vbits, pwm_kernel, min_scores, cutoffs, k: int,
    hist_size: int, hist_bases=None,
):
    """Scan a padded run batch.

    Returns ``(hist (hist_size, M) int32, hitbits (B, ceil(Noff/8), M)
    uint8)``.  With ``hist_bases`` (an ``(M,)`` int32 of per-column
    window-score minima) the histogram is per-column COMPRESSED — see
    :func:`_score_codes`; ``hist_size`` is then the compressed size
    ``max_m(top_m - base_m) + 2``.
    """
    return _scan_core(
        packed, nbits, vbits, pwm_kernel, min_scores, cutoffs, k,
        hist_size, hist_bases=hist_bases,
    )


@partial(
    jax.jit, static_argnames=("k", "hist_size", "topk"), donate_argnums=(0,)
)
def scan_runs_device_topk(
    hist_acc, packed, nbits, vbits, pwm_kernel, min_scores, cutoffs,
    k: int, hist_size: int, topk: int, hist_bases=None,
):
    """Accumulating scan with on-device hit compaction.

    Hits are returned as the ``topk`` largest flat indices of the masked
    score tensor — a few KB on the wire instead of the full hit bitmask.
    When a slice holds more than ``topk`` hits (``n_hits`` says so), the
    caller falls back to fetching ``hitbits``.  Flat index layout is
    C-order over ``(row, offset, motif)``.
    """
    hist, hitbits = _scan_core(
        packed, nbits, vbits, pwm_kernel, min_scores, cutoffs, k,
        hist_size, hist_bases=hist_bases,
    )
    noff = packed.shape[1] * 4 - k + 1
    return _topk_package(
        hist_acc, hist, hitbits, noff, pwm_kernel.shape[-1], topk
    )


# per-row hit-slot capacity for the two-level compaction below: a row
# (one run x all offsets x all motif columns) holding more than this many
# hits forces the exact bitmask fallback for its slice.  32 covers dense
# real-site clusters (a strong CTCF site lights up ~10 consecutive
# windows x 2 strands); random-sequence slices at p<1e-4 average << 1.
_ROW_SLOTS = 32


def _topk_package(hist_acc, hist, hitbits, noff: int, m: int, topk: int):
    """On-device hit compaction — dispatches between the byte-tiered
    production formulation (:func:`_topk_package_tiered`) and the flat
    bit-space reference (:func:`_topk_package_flat`), which are
    differentially pinned bit-identical (tests/test_runscan.py).
    ``GRAFIMO_PACKAGE=flat`` selects the reference at trace time.  On an
    H100 (700 W, B=2048, R=2048, k=19, whole resident kernel) tiered
    took 1.49 ms vs flat 1.66 ms at m=2 and 3.33 vs 4.87 ms at m=24
    (PERF.md, "Findings")."""
    import os

    if os.environ.get("GRAFIMO_PACKAGE", "tiered") == "flat":
        return _topk_package_flat(hist_acc, hist, hitbits, noff, m, topk)
    return _topk_package_tiered(hist_acc, hist, hitbits, noff, m, topk)


def _topk_package_flat(
    hist_acc, hist, hitbits, noff: int, m: int, topk: int
):
    """Two-level on-device hit compaction (flat bit-space REFERENCE —
    every rank/extraction pass runs over all ``B*Noff*M`` window
    predicates; see :func:`_topk_package_tiered` for the production
    variant that runs them over packed bytes instead).

    The naive formulation (1-D cumsum + scatter over all B*Noff*M window
    predicates) runs giant 1-D scans and scatters.  Instead:

    1. per ROW (2-D, row-parallel, elementwise): within-row hit ranks
       via ``cumsum(axis=1)``, then ``_ROW_SLOTS`` fused masked
       reductions extract each row's first hits' flat indices;
    2. across rows: a scatter over only ``B*_ROW_SLOTS`` candidate slots
       places them at their global positions (exclusive prefix of row
       counts) — 3 orders of magnitude fewer scatter updates.

    Rows with more than ``_ROW_SLOTS`` hits (or slices with more than
    ``topk``) report ``n_hits > topk`` so the caller takes the exact
    bitmask fallback.  Hit indices come out ascending (deterministic);
    0 = empty slot, values are flat index + 1.
    """
    b = hitbits.shape[0]
    # rebuild the hit predicate from the packed bits (cheap elementwise)
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (hitbits[:, :, None, :] >> shifts[None, None, :, None]) & 1
    bits = bits.reshape(b, -1, m)[:, :noff, :]
    c = noff * m
    pred = bits.reshape(b, c).astype(jnp.int32)  # (B, C) 0/1
    cnt = pred.sum(axis=1)  # (B,) hits per row
    k_slots = min(topk, b * _ROW_SLOTS)

    def _extract(args):
        # within-row ranks + slot extraction + candidate scatter: the
        # expensive stages (one cumsum + _ROW_SLOTS fused reductions
        # over (B, C)) — only executed when the slice has hits at all.
        # In production scans nearly every slice is hitless (p < 1e-4),
        # so the lax.cond skips ~all of the packaging cost (a
        # conditional executes only the taken branch).
        pred, cnt = args
        rank = jnp.cumsum(pred, axis=1)  # within-row rank (1-based)
        base = jnp.cumsum(cnt) - cnt  # exclusive prefix: global position
        iota_c = jax.lax.broadcasted_iota(jnp.int32, (b, c), 1)
        gidx = (
            jax.lax.broadcasted_iota(jnp.int32, (b, c), 0) * c + iota_c + 1
        )  # flat window index + 1 (C-order over row, offset, motif)
        slot_cols = [
            jnp.sum(
                jnp.where((rank == (s + 1)) & (pred > 0), gidx, 0), axis=1
            )
            for s in range(_ROW_SLOTS)
        ]  # XLA fuses these sibling reductions into one pass over (B, C)
        slot_mat = jnp.stack(slot_cols, axis=1)  # (B, S)
        srange = jnp.arange(_ROW_SLOTS, dtype=jnp.int32)
        valid = srange[None, :] < jnp.minimum(cnt, _ROW_SLOTS)[:, None]
        tgt = jnp.where(
            valid,
            jnp.minimum(base[:, None] + srange[None, :], k_slots - 1),
            k_slots,
        )
        return (
            jnp.zeros((k_slots,), jnp.int32)
            .at[tgt.reshape(-1)]
            .max(slot_mat.reshape(-1), mode="drop")
        )

    n_hits = cnt.sum().astype(jnp.int32)
    top_vals = jax.lax.cond(
        n_hits > 0,
        _extract,
        lambda args: jnp.zeros((k_slots,), jnp.int32),
        (pred, cnt),
    )
    # a row overflowing its slots invalidates the compacted list even
    # when n_hits <= topk: report past topk to force the bitmask tier
    n_hits = jnp.where(
        (cnt > _ROW_SLOTS).any(), jnp.maximum(n_hits, topk + 1), n_hits
    )
    return (
        hist_acc + hist.astype(hist_acc.dtype), hitbits, n_hits,
        top_vals,  # hit flat indices + 1, ascending; 0 = empty slot
    )


def _topk_package_tiered(
    hist_acc, hist, hitbits, noff: int, m: int, topk: int
):
    """Byte-tiered hit compaction — same contract and bit-identical
    outputs as :func:`_topk_package_flat`, with the heavy rank passes
    run over the PACKED hit bytes instead of unpacked window bits.

    The flat formulation's cost is two passes (cumsum ranks + the fused
    ``_ROW_SLOTS`` masked extractions) over the full ``(B, Noff*M)`` bit
    predicate — 8.3 M int32 elements per production dispatch, plus the
    bit-unpack that materialises them.  But the same information lives
    in ``hitbits`` at 1/8 the elements, and a row can hold at most
    ``_ROW_SLOTS`` compactable hits, which necessarily sit inside its
    first ``_ROW_SLOTS`` NONZERO BYTES.  So:

    1. byte tier, ``(B, ceil(Noff/8)*M)``: per-row nonzero-byte ranks
       (cumsum) + ``_ROW_SLOTS`` masked reductions extract each row's
       first hit bytes, position and value packed in one int32
       (``(q+1) << 8 | byte``) so one reduction set suffices;
    2. bit tier, ``(B, _ROW_SLOTS*8)``: the extracted bytes expand to
       their candidate window flat-indices elementwise.  Candidate
       enumeration order is ``(offset_byte, motif, bit)`` which is NOT
       ascending in flat ``(offset, motif)`` order for m > 1, so a
       per-row ``jnp.sort`` over the 256 candidates (invalid = int32
       max) restores the contract's ascending order — trivially cheap
       at this width;
    3. the across-rows scatter is unchanged.

    Hit COUNTS (``cnt``/``n_hits``/the overflow flag) come from
    ``population_count`` of the bytes, so the capacity rule (a row with
    more than ``_ROW_SLOTS`` hit BITS forces the bitmask tier) is
    exactly the flat rule.
    """
    b = hitbits.shape[0]
    q = hitbits.shape[1] * m  # bytes per row, (offset_byte, motif) C-order
    bytes2d = hitbits.reshape(b, q)
    cnt = jnp.sum(
        jax.lax.population_count(bytes2d).astype(jnp.int32), axis=1
    )  # (B,) hit bits per row — identical to the flat pred.sum()
    k_slots = min(topk, b * _ROW_SLOTS)
    sentinel = jnp.int32(np.iinfo(np.int32).max)

    def _extract(args):
        bytes2d, cnt = args
        nz = (bytes2d > 0).astype(jnp.int32)
        brank = jnp.cumsum(nz, axis=1)  # nonzero-byte rank (1-based)
        qi = jax.lax.broadcasted_iota(jnp.int32, (b, q), 1)
        enc = ((qi + 1) << 8) | bytes2d.astype(jnp.int32)
        slot_cols = [
            jnp.sum(
                jnp.where((brank == (s + 1)) & (nz > 0), enc, 0), axis=1
            )
            for s in range(_ROW_SLOTS)
        ]  # fused: one pass over (B, Q) — Q is Noff*M/8
        slot_enc = jnp.stack(slot_cols, axis=1)  # (B, S)
        # bit tier: expand each extracted byte to its 8 candidate hits
        bq = (slot_enc >> 8) - 1  # byte position in (offset_byte, motif)
        val = slot_enc & 255
        bits = (val[:, :, None] >> jnp.arange(8, dtype=jnp.int32)) & 1
        o8 = bq // m
        mi = bq - o8 * m
        off = o8[:, :, None] * 8 + jnp.arange(8, dtype=jnp.int32)
        rows = jax.lax.broadcasted_iota(
            jnp.int32, (b, _ROW_SLOTS, 8), 0
        )
        gidx = (rows * noff + off) * m + mi[:, :, None] + 1
        valid = (slot_enc[:, :, None] > 0) & (bits > 0) & (off < noff)
        cand = jnp.where(valid, gidx, sentinel).reshape(b, _ROW_SLOTS * 8)
        cand = jnp.sort(cand, axis=1)[:, :_ROW_SLOTS]  # ascending hits
        srange = jnp.arange(_ROW_SLOTS, dtype=jnp.int32)
        vslot = srange[None, :] < jnp.minimum(cnt, _ROW_SLOTS)[:, None]
        slot_mat = jnp.where(vslot, cand, 0)
        base = jnp.cumsum(cnt) - cnt  # exclusive prefix: global position
        tgt = jnp.where(
            vslot,
            jnp.minimum(base[:, None] + srange[None, :], k_slots - 1),
            k_slots,
        )
        return (
            jnp.zeros((k_slots,), jnp.int32)
            .at[tgt.reshape(-1)]
            .max(slot_mat.reshape(-1), mode="drop")
        )

    n_hits = cnt.sum().astype(jnp.int32)
    top_vals = jax.lax.cond(
        n_hits > 0,
        _extract,
        lambda args: jnp.zeros((k_slots,), jnp.int32),
        (bytes2d, cnt),
    )
    n_hits = jnp.where(
        (cnt > _ROW_SLOTS).any(), jnp.maximum(n_hits, topk + 1), n_hits
    )
    return (
        hist_acc + hist.astype(hist_acc.dtype), hitbits, n_hits,
        top_vals,
    )


@partial(
    jax.jit,
    static_argnames=("r", "k", "hist_size", "topk"),
    donate_argnums=(0,),
)
def scan_runs_resident_topk(
    hist_acc, genome4, ngenome, gstart, vbits, pwm_kernel, min_scores,
    cutoffs, r: int, k: int, hist_size: int, topk: int, hist_bases=None,
):
    """Device-resident variant of :func:`scan_runs_device_topk`: rows are
    expanded on device from the HBM-resident packed genome (``genome4``,
    uploaded once per scan) at per-row genome offsets ``gstart`` — each
    backbone run crosses the link as a 4-byte descriptor instead of
    ``r/4`` sequence bytes (roadmap: device-resident graphs).
    ``ngenome`` (packed N plane) and ``vbits`` may be None."""
    codes = _expand_resident(genome4, gstart, r)
    n_ind = (
        _expand_resident_bits(ngenome, gstart, r)
        if ngenome is not None
        else None
    )
    hist, hitbits = _score_codes(
        codes, n_ind, vbits, pwm_kernel, min_scores, cutoffs, k,
        hist_size, hist_bases=hist_bases,
    )
    return _topk_package(
        hist_acc, hist, hitbits, r - k + 1, pwm_kernel.shape[-1], topk
    )


@partial(
    jax.jit,
    static_argnames=("b", "stride", "r", "k", "hist_size", "topk"),
    donate_argnums=(0,),
)
def scan_runs_resident_strided_topk(
    hist_acc, genome4, ngenome, lo, vbits, pwm_kernel, min_scores,
    cutoffs, b: int, stride: int, r: int, k: int, hist_size: int,
    topk: int, hist_bases=None,
):
    """:func:`scan_runs_resident_topk` for UNIFORMLY STRIDED rows (row i
    at genome offset ``lo + i*stride``) — the shape of every backbone
    chunk sequence within one region.  Expansion is one span decode +
    reshapes (:func:`_expand_strided`); the (B, r/16) word gather, the
    expansion's measured bound, disappears.  ``lo`` is a traced scalar;
    the genome planes need the ``_resident_genome`` margin padding."""
    codes = _expand_strided(genome4, lo, b, stride, r, 2)
    n_ind = (
        _expand_strided(ngenome, lo, b, stride, r, 1)
        if ngenome is not None
        else None
    )
    hist, hitbits = _score_codes(
        codes, n_ind, vbits, pwm_kernel, min_scores, cutoffs, k,
        hist_size, hist_bases=hist_bases,
    )
    return _topk_package(
        hist_acc, hist, hitbits, r - k + 1, pwm_kernel.shape[-1], topk
    )


@partial(
    jax.jit,
    static_argnames=("b", "stride", "r", "k", "hist_size", "topk"),
    donate_argnums=(0,),
)
def scan_runs_resident_onehot_topk(
    hist_acc, goh, gn8, lo, vbits, pwm_kernel, min_scores,
    cutoffs, b: int, stride: int, r: int, k: int, hist_size: int,
    topk: int, hist_bases=None,
):
    """:func:`scan_runs_resident_strided_topk` over the RESIDENT ONE-HOT
    genome (:func:`onehot_genome`, built on device once per chromosome):
    the expansion is a dynamic slice + contiguous reshapes feeding the
    conv directly — the per-dispatch word decode, 2-bit interleave
    relayout and one-hot build all disappear.  On an H100 (700 W, B=2048,
    R=2048, k=19) it took 1.64 ms vs 1.56 ms for the word kernel at m=2
    and 3.30 vs 3.49 ms at m=24 (PERF.md, "Findings").  Device memory
    cost: 8 bytes/base + 1 byte/base N plane, one chromosome resident at
    a time."""
    onehot = _slice_strided_onehot(goh, lo, b, stride, r)
    n_ind = (
        _slice_strided_plane(gn8, lo, b, stride, r)
        if gn8 is not None
        else None
    )
    scores = _conv_onehot(onehot, pwm_kernel)
    hist, hitbits = _finish_scores(
        scores, n_ind, vbits, min_scores, cutoffs, k, hist_size,
        hist_bases=hist_bases,
    )
    return _topk_package(
        hist_acc, hist, hitbits, r - k + 1, pwm_kernel.shape[-1], topk
    )


def _apply_patches(codes: jnp.ndarray, patches: jnp.ndarray) -> jnp.ndarray:
    """Apply per-row substitution patches to expanded genome rows.

    ``patches (B, P) int16``: ``pos * 4 + base`` per entry, ``-1`` = empty
    slot.  Pure elementwise selects (one ``(B, r)`` compare per patch
    slot) — no scatter.
    """
    r = codes.shape[1]
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, r), 1)
    p32 = patches.astype(jnp.int32)
    for p in range(patches.shape[1]):
        ent = p32[:, p : p + 1]  # (B, 1)
        pos = ent >> 2
        base = (ent & 3).astype(codes.dtype)
        codes = jnp.where((iota == pos) & (ent >= 0), base, codes)
    return codes


@partial(
    jax.jit,
    static_argnames=("r", "k", "hist_size", "topk"),
    donate_argnums=(0,),
)
def scan_runs_resident_patched_topk(
    hist_acc, genome4, ngenome, gstart, patches, vbits, pwm_kernel,
    min_scores, cutoffs, r: int, k: int, hist_size: int, topk: int,
    hist_bases=None,
):
    """Resident scan of CLUSTER combination runs that differ from the
    reference genome only by substitutions: each row crosses the link as
    a 4-byte genome offset plus ``P`` 2-byte patch descriptors instead of
    ``r/4`` sequence bytes (roadmap: device-resident cluster runs —
    combination runs share the genome backbone, only their substituted
    bases ride the wire)."""
    codes = _apply_patches(_expand_resident(genome4, gstart, r), patches)
    n_ind = (
        _expand_resident_bits(ngenome, gstart, r)
        if ngenome is not None
        else None
    )
    hist, hitbits = _score_codes(
        codes, n_ind, vbits, pwm_kernel, min_scores, cutoffs, k,
        hist_size, hist_bases=hist_bases,
    )
    return _topk_package(
        hist_acc, hist, hitbits, r - k + 1, pwm_kernel.shape[-1], topk
    )


def _clear_at_patches(plane: jnp.ndarray, patches: jnp.ndarray):
    """Zero a per-base indicator plane at every patched offset (patched
    bases are ACGT by contract, so their N indicator must drop even when
    the underlying spliced genome position was N)."""
    r = plane.shape[1]
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, r), 1)
    p32 = patches.astype(jnp.int32)
    for p in range(patches.shape[1]):
        ent = p32[:, p : p + 1]
        plane = jnp.where((iota == (ent >> 2)) & (ent >= 0),
                          jnp.zeros((), plane.dtype), plane)
    return plane


@partial(
    jax.jit,
    static_argnames=("r", "k", "hist_size", "topk"),
    donate_argnums=(0,),
)
def scan_runs_resident_spliced_topk(
    hist_acc, genome4, ngenome, gstart, splice, patches, vbits, pwm_kernel,
    min_scores, cutoffs, r: int, k: int, hist_size: int, topk: int,
    hist_bases=None,
):
    """Resident scan of CLUSTER combination runs containing INDELS: each
    row is the genome spliced piecewise — row ``i`` starts as
    ``genome[gstart[i] : gstart[i] + r]`` and, at each splice entry
    ``(bound, shift)`` (``splice (B, 2*S) int16``, bound ``0x7fff`` =
    unused), switches to ``genome[gstart[i] + shift + j]`` for offsets
    ``j >= bound`` — then per-row patches overwrite inserted/substituted
    bases.  Wire cost: 4B offset + 4B per splice entry + 2B per patch
    slot instead of ``r/4`` packed bytes (indel-combination residency).

    Expansion stays word gathers + per-position selects — no
    per-element gathers; device cost is ``S+1`` backbone expansions over
    the spliced rows only.
    """
    codes = _expand_resident(genome4, gstart, r)
    n_ind = (
        _expand_resident_bits(ngenome, gstart, r)
        if ngenome is not None
        else None
    )
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, r), 1)
    s32 = splice.astype(jnp.int32)
    for s in range(splice.shape[1] // 2):
        bound = s32[:, 2 * s : 2 * s + 1]  # (B, 1)
        shift = jnp.where(
            bound == 0x7FFF, 0, s32[:, 2 * s + 1 : 2 * s + 2]
        )
        sel = iota >= bound
        plane = _expand_resident(genome4, gstart + shift[:, 0], r)
        codes = jnp.where(sel, plane, codes)
        if n_ind is not None:
            nplane = _expand_resident_bits(
                ngenome, gstart + shift[:, 0], r
            )
            n_ind = jnp.where(sel, nplane, n_ind)
    codes = _apply_patches(codes, patches)
    if n_ind is not None:
        n_ind = _clear_at_patches(n_ind, patches)
    hist, hitbits = _score_codes(
        codes, n_ind, vbits, pwm_kernel, min_scores, cutoffs, k,
        hist_size, hist_bases=hist_bases,
    )
    return _topk_package(
        hist_acc, hist, hitbits, r - k + 1, pwm_kernel.shape[-1], topk
    )


@partial(jax.jit, donate_argnums=(0, 1))
def absorb_slice(nh_acc, top_acc, n_hits, top_vals, i):
    """Record one scan slice's results into the donated per-block
    accumulators at row ``i``: its hit count and the first ``SMALLK``
    (= ``top_acc.shape[1]``) compacted hit flat-indices.

    A tiny device-side dispatch per slice so the host can fetch an entire
    block of slice results in ONE device->host transfer
    (:func:`package_block`) instead of synchronising with the device on
    every slice.
    """
    smallk = top_acc.shape[1]
    t = top_vals[:smallk]
    if t.shape[0] < smallk:
        t = jnp.pad(t, (0, smallk - t.shape[0]))
    nh_acc = jax.lax.dynamic_update_index_in_dim(nh_acc, n_hits, i, 0)
    top_acc = jax.lax.dynamic_update_slice(top_acc, t[None, :], (i, 0))
    return nh_acc, top_acc


@partial(jax.jit, static_argnames=("n",))
def package_block(hist_acc, nh_acc, top_acc, n: int):
    """Bundle one flush block — histogram accumulator + the first ``n``
    rows of the slice accumulators — into a single flat int32 array, so
    the host pays ONE device->host round trip per block instead of three
    (histogram, hit counts, hit indices).  ``n`` is static: callers round
    the live slice count up to a power of two to bound recompiles."""
    parts = [hist_acc.reshape(-1)]
    if n:
        parts.append(nh_acc[:n])
        parts.append(top_acc[:n].reshape(-1))
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


@partial(jax.jit, static_argnames=("k", "hist_size"), donate_argnums=(0,))
def scan_runs_device_acc(
    hist_acc, packed, nbits, vbits, pwm_kernel, min_scores, cutoffs,
    k: int, hist_size: int, hist_bases=None,
):
    """Accumulating variant: adds this batch's histogram into the donated
    device-resident accumulator and also returns the batch hit count, so
    the host can skip fetching hit bits for hitless batches — in a
    production scan almost every batch is hitless and nothing but a
    scalar crosses the device->host link per batch (the histogram is
    fetched once per scan)."""
    hist, hitbits = _scan_core(
        packed, nbits, vbits, pwm_kernel, min_scores, cutoffs, k,
        hist_size, hist_bases=hist_bases,
    )
    # popcount of the packed hit bits = number of hits in this batch
    n_hits = jnp.sum(
        jax.lax.population_count(hitbits.astype(jnp.uint32))
    ).astype(jnp.int32)
    return hist_acc + hist.astype(hist_acc.dtype), hitbits, n_hits


def unpack_hitbits(hitbits: np.ndarray, noff: int) -> np.ndarray:
    """Host-side ``(B, ceil(Noff/8), M) -> (B, Noff, M)`` bool."""
    b, _, m = hitbits.shape
    bits = np.unpackbits(
        np.moveaxis(hitbits, 1, 2).reshape(b * m, -1),
        axis=1,
        bitorder="little",
    )[:, :noff]
    return np.moveaxis(bits.reshape(b, m, noff), 2, 1).astype(bool)
