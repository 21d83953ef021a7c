"""Benjamini-Hochberg FDR correction, exact and histogram-based.

The reference calls ``statsmodels.stats.multitest.multipletests(pvalues,
method="fdr_bh")`` over the full per-motif p-value list
(``score_sequences.py:401-430``).  :func:`fdr_bh` replicates statsmodels'
operation order bit-for-bit; :func:`qvalues_from_histogram` produces the
*same float64 values* from the integer score histogram alone, which is the
accelerator formulation: histograms are small, additive across devices (psum),
and make exact global q-values possible without gathering per-window
p-values (SURVEY.md §5.8).
"""

from typing import Callable, Dict

import numpy as np


def fdr_bh(pvalues: np.ndarray) -> np.ndarray:
    """statsmodels-parity BH correction.

    Replicated ops (statsmodels ``multipletests``, method ``fdr_bh``):
    ``ecdffactor = arange(1, n+1)/n``; ``raw = p_sorted/ecdffactor``;
    backward ``minimum.accumulate``; clip at 1; unsort.
    """
    pvals = np.asarray(pvalues, dtype=np.float64)
    n = len(pvals)
    if n == 0:
        return pvals.copy()
    sortind = np.argsort(pvals, kind="quicksort")
    pvals_sorted = pvals[sortind]
    ecdffactor = np.arange(1, n + 1) / float(n)
    raw = pvals_sorted / ecdffactor
    corrected = np.minimum.accumulate(raw[::-1])[::-1].copy()
    corrected[corrected > 1] = 1
    out = np.empty(n, dtype=np.float64)
    out[sortind] = corrected
    return out


def qvalues_from_histogram(
    hist: np.ndarray, pvalue_of_score: Callable[[np.ndarray], np.ndarray]
) -> Dict[int, float]:
    """Exact BH q-value per integer score bin from a score histogram.

    Parameters
    ----------
    hist: int histogram over scores ``0..L-1`` of ALL scanned windows.
    pvalue_of_score: maps an int64 score array to float64 p-values
        (non-increasing in score).

    Returns a dict ``score -> qvalue`` for every occupied bin.

    Why this equals statsmodels exactly: sort windows by ascending p-value
    (= descending score).  Within a tie block of equal p the raw value
    ``p / (rank/n)`` is minimised at the block's **last** index, and BH's
    backward ``minimum.accumulate`` therefore assigns the whole block
    ``min`` over blocks of ``p_b / (rank_last_b / n)``.  Both the division
    order (rank/n first) and the min/clip are reproduced, so each float64
    op matches.
    """
    hist = np.asarray(hist)
    occupied = np.nonzero(hist)[0]
    if occupied.size == 0:
        return {}
    counts = hist[occupied].astype(np.int64)
    # ascending p == descending score
    order = np.argsort(-occupied, kind="stable")
    scores_desc = occupied[order]
    counts_desc = counts[order]
    p_asc = pvalue_of_score(scores_desc.astype(np.int64))
    # merge adjacent bins with identical float p (zero-mass gaps between
    # scores make distinct scores share a p-value; statsmodels treats them
    # as one tie block)
    blocks = []  # (pvalue, count)
    for p, c in zip(p_asc.tolist(), counts_desc.tolist()):
        if blocks and blocks[-1][0] == p:
            blocks[-1][1] += c
        else:
            blocks.append([p, c])
    block_p = np.array([b[0] for b in blocks], dtype=np.float64)
    block_c = np.array([b[1] for b in blocks], dtype=np.int64)
    n = int(block_c.sum())
    rank_last = np.cumsum(block_c)
    ecdf = rank_last / float(n)
    raw = block_p / ecdf
    corrected = np.minimum.accumulate(raw[::-1])[::-1].copy()
    corrected[corrected > 1] = 1
    # expand back to per-score q
    out: Dict[int, float] = {}
    bi = 0
    for s, p in zip(scores_desc.tolist(), p_asc.tolist()):
        while blocks[bi][0] != p:
            bi += 1
        out[int(s)] = float(corrected[bi])
    return out
