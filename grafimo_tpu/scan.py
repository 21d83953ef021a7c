"""Scan orchestration: score window batches, assign p/q-values, assemble the
results table.

Reference equivalent: ``compute_results`` + ``score_seqs``
(``score_sequences.py:44-328``) and ``ResultTmp.to_df``
(``resultsTmp.py:241-314``).  Differences by design:

* scoring is one batched device contraction per chunk instead of a python
  loop per window (``ops/score_jax.py``);
* p-values come from a lazy per-distinct-score lookup into the Staden table
  with the reference's summation order (``models/pvalue.py``);
* q-values are derived from the exact integer score histogram
  (``ops/qvalue.py``) — additive across chips/hosts — and are float64-equal
  to statsmodels' BH over the raw p-value list.
"""

import time
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from grafimo_tpu.models.motif import Motif
from grafimo_tpu.models.pvalue import PvalueLookup
from grafimo_tpu.ops.qvalue import qvalues_from_histogram
from grafimo_tpu.ops.score_jax import (
    hist_size_for_width,
    pwms_to_flat,
    score_and_histogram,
)
from grafimo_tpu.report.results import (
    ResultTable,
    apply_report_filters,
    build_results_df,
)
from grafimo_tpu.windows import WindowBatch

# device-batch granularity: windows are scored in chunks of this many rows
# (bounds device memory; large enough to fill the device)
CHUNK = 1 << 18


@dataclass
class ScanStats:
    seqs_scanned: int = 0
    nucs_scanned: int = 0
    scoring_time: float = 0.0


def compute_results(
    motif: Motif,
    batches: Iterable[WindowBatch],
    threshold: float = 1e-4,
    no_qvalue: bool = False,
    qval_t: bool = False,
    no_reverse: bool = False,
    recomb: bool = False,
    stats: Optional[ScanStats] = None,
) -> ResultTable:
    """Full scoring pass for one motif over a stream of window batches.

    Returns the thresholded, p-value-sorted results table with the
    reference's exact column set (``resultsTmp.py:241-314``).
    """
    if stats is None:
        stats = ScanStats()
    pwm_flat = pwms_to_flat([motif.score_matrix])
    min_scores = np.array([motif.min_score], dtype=np.int32)
    hist_size = hist_size_for_width(motif.width)
    hist_total = np.zeros(hist_size, dtype=np.int64)

    kept_batches = []
    kept_scores = []
    for batch in batches:
        if no_reverse:
            keep = np.array([s != "-" for s in batch.strands], dtype=bool)
            if not keep.all():
                batch = batch.select(keep)
        if len(batch) == 0:
            continue
        parts = []
        for lo in range(0, len(batch), CHUNK):
            hi = min(lo + CHUNK, len(batch))
            t0 = time.perf_counter()
            scores, hist = score_and_histogram(
                batch.codes[lo:hi], pwm_flat, min_scores, hist_size
            )
            parts.append(np.asarray(scores)[:, 0].astype(np.int64))
            hist_total += np.asarray(hist)[:, 0].astype(np.int64)
            stats.scoring_time += time.perf_counter() - t0
        stats.seqs_scanned += len(batch)
        stats.nucs_scanned += len(batch) * motif.width
        kept_batches.append(batch)
        kept_scores.append(np.concatenate(parts))

    if not kept_batches:
        raise ValueError(
            "no result retrieved — are you using the correct variation "
            "graphs and searching on the right chromosomes?"
        )

    scores = np.concatenate(kept_scores)
    lookup = PvalueLookup(motif.pval_table)
    qvalues = None
    if not no_qvalue:
        qmap = qvalues_from_histogram(
            hist_total, lambda s: lookup.pvalues(s)
        )
        qvalues = np.array([qmap[int(s)] for s in scores], dtype=np.float64)
    table = build_results_df(
        motif,
        [s for b in kept_batches for s in b.seqnames],
        np.concatenate([b.starts for b in kept_batches]),
        np.concatenate([b.stops for b in kept_batches]),
        [s for b in kept_batches for s in b.strands],
        scores,
        lookup.pvalues(scores),
        [s for b in kept_batches for s in b.seqs],
        np.concatenate([b.freqs for b in kept_batches]),
        [s for b in kept_batches for s in b.refs],
        qvalues=qvalues,
    )
    # threshold on p- or q-values, drop unobserved recombinants, sort
    # (reference resultsTmp.py:302-313)
    return apply_report_filters(table, threshold, qval_t, recomb)
