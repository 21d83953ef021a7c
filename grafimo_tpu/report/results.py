"""Shared results-table assembly (reference ``ResultTmp.to_df``,
``resultsTmp.py:241-314``)."""

from typing import Dict, List, Optional, Sequence

import numpy as np

from grafimo_tpu.models.motif import Motif


class ResultTable:
    """The report table: named columns of equal length, in report order.

    Numeric columns are numpy arrays, text columns are lists of ``str``.
    Stands in for the pandas DataFrame the reference reports with
    (``resultsTmp.py:241-314``); the writers in ``report/writer.py``
    reproduce its TSV bytes.
    """

    def __init__(self, columns: Dict[str, Sequence]):
        self.columns = dict(columns)
        lengths = {len(v) for v in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal length: {sorted(lengths)}")

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()), ()))

    def __getitem__(self, name: str):
        return self.columns[name]

    def take(self, idx) -> "ResultTable":
        """The rows at ``idx`` (an integer index array), in that order."""
        idx = np.asarray(idx, dtype=np.intp)
        out = {}
        for name, col in self.columns.items():
            if isinstance(col, np.ndarray):
                out[name] = col[idx]
            else:
                out[name] = [col[i] for i in idx.tolist()]
        return ResultTable(out)

    def cells(self) -> List[List[str]]:
        """Every column as the strings pandas' ``to_csv`` writes: floats
        as numpy's shortest round-trip repr (``astype(str)``, what
        pandas does for a float64 column without ``float_format``),
        everything else through ``str``."""
        out = []
        for col in self.columns.values():
            if isinstance(col, np.ndarray) and col.dtype.kind == "f":
                out.append(col.astype(str).tolist())
            else:
                out.append([str(v) for v in col])
        return out


def build_results_df(
    motif: Motif,
    seqnames,
    starts,
    stops,
    strands,
    scores_int: np.ndarray,
    pvalues: np.ndarray,
    seqs,
    freqs,
    refs,
    qvalues: Optional[np.ndarray] = None,
) -> ResultTable:
    """Assemble the report table with the reference's exact column set
    and value conventions (log-odds de-scaling ``score_sequences.py:393``,
    indel ref reclassification ``score_sequences.py:305-307``)."""
    scores_int = np.asarray(scores_int, dtype=np.int64)
    logodds = (scores_int / motif.scale) + (motif.width * motif.offset)
    starts = np.asarray(starts, dtype=np.int64)
    stops = np.asarray(stops, dtype=np.int64)
    distance = np.abs(stops - starts)
    refs_fixed = [
        "non.ref" if (r == "ref" and d != motif.width) else r
        for r, d in zip(refs, distance.tolist())
    ]
    columns: Dict[str, object] = {
        "motif_id": [motif.motif_id] * len(scores_int),
        "motif_alt_id": [motif.motif_name] * len(scores_int),
        "sequence_name": list(seqnames),
        "start": starts,
        "stop": stops,
        "strand": list(strands),
        "score": np.asarray(logodds, dtype=np.float64),
        "p-value": np.asarray(pvalues, dtype=np.float64),
    }
    if qvalues is not None:
        columns["q-value"] = np.asarray(qvalues, dtype=np.float64)
    columns["matched_sequence"] = list(seqs)
    columns["haplotype_frequency"] = np.asarray(freqs, dtype=np.int64)
    columns["reference"] = refs_fixed
    return ResultTable(columns)


def apply_report_filters(
    table: ResultTable, threshold: float, qval_t: bool, recomb: bool
) -> ResultTable:
    """Threshold + recombinant filter + p-value sort
    (reference ``resultsTmp.py:302-313``).  The sort is numpy's
    quicksort argsort of the kept p-values — the call pandas'
    ``sort_values`` makes — so tied rows keep the reference's order."""
    keep = table["q-value" if qval_t else "p-value"] < threshold
    if not recomb:
        keep &= table["haplotype_frequency"] > 0
    sel = np.flatnonzero(keep)
    order = np.argsort(table["p-value"][sel], kind="quicksort")
    return table.take(sel[order])
