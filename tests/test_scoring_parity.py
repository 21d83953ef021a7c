"""End-to-end scoring parity against the reference golden report.

Mirrors the reference's ``test_scoring`` (``tests/grafimo_run_test.py:119-142``):
score the pre-extracted chr22 CTCF fixture windows in test mode (threshold=1,
recomb on, q-values on, both strands) and require the resulting table —
scores, p-values, q-values, coordinates, haplotype frequencies, ref flags —
to round-trip-equal the golden ``scoring_results.tsv``.
"""

import numpy as np
import pandas as pd
import pytest

from grafimo_tpu.models.parse import load_motifs
from grafimo_tpu.models.pvalue import PvalueLookup
from grafimo_tpu.ops.qvalue import fdr_bh, qvalues_from_histogram
from grafimo_tpu.report.writer import write_tsv
from grafimo_tpu.scan import compute_results
from grafimo_tpu.utils.constants import UNIF
from grafimo_tpu.windows import iter_windows_tsv_dir


@pytest.fixture(scope="module")
def ctcf(input_dir):
    return load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1, False)[0]


def _sorted(df: pd.DataFrame) -> pd.DataFrame:
    return df.sort_values(
        ["p-value", "start", "stop"], ascending=True
    ).reset_index(drop=True)


def test_scoring_golden_parity(ctcf, input_dir, expected_dir, tmp_path):
    results = compute_results(
        ctcf,
        iter_windows_tsv_dir(str(input_dir), 19),
        threshold=1.0,
        no_qvalue=False,
        qval_t=False,
        no_reverse=False,
        recomb=True,
    )
    out = tmp_path / "scoring_test.tsv"
    write_tsv(str(out), results)
    got = _sorted(pd.read_csv(out, sep="\t", index_col=0))
    expected = _sorted(
        pd.read_csv(expected_dir / "scoring_results.tsv", sep="\t", index_col=0)
    )
    pd.testing.assert_frame_equal(got, expected, check_exact=True)


def test_histogram_qvalues_equal_direct_bh(ctcf, input_dir):
    """The histogram BH path must be float64-identical to statsmodels-style
    BH over the raw p-value list."""
    batches = list(iter_windows_tsv_dir(str(input_dir), 19))
    from grafimo_tpu.ops.score_jax import (
        hist_size_for_width,
        pwms_to_flat,
        score_and_histogram,
    )

    pwm = pwms_to_flat([ctcf.score_matrix])
    mins = np.array([ctcf.min_score], dtype=np.int32)
    hs = hist_size_for_width(19)
    all_scores = []
    hist = np.zeros(hs, dtype=np.int64)
    for b in batches:
        s, h = score_and_histogram(b.codes, pwm, mins, hs)
        all_scores.append(np.asarray(s)[:, 0])
        hist += np.asarray(h)[:, 0]
    scores = np.concatenate(all_scores).astype(np.int64)
    lookup = PvalueLookup(ctcf.pval_table)
    pvals = lookup.pvalues(scores)
    q_direct = fdr_bh(pvals)
    qmap = qvalues_from_histogram(hist, lookup.pvalues)
    q_hist = np.array([qmap[int(s)] for s in scores])
    np.testing.assert_array_equal(q_direct, q_hist)


def test_n_window_scores_min_score(ctcf):
    from grafimo_tpu.ops.encode import seqs_to_codes
    from grafimo_tpu.ops.score_jax import pwms_to_flat, score_batch

    seq_ok = "TTTTCTTCCGTTGTGAATG"
    seq_n = "TTTTCTTCCNTTGTGAATG"
    codes = seqs_to_codes([seq_ok, seq_n], 19)
    pwm = pwms_to_flat([ctcf.score_matrix])
    mins = np.array([ctcf.min_score], dtype=np.int32)
    scores = np.asarray(score_batch(codes, pwm, mins))[:, 0]
    assert scores[1] == ctcf.min_score
    assert scores[0] == sum(
        ctcf.score_matrix["ACGT".index(c)][i] for i, c in enumerate(seq_ok)
    )


def test_noreverse_filters_minus_strand(ctcf, input_dir):
    results = compute_results(
        ctcf,
        iter_windows_tsv_dir(str(input_dir), 19),
        threshold=1.0,
        no_reverse=True,
        recomb=True,
    )
    assert set(results["strand"]) == {"+"}
