"""The pandas-free report table must write, filter and sort exactly as
the pandas DataFrame the reference reports with."""

import numpy as np
import pandas as pd
import pytest

from grafimo_tpu.report.results import ResultTable, apply_report_filters
from grafimo_tpu.report.writer import write_tsv

COLS = [
    "motif_id", "motif_alt_id", "sequence_name", "start", "stop", "strand",
    "score", "p-value", "q-value", "matched_sequence",
    "haplotype_frequency", "reference",
]


def _table_from_frame(df: pd.DataFrame) -> ResultTable:
    return ResultTable(
        {
            c: (
                df[c].to_numpy()
                if df[c].dtype.kind in "fiu"
                else df[c].tolist()
            )
            for c in df.columns
        }
    )


def _random_frame(rng, n: int, tie_levels: int) -> pd.DataFrame:
    p = rng.integers(0, tie_levels, n) * 1e-3 + rng.choice(
        [0.0, 1e-9, 3.3e-7], n
    )
    return pd.DataFrame(
        {
            "motif_id": ["MA0139.1"] * n,
            "motif_alt_id": ["CTCF"] * n,
            "sequence_name": [f"22:{i}-{i + 300}" for i in range(n)],
            "start": rng.integers(0, 10**8, n).astype(np.int64),
            "stop": rng.integers(0, 10**8, n).astype(np.int64),
            "strand": rng.choice(["+", "-"], n).tolist(),
            "score": rng.normal(0, 10, n) * rng.choice([1e-6, 1, 1e6], n),
            "p-value": p,
            "q-value": np.minimum(1.0, p * rng.uniform(1, 50, n)),
            "matched_sequence": rng.choice(
                ["ACGTACGTACG", "NNACGT", 'A"C\tG', "TTTT"], n
            ).tolist(),
            "haplotype_frequency": rng.integers(0, 3, n).astype(np.int64),
            "reference": rng.choice(["ref", "non.ref"], n).tolist(),
        }
    )


def test_tsv_bytes_match_pandas_on_golden(expected_dir, tmp_path):
    golden = pd.read_csv(
        expected_dir / "scoring_results.tsv", sep="\t", index_col=0
    )
    out = tmp_path / "t.tsv"
    write_tsv(str(out), _table_from_frame(golden))
    assert out.read_bytes() == golden.to_csv(sep="\t").encode()


def test_tsv_bytes_match_pandas_random(tmp_path):
    """Float formatting (tiny, huge, negative), quoting of tabs and
    quotes, and the index column."""
    df = _random_frame(np.random.default_rng(0), 300, 50)
    out = tmp_path / "r.tsv"
    write_tsv(str(out), _table_from_frame(df))
    assert out.read_bytes() == df.to_csv(sep="\t").encode()


@pytest.mark.parametrize("n", [12, 200, 5000])
def test_sort_order_matches_sort_values_with_ties(n):
    """Heavily tied p-values: the row order equals pandas'
    ``sort_values`` (numpy quicksort), which is not stable past 16 rows."""
    df = _random_frame(np.random.default_rng(n), n, 7)
    got = apply_report_filters(_table_from_frame(df), 1.0, False, True)
    want = df[df["p-value"] < 1.0].sort_values(["p-value"]).reset_index(
        drop=True
    )
    pd.testing.assert_frame_equal(
        pd.DataFrame(got.columns), want, check_exact=True
    )


@pytest.mark.parametrize("qval_t", [False, True])
@pytest.mark.parametrize("recomb", [False, True])
def test_filters_match_pandas(qval_t, recomb):
    """p- or q-value threshold and the recombinant filter
    (reference ``resultsTmp.py:302-313``)."""
    df = _random_frame(np.random.default_rng(7), 400, 30)
    t = 0.012
    got = apply_report_filters(_table_from_frame(df), t, qval_t, recomb)
    want = df[df["q-value" if qval_t else "p-value"] < t]
    if not recomb:
        want = want[want["haplotype_frequency"] > 0]
    want = want.sort_values(["p-value"]).reset_index(drop=True)
    assert 0 < len(want) < len(df)
    pd.testing.assert_frame_equal(
        pd.DataFrame(got.columns), want, check_exact=True
    )
