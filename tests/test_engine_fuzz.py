"""Randomized end-to-end differential fuzzing: the production run-scan
engine vs the per-window reference engine on random indel graphs, random
motifs, random thresholds and flags."""

import numpy as np
import pandas as pd
import pytest

from conftest import frame
from grafimo_tpu.graph.extract import extract_region
from grafimo_tpu.models.background import load_bg
from grafimo_tpu.models.motif import Motif
from grafimo_tpu.models.parse import _prepare_counts_motif
from grafimo_tpu.models.process import process_motif
from grafimo_tpu.runscan import build_region_runs, compute_results_runs
from grafimo_tpu.scan import compute_results
from grafimo_tpu.utils.constants import UNIF
from tests.test_runs_differential import _random_graph


def _canon(table) -> pd.DataFrame:
    return frame(table).sort_values(
        ["p-value", "start", "stop", "strand", "matched_sequence",
         "haplotype_frequency"]
    ).reset_index(drop=True)


@pytest.mark.parametrize("seed", [10, 11, 12, 13, 14, 15])
def test_engines_agree_fuzz(seed):
    rng = np.random.default_rng(seed)
    graph = _random_graph(
        rng,
        length=int(rng.integers(150, 500)),
        n_var=int(rng.integers(3, 18)),
        n_samples=int(rng.integers(1, 5)),
    )
    k = int(rng.integers(5, 17))
    counts = rng.integers(1, 50, (4, k)).astype(np.float64)
    motif = process_motif(
        _prepare_counts_motif(
            Motif(motif_id="F", motif_name="F", counts=counts, width=k),
            load_bg(UNIF, False),
            0.1,
        )
    )
    L = graph.length
    rs = int(rng.integers(0, L // 3))
    re_ = int(rng.integers(rs + k + 5, L + 1))
    threshold = float(rng.choice([1.0, 0.5, 0.05]))
    recomb = bool(rng.integers(0, 2))
    no_reverse = bool(rng.integers(0, 2))
    no_qvalue = bool(rng.integers(0, 2))

    rr = build_region_runs(graph, graph.chrom, [(rs, re_)], k)
    got = compute_results_runs(
        [motif], rr, threshold=threshold, recomb=recomb,
        no_reverse=no_reverse, no_qvalue=no_qvalue,
    )[motif.motif_id]
    batch = extract_region(
        graph, rs, re_, k, chrom_display=graph.chrom,
        both_strands=not no_reverse,
    )
    if len(batch) == 0:
        assert len(got) == 0
        return
    want = compute_results(
        motif, [batch], threshold=threshold, recomb=recomb,
        no_reverse=no_reverse, no_qvalue=no_qvalue,
    )
    pd.testing.assert_frame_equal(_canon(got), _canon(want), check_exact=True)
