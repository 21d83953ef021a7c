"""BASELINE config #3: many same-width PWMs scanned in ONE device pass
over shared extraction, each motif's report identical to a solo scan."""

import numpy as np
import pandas as pd
import pytest

from conftest import frame
from grafimo_tpu.graph.sitegraph import build_graph
from grafimo_tpu.io.fasta import read_fasta
from grafimo_tpu.io.vcf import iter_vcf_records
from grafimo_tpu.models.motif import Motif
from grafimo_tpu.models.parse import _prepare_counts_motif
from grafimo_tpu.models.background import load_bg
from grafimo_tpu.models.process import process_motif
from grafimo_tpu.runscan import build_region_runs, compute_results_runs
from grafimo_tpu.utils.constants import UNIF


def _random_motif(rng, mid, k=11):
    counts = rng.integers(1, 200, (4, k)).astype(np.float64)
    m = Motif(motif_id=mid, motif_name=mid, counts=counts, width=k)
    bgs = load_bg(UNIF, False)
    return process_motif(_prepare_counts_motif(m, bgs, 0.1))


def test_ten_pwms_one_pass(input_dir):
    rng = np.random.default_rng(123)
    motifs = [_random_motif(rng, f"M{i:02d}") for i in range(10)]
    seqs = read_fasta(str(input_dir / "test.fa"))
    records = list(iter_vcf_records(str(input_dir / "test.vcf.gz"), "x"))
    graph = build_graph("x", seqs["x"], records)
    rr = build_region_runs(graph, "x", [(0, 50)], 11)
    # one pass: 10 motifs x 2 strands = 20 PWM columns in a single conv
    all_dfs = compute_results_runs(motifs, rr, threshold=1.0, recomb=True)
    assert set(all_dfs) == {m.motif_id for m in motifs}
    # each must equal its solo scan
    for m in motifs[:3]:
        solo = compute_results_runs([m], rr, threshold=1.0, recomb=True)[
            m.motif_id
        ]
        canon = lambda df: frame(df).sort_values(
            ["p-value", "start", "stop", "strand", "matched_sequence"]
        ).reset_index(drop=True)
        pd.testing.assert_frame_equal(
            canon(all_dfs[m.motif_id]), canon(solo), check_exact=True
        )
