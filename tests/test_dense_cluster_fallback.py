"""Over-dense clusters (combination count beyond the cap) fall back to
exact per-window runs instead of dropping the region."""

import numpy as np
import pandas as pd
import pytest

from conftest import frame
from grafimo_tpu.graph.enumerate import enumerate_region_windows
from grafimo_tpu.graph.runs import (
    MAX_COMBOS_PER_CLUSTER,
    expand_all_windows,
    region_runs,
)
from grafimo_tpu.graph.sitegraph import build_graph
from grafimo_tpu.io.vcf import VcfRecord


@pytest.fixture(scope="module")
def dense_graph():
    rng = np.random.default_rng(42)
    seq = "".join(rng.choice(list("ACGT"), 100))
    records = []
    # 34 adjacent SNPs: 2^34 full combinations overflow the int32
    # (cluster, combo) hit identity, forcing the per-window fallback even
    # though the candidate DFS could enumerate the contributing combos
    for pos0 in range(30, 64):
        ref = seq[pos0]
        alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[ref]
        gt = [int(rng.random() < 0.5) for _ in range(4)]
        records.append(VcfRecord("d", pos0 + 1, ref, [alt], gt))
    return build_graph("d", seq, records)


def test_fallback_windows_match_enumerator(dense_graph):
    k = 6
    assert 2 ** 34 > MAX_COMBOS_PER_CLUSTER
    runs = region_runs(dense_graph, 0, 100, k)
    # fallback single-window runs present
    assert any(r.ref[0] == -2 for r in runs)
    got = sorted(
        (w.begin, w.end, w.seq, tuple(w.path), w.is_ref, w.freq)
        for w in expand_all_windows(dense_graph, runs, k)
    )
    want = sorted(
        (w.begin, w.end, w.seq, tuple(w.path), w.is_ref, w.freq)
        for w in enumerate_region_windows(dense_graph, 0, 100, k)
    )
    assert got == want


def test_native_batcher_cluster_local_overflow(dense_graph):
    """The native batcher must emit the healthy clusters' runs and report
    ONLY the over-dense cluster — never skip the whole region."""
    native = pytest.importorskip("grafimo_tpu.native")
    try:
        native._lib()
    except Exception as e:  # pragma: no cover - env without g++
        pytest.skip(f"native engine unavailable: {e}")
    from grafimo_tpu.graph.runs import cluster_sites

    k = 6
    clusters = cluster_sites(dense_graph, 0, 100, k)
    # the fixture graph has exactly one (over-dense) cluster; add context:
    # region also has backbone windows, which must land in the buckets
    per_bucket, overflow, dense_fb = native.batch_regions_native(
        dense_graph, [(0, 100)], k, buckets=(128,)
    )
    assert overflow == [(0, ci) for ci in range(len(clusters))]
    assert dense_fb == []  # dense=False keeps the legacy fallback path
    rows = sum(
        len(d.get("meta", ())) + len(d.get("patched", {}).get("meta", ()))
        for d in per_bucket.values()
    )
    assert rows >= 1, "backbone run must still be emitted"


def test_fallback_through_scan_engine(dense_graph, input_dir):
    """The full run-scan engine (native batcher reporting the over-dense
    cluster, python enumerating just its windows) must match the
    per-window engine."""
    from grafimo_tpu.graph.extract import extract_region
    from grafimo_tpu.models.parse import load_motifs
    from grafimo_tpu.runscan import build_region_runs, compute_results_runs
    from grafimo_tpu.scan import compute_results
    from grafimo_tpu.utils.constants import UNIF

    k = 6
    # a width-6 motif: trim CTCF's matrix to 6 columns through a synthetic
    # JASPAR file
    motif19 = load_motifs(str(input_dir / "MA0139.1.jaspar"), UNIF, 0.1,
                          False)[0]
    import tempfile, os

    with tempfile.TemporaryDirectory() as td:
        fn = os.path.join(td, "short.jaspar")
        with open(fn, "w") as f:
            f.write(">SHORT6\ttest\n")
            for i, nuc in enumerate("ACGT"):
                row = " ".join(
                    str(int(c)) for c in motif19.counts[i][:6]
                )
                f.write(f"{nuc} [ {row} ]\n")
        motif = load_motifs(fn, UNIF, 0.1, False)[0]
    assert motif.width == 6
    rr = build_region_runs(dense_graph, "d", [(0, 100)], k)
    got = compute_results_runs([motif], rr, threshold=1.0, recomb=True)[
        motif.motif_id
    ]
    batch = extract_region(dense_graph, 0, 100, k, chrom_display="d")
    want = compute_results(motif, [batch], threshold=1.0, recomb=True)
    canon = lambda df: frame(df).sort_values(
        ["p-value", "start", "stop", "strand", "matched_sequence",
         "haplotype_frequency"]
    ).reset_index(drop=True)
    pd.testing.assert_frame_equal(canon(got), canon(want), check_exact=True)
