"""Native anchored dense-cluster decomposition (graphite.cpp
dense_cluster_runs_native) — differential parity with the python spec
(graph/runs.dense_cluster_runs) and lazy ref reconstruction.

Round-5 scale work: at MHC-pocket density the python dense generator
took ~500 s and ~9 GB per 3 pockets (tools/profile_rss_phases.py); the
native path builds the same rows in C++ with descriptor emission and
no python Run materialisation.
"""

import numpy as np
import pandas as pd
import pytest

from conftest import frame
from grafimo_tpu.graph.runs import (
    DENSE_COMBO_STRIDE,
    build_single_run,
    cluster_sites,
    dense_cluster_runs,
    region_runs,
)
from grafimo_tpu.graph.sitegraph import build_graph
from grafimo_tpu.io.vcf import VcfRecord


def _native():
    native = pytest.importorskip("grafimo_tpu.native")
    try:
        native._lib()
    except Exception as e:  # pragma: no cover - env without g++
        pytest.skip(f"native engine unavailable: {e}")
    return native


def _mk_graph(seed=7, L=170, n_snp=36, indels=True):
    """Adjacent-site cluster dense enough to trip the int32 combo-idx
    cap (2^30+ full combinations) with a mix of SNPs and indels."""
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list("ACGT"), L))
    records = []
    pos = 30
    i = 0
    while i < n_snp and pos < L - 20:
        ref = seq[pos]
        alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[ref]
        gt = [int(rng.random() < 0.5) for _ in range(6)]
        if indels and i % 5 == 2:
            # deletion of 2 bases
            records.append(
                VcfRecord("d", pos, seq[pos - 1 : pos + 2],
                          [seq[pos - 1]], gt)
            )
            pos += 3
        elif indels and i % 5 == 4:
            # insertion of 2 bases
            records.append(
                VcfRecord("d", pos, seq[pos - 1],
                          [seq[pos - 1] + "TG"], gt)
            )
            pos += 2
        else:
            records.append(VcfRecord("d", pos + 1, ref, [alt], gt))
            pos += 2
        i += 1
    return build_graph("d", seq, records)


def _dense_meta_refs(per_bucket):
    """All (cluster_idx, combo_idx) dense refs emitted natively, with
    their row category, across packed/patched/spliced sub-buckets."""
    refs = []
    for d in per_bucket.values():
        for cat in ("meta",):
            if cat in d:
                for m in d["meta"]:
                    if m[1] <= -3:
                        refs.append(("packed", int(m[1]), int(m[2])))
        for sub in ("patched", "spliced"):
            if sub in d:
                for m in d[sub]["meta"]:
                    if m[1] <= -3:
                        refs.append((sub, int(m[1]), int(m[2])))
    return refs


@pytest.mark.parametrize("indels", [False, True])
def test_native_dense_rows_match_python_spec(indels):
    """Every natively-decomposed dense row, rebuilt from its lazy ref
    through build_single_run, must reproduce the python generator's
    (seq, valid) rows EXACTLY (as a multiset) — and vice versa."""
    native = _native()
    k = 8
    graph = _mk_graph(indels=indels)
    L = len(graph.seq)
    clusters = cluster_sites(graph, 0, L, k)
    per_bucket, overflow, dense_fb = native.batch_regions_native(
        graph, [(0, L)], k, buckets=(64, 128),
        bucket_slots=[4, 4], dense=True,
    )
    assert overflow == []
    assert dense_fb == []
    refs = _dense_meta_refs(per_bucket)
    assert refs, "fixture must actually trip the dense path"
    # native rows rebuilt through the decoded refs
    got = []
    for c_idx, x_idx in sorted(set((c, x) for _, c, x in refs)):
        run = build_single_run(graph, 0, L, k, (c_idx, x_idx))
        assert run is not None, (c_idx, x_idx)
        got.append((run.seq, tuple(run.valid.tolist())))
    # python spec rows
    want = []
    for ci, cl in enumerate(clusters):
        for run in dense_cluster_runs(graph, cl, 0, L, k):
            want.append((run.seq, tuple(run.valid.tolist())))
    assert sorted(got) == sorted(want)
    if indels:
        assert any(cat == "spliced" for cat, _, _ in refs)


def test_native_dense_descriptor_share():
    """Dense rows must ship as patch/splice descriptors, not packed
    bytes, when they fit the slot budget — otherwise an MHC-like pocket
    rides the packed wire."""
    native = _native()
    k = 8
    graph = _mk_graph(indels=False)
    L = len(graph.seq)
    per_bucket, _, _ = native.batch_regions_native(
        graph, [(0, L)], k, buckets=(64, 128),
        bucket_slots=[4, 4], dense=True,
    )
    n_desc = n_packed = 0
    for d in per_bucket.values():
        for m in d.get("meta", ()):
            if m[1] <= -3:
                n_packed += 1
        for sub in ("patched", "spliced"):
            if sub in d:
                n_desc += sum(
                    1 for m in d[sub]["meta"] if m[1] <= -3
                )
    assert n_desc > 0
    # substitution-only dense rows: the anchored combos hold few subs
    # each, so nearly all rows must be descriptor-resident
    assert n_desc >= 9 * max(1, n_packed)


def test_native_dense_ultra_anchor_falls_back():
    """An anchor whose window-sharing combination count exceeds the cap
    is reported as a (region, cluster, anchor) triple and its windows
    come from the exact python per-window fallback — pinned end to end
    by scan-engine report parity (native vs forced-python paths)."""
    native = _native()
    rng = np.random.default_rng(3)
    L = 90
    seq = "".join(rng.choice(list("ACGT"), L))
    records = []
    # 15 directly adjacent binary SNPs, k=14: whole-cluster candidates
    # ~2^14+ overflow max_combos (1<<14) -> dense path; anchors 0-1
    # each reach 14 sites -> 2^13 = 8192 > DENSE_ANCHOR_COMBOS anchored
    # combos -> exactly those anchors take the per-window fallback
    # (kept small: the python fallback enumerates every path-window)
    for pos0 in range(30, 45):
        ref = seq[pos0]
        alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[ref]
        gt = [int(rng.random() < 0.5) for _ in range(6)]
        records.append(VcfRecord("d", pos0 + 1, ref, [alt], gt))
    graph = build_graph("d", seq, records)
    k = 14
    per_bucket, overflow, dense_fb = native.batch_regions_native(
        graph, [(0, L)], k, buckets=(64, 128),
        bucket_slots=[4, 4], dense=True,
    )
    assert overflow == []
    assert dense_fb, "fixture must overflow at least one anchor"
    # full engine parity: native dense + anchor fallback vs the pure
    # python extraction path (same report, exact)
    import os

    from grafimo_tpu.models.parse import load_motifs
    from grafimo_tpu.runscan import build_region_runs, compute_results_runs
    from grafimo_tpu.utils.constants import UNIF
    from tests.conftest import DATA

    motif19 = load_motifs(
        str(DATA / "input" / "MA0139.1.jaspar"), UNIF, 0.1, False
    )[0]
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        fn = os.path.join(td, "short.jaspar")
        with open(fn, "w") as f:
            f.write(">SHORT14\ttest\n")
            for i, nuc in enumerate("ACGT"):
                row = " ".join(
                    str(int(c)) for c in motif19.counts[i][:k]
                )
                f.write(f"{nuc} [ {row} ]\n")
        motif = load_motifs(fn, UNIF, 0.1, False)[0]
    assert motif.width == k

    rr = build_region_runs(graph, "d", [(0, L)], k)
    got = compute_results_runs([motif], rr, threshold=1.0, recomb=True)[
        motif.motif_id
    ]
    import grafimo_tpu.runscan as runscan

    orig = runscan._native_batcher
    runscan._native_batcher = lambda: None
    try:
        rr2 = build_region_runs(graph, "d", [(0, L)], k)
        want = compute_results_runs(
            [motif], rr2, threshold=1.0, recomb=True
        )[motif.motif_id]
    finally:
        runscan._native_batcher = orig
    canon = lambda df: frame(df).sort_values(
        ["p-value", "start", "stop", "strand", "matched_sequence",
         "haplotype_frequency"]
    ).reset_index(drop=True)
    pd.testing.assert_frame_equal(canon(got), canon(want), check_exact=True)


def test_dense_ref_encoding_roundtrip():
    """The blocked (cluster, anchor, ordinal) <-> (c_idx, x_idx)
    encoding round-trips within int32 for mega-cluster anchor indices
    (the chaining rule merges whole 1KGP chromosomes into one
    multi-million-site cluster) and stays distinct from backbone/-2."""
    from grafimo_tpu.graph.runs import (
        DENSE_ANCHOR_BLOCK,
        DENSE_CLUSTER_MULT,
    )

    for ci in (0, 5, 1000, 16_000_000):
        for anchor in (0, 3, DENSE_ANCHOR_BLOCK - 1, DENSE_ANCHOR_BLOCK,
                       6_300_000, DENSE_CLUSTER_MULT
                       * DENSE_ANCHOR_BLOCK - 1):
            for ordinal in (0, 1, DENSE_COMBO_STRIDE - 1):
                c_idx = -3 - (ci * DENSE_CLUSTER_MULT
                              + anchor // DENSE_ANCHOR_BLOCK)
                x_idx = (
                    anchor % DENSE_ANCHOR_BLOCK
                ) * DENSE_COMBO_STRIDE + ordinal
                if ci * DENSE_CLUSTER_MULT + DENSE_CLUSTER_MULT >= (
                    1 << 31
                ) - 3:
                    continue  # native would take the legacy fallback
                assert c_idx <= -3
                assert -(1 << 31) <= c_idx and x_idx < (1 << 31)
                ci2, blk = divmod(-3 - c_idx, DENSE_CLUSTER_MULT)
                a_rem, o2 = divmod(x_idx, DENSE_COMBO_STRIDE)
                assert ci2 == ci
                assert blk * DENSE_ANCHOR_BLOCK + a_rem == anchor
                assert o2 == ordinal
