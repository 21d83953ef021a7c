"""Overlapping VCF records merge into one flattened site.

The reference delegates overlap resolution to ``vg construct -a``'s nested
bubbles (``constructVG.py:332``); ``build_graph`` flattens each overlap
group into a single site whose alleles enumerate the splicable allele
combinations, with haplotypes carrying unsplicable combinations resolved
greedily (outer bubble wins).  These tests pin the merge semantics and run
the merged graphs through the full runs-vs-enumerator and
engines-differential stacks.
"""

import numpy as np
import pandas as pd
import pytest

from conftest import frame
from grafimo_tpu.graph.extract import extract_region
from grafimo_tpu.graph.sitegraph import build_graph
from grafimo_tpu.io.vcf import VcfRecord
from grafimo_tpu.models.background import load_bg
from grafimo_tpu.models.motif import Motif
from grafimo_tpu.models.parse import _prepare_counts_motif
from grafimo_tpu.models.process import process_motif
from grafimo_tpu.runscan import build_region_runs, compute_results_runs
from grafimo_tpu.scan import compute_results
from grafimo_tpu.utils.constants import UNIF
from tests.test_runs_differential import assert_same_windows

#      0123456789
SEQ = "AACGTACGTTAACCGGTTAA"


def test_deletion_spanning_snp():
    """A deletion whose span contains a SNP merges into one site; the
    haplotype carrying both resolves to the outer deletion (a GBWT thread
    walks the enclosing alt path)."""
    recs = [
        VcfRecord("c", 4, "GTAC", ["G"], [1, 0, 0, 1]),  # del [4,7)
        VcfRecord("c", 6, "A", ["C"], [0, 1, 0, 1]),  # snp at 5 inside
    ]
    g = build_graph("c", SEQ, recs)
    assert len(g.sites) == 1
    site = g.sites[0]
    assert (site.ref_start, site.ref_end) == (4, 7)
    assert site.alleles == ["TAC", "TCC", ""]
    h = g.haplo
    # hap0 del, hap1 snp, hap2 ref, hap3 del+snp (conflict -> del)
    assert h.count([(0, 0)]) == 1
    assert h.count([(0, 1)]) == 1  # snp-only
    assert h.count([(0, 2)]) == 2  # del + conflict-resolved del+snp


def test_overlapping_deletions():
    recs = [
        VcfRecord("c", 3, "CGTA", ["C"], [1, 0, 0]),  # del [3,6)
        VcfRecord("c", 5, "TACG", ["T"], [0, 1, 0]),  # del [5,8), overlaps
    ]
    g = build_graph("c", SEQ, recs)
    assert len(g.sites) == 1
    site = g.sites[0]
    assert (site.ref_start, site.ref_end) == (3, 8)
    # merged ref GTACG; del1 -> G + "CG"? splice: [3,6) removed -> "CG";
    # del2 -> "GT"; both conflict
    assert site.alleles == ["GTACG", "GT", "CG"]
    assert g.haplo.count([(0, 2)]) == 1  # del1 carrier
    assert g.haplo.count([(0, 1)]) == 1  # del2 carrier
    assert g.haplo.count([(0, 0)]) == 1


def test_insertion_inside_deletion_span():
    recs = [
        VcfRecord("c", 4, "GTAC", ["G"], [1, 0]),  # del [4,7)
        VcfRecord("c", 5, "T", ["TGGG"], [0, 1]),  # ins after coord 4
    ]
    g = build_graph("c", SEQ, recs)
    assert len(g.sites) == 1
    site = g.sites[0]
    assert (site.ref_start, site.ref_end) == (4, 7)
    assert site.alleles == ["TAC", "TGGGAC", ""]
    assert g.haplo.count([(0, 2)]) == 1
    assert g.haplo.count([(0, 1)]) == 1


def test_merged_gt_dict_matches_array():
    """The native VCF scanner hands genotypes as haplotype bitset dicts;
    merging must produce the same HaploIndex as array genotypes."""
    gt1, gt2 = [1, 0, 0, 1], [0, 1, 0, 1]

    def words(arr, allele):
        mask = np.asarray(arr) == allele
        by = np.packbits(mask, bitorder="little")
        out = np.zeros(8, dtype=np.uint8)
        out[: len(by)] = by
        return out.view(np.uint64)

    recs_arr = [
        VcfRecord("c", 4, "GTAC", ["G"], gt1),
        VcfRecord("c", 6, "A", ["C"], gt2),
    ]
    recs_dict = [
        VcfRecord("c", 4, "GTAC", ["G"], {1: words(gt1, 1)}),
        VcfRecord("c", 6, "A", ["C"], {1: words(gt2, 1)}),
    ]
    ga = build_graph("c", SEQ, recs_arr)
    gd = build_graph("c", SEQ, recs_dict, n_hap=4)
    assert [s.alleles for s in ga.sites] == [s.alleles for s in gd.sites]
    for a in range(3):
        assert ga.haplo.count([(0, a)]) == gd.haplo.count([(0, a)])


def test_composite_records_pruned_for_gfa_streams():
    """GFA-synthesised record streams carry composite path records (the
    snarl flattener emits one record per anchor->reattachment path);
    pruning keeps the per-bubble decomposition instead of merging."""
    # two adjacent SNPs + the composite both-alt path record
    recs = [
        VcfRecord("c", 4, "G", ["T"], None),  # SNP at 0-based 3
        VcfRecord("c", 4, "GT", ["TC"], None),  # composite of both
        VcfRecord("c", 5, "T", ["C"], None),  # SNP at 0-based 4
    ]
    g = build_graph("c", SEQ, recs, prune_composite=True)
    spans = [(s.ref_start, s.ref_end) for s in g.sites]
    assert spans == [(3, 4), (4, 5)]
    # without pruning the same records merge into one combination site
    gm = build_graph("c", SEQ, recs, prune_composite=False)
    assert [(s.ref_start, s.ref_end) for s in gm.sites] == [(3, 5)]


def test_overlap_cap_falls_back_to_greedy(capsys):
    """Groups beyond MAX_OVERLAP_COMBOS degrade to the old greedy
    keep-non-overlapping behaviour with a warning."""
    import grafimo_tpu.graph.sitegraph as sg

    recs = []
    for i in range(14):
        # chained overlaps: spans [2+i, 4+i)
        pos = 2 + i
        ref = SEQ[pos : pos + 2]
        alt = "A" if ref[0] != "A" else "C"
        recs.append(VcfRecord("c", pos + 1, ref, [alt + ref[1]], None))
    old = sg.MAX_OVERLAP_COMBOS
    sg.MAX_OVERLAP_COMBOS = 64
    try:
        g = build_graph("c", SEQ, recs)
    finally:
        sg.MAX_OVERLAP_COMBOS = old
    err = capsys.readouterr().err
    assert "overlapping VCF records" in err
    # greedy subset: non-overlapping spans
    spans = [(s.ref_start, s.ref_end) for s in g.sites]
    for (s1, e1), (s2, e2) in zip(spans, spans[1:]):
        assert s2 >= e1


def _random_overlap_graph(rng, length=300, n_var=10, n_samples=3):
    """Random graph generator that DOES emit overlapping records."""
    seq = "".join(rng.choice(list("ACGT"), length))
    positions = sorted(
        rng.choice(np.arange(2, length - 12), size=n_var, replace=False)
    )
    records = []
    for pos0 in positions:
        pos0 = int(pos0)
        kind = rng.choice(["snp", "ins", "del", "multi"])
        ref1 = seq[pos0]
        if kind == "snp":
            alts = [rng.choice([c for c in "ACGT" if c != ref1])]
            ref = ref1
        elif kind == "ins":
            ins = "".join(rng.choice(list("ACGT"), rng.integers(1, 4)))
            ref = ref1
            alts = [ref1 + ins]
        elif kind == "del":
            dlen = int(rng.integers(1, 5))
            ref = seq[pos0 : pos0 + 1 + dlen]
            alts = [ref1]
        else:
            others = [c for c in "ACGT" if c != ref1]
            alts = list(rng.choice(others, size=2, replace=False))
            ref = ref1
        gt = [int(rng.integers(0, len(alts) + 1)) for _ in range(2 * n_samples)]
        records.append(
            VcfRecord(chrom="o", pos=pos0 + 1, ref=ref, alts=alts, gt=gt)
        )
    return build_graph("o", seq, records)


@pytest.mark.parametrize("seed", [101, 102, 103, 104])
def test_overlap_graphs_runs_match_enumerator(seed):
    rng = np.random.default_rng(seed)
    graph = _random_overlap_graph(rng)
    # ensure the generator actually produced a merged multi-allele site
    for rs, re_, k in [(0, 300, 9), (40, 220, 13)]:
        assert_same_windows(graph, rs, re_, k)


def _canon(table) -> pd.DataFrame:
    return frame(table).sort_values(
        ["p-value", "start", "stop", "strand", "matched_sequence",
         "haplotype_frequency"]
    ).reset_index(drop=True)


@pytest.mark.parametrize("seed", [201, 202, 203])
def test_overlap_graphs_engines_agree(seed):
    rng = np.random.default_rng(seed)
    graph = _random_overlap_graph(
        rng, length=int(rng.integers(150, 400)),
        n_var=int(rng.integers(4, 14)),
    )
    k = int(rng.integers(5, 15))
    counts = rng.integers(1, 50, (4, k)).astype(np.float64)
    motif = process_motif(
        _prepare_counts_motif(
            Motif(motif_id="O", motif_name="O", counts=counts, width=k),
            load_bg(UNIF, False),
            0.1,
        )
    )
    L = graph.length
    rs, re_ = 0, L
    threshold = float(rng.choice([1.0, 0.5]))
    rr = build_region_runs(graph, graph.chrom, [(rs, re_)], k)
    got = compute_results_runs(
        [motif], rr, threshold=threshold, recomb=True
    )[motif.motif_id]
    batch = extract_region(graph, rs, re_, k, chrom_display=graph.chrom)
    want = compute_results(motif, [batch], threshold=threshold, recomb=True)
    pd.testing.assert_frame_equal(_canon(got), _canon(want), check_exact=True)
