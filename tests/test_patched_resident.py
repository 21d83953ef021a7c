"""Device-resident cluster runs: substitution-only combination runs ride
the wire as a 4-byte genome offset + 2-byte patch descriptors and expand
against the HBM-resident chromosome on device — bit-identical to the
packed-upload path."""

import numpy as np
import pandas as pd
import pytest

import grafimo_tpu.runscan as rs
from conftest import frame
from grafimo_tpu.graph.extract import extract_region
from grafimo_tpu.graph.sitegraph import build_graph
from grafimo_tpu.io.vcf import VcfRecord
from grafimo_tpu.models.background import load_bg
from grafimo_tpu.models.motif import Motif
from grafimo_tpu.models.parse import _prepare_counts_motif, load_motifs
from grafimo_tpu.models.process import process_motif
from grafimo_tpu.scan import compute_results
from grafimo_tpu.utils.constants import UNIF


def _snp_graph(rng, length=600, n_snp=12, n_samples=3, spacing=6):
    """Dense SNP-only graph: clusters chain into long substitution runs."""
    seq = "".join(rng.choice(list("ACGT"), length))
    records = []
    pos0 = 10
    for _ in range(n_snp):
        ref1 = seq[pos0]
        alt = rng.choice([c for c in "ACGT" if c != ref1])
        gt = [int(rng.integers(0, 2)) for _ in range(2 * n_samples)]
        records.append(
            VcfRecord(chrom="p", pos=pos0 + 1, ref=ref1, alts=[alt], gt=gt)
        )
        pos0 += int(rng.integers(2, spacing))
        if pos0 >= length - 10:
            break
    return build_graph("p", seq, records)


def _motif(rng, k):
    counts = rng.integers(1, 50, (4, k)).astype(np.float64)
    return process_motif(
        _prepare_counts_motif(
            Motif(motif_id="P", motif_name="P", counts=counts, width=k),
            load_bg(UNIF, False),
            0.1,
        )
    )


def _canon(table) -> pd.DataFrame:
    return frame(table).sort_values(
        ["p-value", "start", "stop", "strand", "matched_sequence",
         "haplotype_frequency"]
    ).reset_index(drop=True)


def test_patched_kernel_matches_packed():
    """Direct kernel check: resident+patches == packed upload for random
    substitution rows."""
    import jax.numpy as jnp

    from grafimo_tpu.ops.score_runs import (
        bytes_to_words,
        pack_bits,
        pack_run_seqs,
        scan_runs_device_topk,
        scan_runs_resident_patched_topk,
    )

    rng = np.random.default_rng(0)
    L, R, k, B, P = 2048, 128, 11, 16, 16
    genome = rng.integers(0, 4, L).astype(np.uint8)
    genome4 = bytes_to_words(pack_run_seqs(genome[None, :])[0])
    gstart = rng.integers(0, L - R, B).astype(np.int32)
    patches = np.full((B, P), -1, dtype=np.int16)
    rows = np.stack([genome[g : g + R] for g in gstart]).copy()
    for b in range(B):
        for pos in rng.choice(R, size=int(rng.integers(0, P + 1)),
                              replace=False):
            base = int(rng.integers(0, 4))
            slot = int(np.sum(patches[b] >= 0))
            patches[b, slot] = pos * 4 + base
            rows[b, pos] = base
    noff = R - k + 1
    vb = pack_bits(rng.integers(0, 2, (B, noff)).astype(bool))
    mot = _motif(rng, k)
    kern = np.stack([np.asarray(mot.score_matrix, np.float32).T], axis=-1)
    mins = np.array([mot.min_score], dtype=np.int32)
    cuts = np.zeros(1, dtype=np.int32)
    hs = 1000 * k + 1
    h1, hb1, n1, t1 = scan_runs_resident_patched_topk(
        jnp.zeros((hs, 1), jnp.int32), genome4, None, gstart, patches,
        vb, kern, mins, cuts, R, k, hs, 64,
    )
    h2, hb2, n2, t2 = scan_runs_device_topk(
        jnp.zeros((hs, 1), jnp.int32), pack_run_seqs(rows), None, vb,
        kern, mins, cuts, k, hs, 64,
    )
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_array_equal(np.asarray(hb1), np.asarray(hb2))
    assert int(n1) == int(n2)


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_patched_engine_differential(seed, monkeypatch):
    """Full-engine differential with the patched path forced on (bucket
    floor dropped): runs engine == windows engine on dense SNP graphs."""
    monkeypatch.setattr(rs, "MIN_PATCH_R", 0)
    rng = np.random.default_rng(seed)
    graph = _snp_graph(rng)
    k = int(rng.integers(6, 14))
    motif = _motif(rng, k)
    rr = rs.build_region_runs(graph, "p", [(0, graph.length)], k)
    got = rs.compute_results_runs(
        [motif], rr, threshold=1.0, recomb=True
    )[motif.motif_id]
    batch = extract_region(graph, 0, graph.length, k, chrom_display="p")
    want = compute_results(motif, [batch], threshold=1.0, recomb=True)
    pd.testing.assert_frame_equal(_canon(got), _canon(want), check_exact=True)


def test_patched_path_engages_by_default():
    """A chained SNP cluster long enough for a >=MIN_PATCH_R bucket must
    actually produce patched batches (wire savings are real, not
    theoretical)."""
    rng = np.random.default_rng(5)
    graph = _snp_graph(rng, length=800, n_snp=10, spacing=12)
    k = 19
    rr = rs.build_region_runs(graph, "p", [(0, graph.length)], k)
    batches = rs.batch_runs(rr, k)
    patched = [b for b in batches if b.patches is not None]
    assert patched, "no patched batches produced"
    n_rows = sum(b.patches.shape[0] for b in patched)
    assert n_rows > 8
    # patched rows carry no packed payload
    for b in patched:
        assert b.packed is None and b.gstart is not None


def test_spliced_kernel_matches_packed():
    """Direct kernel check: resident + splice entries + patches ==
    packed upload for rows built by explicit host-side splicing,
    including N-plane behaviour at deletions and patched insertions."""
    import jax.numpy as jnp

    from grafimo_tpu.ops.score_runs import (
        bytes_to_words,
        pack_bits,
        pack_run_seqs,
        scan_runs_device_topk,
        scan_runs_resident_spliced_topk,
    )

    rng = np.random.default_rng(4)
    L, R, k, B, P, S = 2048, 128, 11, 24, 8, 2
    genome = rng.integers(0, 4, L).astype(np.uint8)
    nmask = np.zeros(L, bool)
    nmask[rng.integers(0, L, 40)] = True
    g_codes = genome.copy()
    gw = bytes_to_words(pack_run_seqs(g_codes[None, :])[0])
    nw = bytes_to_words(pack_bits(nmask[None, :])[0])
    gstart = rng.integers(16, L - R - 40, B).astype(np.int32)
    splice = np.full((B, 2 * S), 0x7FFF, dtype=np.int16)
    patches = np.full((B, P), -1, dtype=np.int16)
    rows = np.empty((B, R), np.uint8)
    nrows = np.empty((B, R), bool)
    for b in range(B):
        # host oracle: piecewise genome with ascending bounds
        n_seg = int(rng.integers(0, S + 1))
        bounds = np.sort(rng.choice(np.arange(4, R - 4), n_seg,
                                    replace=False))
        shifts = rng.integers(-12, 13, n_seg)
        g0 = int(gstart[b])
        row = genome[g0 : g0 + R].copy()
        nrow = nmask[g0 : g0 + R].copy()
        for s, (bd, sh) in enumerate(zip(bounds, shifts)):
            splice[b, 2 * s] = bd
            splice[b, 2 * s + 1] = sh
            row[bd:] = genome[g0 + sh + bd : g0 + sh + R]
            nrow[bd:] = nmask[g0 + sh + bd : g0 + sh + R]
        n_pat = int(rng.integers(0, P + 1))
        for s, pos in enumerate(
            rng.choice(R, size=n_pat, replace=False)
        ):
            base = int(rng.integers(0, 4))
            patches[b, s] = pos * 4 + base
            row[pos] = base
            nrow[pos] = False  # patched bases are ACGT by contract
        rows[b] = row
        nrows[b] = nrow
    noff = R - k + 1
    vb = pack_bits(rng.integers(0, 2, (B, noff)).astype(bool))
    mot = _motif(rng, k)
    kern = np.stack([np.asarray(mot.score_matrix, np.float32).T], axis=-1)
    mins = np.array([mot.min_score], dtype=np.int32)
    cuts = np.zeros(1, dtype=np.int32)
    hs = 1000 * k + 1
    h1, hb1, n1, t1 = scan_runs_resident_spliced_topk(
        jnp.zeros((hs, 1), jnp.int32), gw, nw, gstart, splice, patches,
        vb, kern, mins, cuts, R, k, hs, 64,
    )
    h2, hb2, n2, t2 = scan_runs_device_topk(
        jnp.zeros((hs, 1), jnp.int32), pack_run_seqs(rows),
        pack_bits(nrows), vb, kern, mins, cuts, k, hs, 64,
    )
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_array_equal(np.asarray(hb1), np.asarray(hb2))
    np.testing.assert_array_equal(np.asarray(n1), np.asarray(n2))


def test_indel_clusters_ride_the_spliced_path(input_dir):
    """Indel combinations are not substitution-only — they ride the
    span-spliced resident representation (round 3; previously packed),
    and the scan result stays identical to the per-window engine."""
    rng = np.random.default_rng(9)
    seq = "".join(rng.choice(list("ACGT"), 400))
    records = [
        VcfRecord("i", 50, seq[49:53], [seq[49]], [1, 0]),  # deletion
        VcfRecord("i", 200, seq[199], [seq[199] + "GGG"], [0, 1]),  # ins
    ]
    graph = build_graph("i", seq, records)
    k = 19
    rr = rs.build_region_runs(graph, "i", [(0, 400)], k)
    batches = rs.batch_runs(rr, k)
    spliced = [b for b in batches if b.splice is not None]
    assert spliced, "indel combinations should produce spliced batches"
    for b in spliced:
        assert b.packed is None and b.gstart is not None
        assert b.patches is not None
    for b in batches:
        if b.patches is not None and b.splice is None:
            # pure-patch rows keep the substitution-only contract
            for c in b.chunks:
                info = rs._patch_info(
                    {r.key: r for r in rr}[c.source[0]], c.source[1], k
                )
                assert info is not None
    # end-to-end equality vs the per-window engine
    motif = _motif(np.random.default_rng(5), k)
    got = rs.compute_results_runs(
        [motif], rr, threshold=1.0, recomb=True
    )[motif.motif_id]
    batch = extract_region(graph, 0, 400, k, chrom_display="i")
    want = compute_results(motif, [batch], threshold=1.0, recomb=True)
    pd.testing.assert_frame_equal(
        _canon(got), _canon(want), check_exact=True
    )
