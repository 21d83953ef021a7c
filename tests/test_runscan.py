"""The run-scan production engine must reproduce the per-window reference
path bit for bit."""

import numpy as np
import pandas as pd
import pytest

from conftest import frame
from grafimo_tpu.graph.extract import extract_region
from grafimo_tpu.graph.sitegraph import build_graph
from grafimo_tpu.io.fasta import read_fasta
from grafimo_tpu.io.vcf import iter_vcf_records
from grafimo_tpu.models.parse import load_motifs
from grafimo_tpu.runscan import build_region_runs, compute_results_runs
from grafimo_tpu.scan import compute_results
from grafimo_tpu.utils.constants import UNIF


@pytest.fixture(scope="module")
def toy_graph(input_dir):
    seqs = read_fasta(str(input_dir / "test.fa"))
    records = list(iter_vcf_records(str(input_dir / "test.vcf.gz"), "x"))
    return build_graph("x", seqs["x"], records)


@pytest.fixture(scope="module")
def ctcf(input_dir):
    return load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1, False)[0]


def _canon(table) -> pd.DataFrame:
    return frame(table).sort_values(
        ["p-value", "start", "stop", "strand", "matched_sequence"]
    ).reset_index(drop=True)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(threshold=1.0, recomb=True),
        dict(threshold=1.0, recomb=True, no_reverse=True),
        dict(threshold=1.0, recomb=True, no_qvalue=True),
        dict(threshold=0.05, recomb=True),
        dict(threshold=0.95, recomb=True, qval_t=True),
        dict(threshold=0.96, recomb=False, qval_t=True),
    ],
)
def test_runscan_matches_window_path(toy_graph, ctcf, kwargs):
    # reference path: materialised windows through scan.compute_results
    batch = extract_region(
        toy_graph, 0, 50, 19, chrom_display="x",
        both_strands=not kwargs.get("no_reverse", False),
    )
    want = compute_results(ctcf, [batch], **kwargs)
    # production path: run-compressed device scan
    rr = build_region_runs(toy_graph, "x", [(0, 50)], 19)
    got = compute_results_runs([ctcf], rr, **kwargs)[ctcf.motif_id]
    pd.testing.assert_frame_equal(_canon(got), _canon(want), check_exact=True)


def test_runscan_multi_motif(toy_graph, input_dir):
    """Several same-width motifs scanned in a single device pass."""
    m1 = load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1, False)[0]
    m2 = load_motifs(str(input_dir / "MA0139.1.jaspar"), UNIF, 0.1, False)[0]
    m2.motif_id = "MA0139.1-jaspar"
    rr = build_region_runs(toy_graph, "x", [(0, 50)], 19)
    dfs = compute_results_runs([m1, m2], rr, threshold=1.0, recomb=True)
    assert set(dfs) == {"MA0139.1", "MA0139.1-jaspar"}
    batch = extract_region(toy_graph, 0, 50, 19, chrom_display="x")
    want1 = compute_results(m1, [batch], threshold=1.0, recomb=True)
    pd.testing.assert_frame_equal(
        _canon(dfs["MA0139.1"]), _canon(want1), check_exact=True
    )


def test_runscan_n_handling(ctcf):
    """Windows covering N bases score ``min_score`` whose p-value is 1.0,
    so they can never pass ``p < threshold`` — exactly the reference
    behaviour (``score_sequences.py:376-378`` + ``resultsTmp.py:307``).
    The run path must agree with the window path on an N-containing
    sequence."""
    seq = "ACGT" * 20 + "N" + "ACGT" * 20
    graph = build_graph("n", seq, [])
    rr = build_region_runs(graph, "n", [(0, len(seq))], 19)
    got = compute_results_runs(
        [ctcf], rr, threshold=1.0, recomb=True
    )[ctcf.motif_id]
    assert not any("N" in s for s in got["matched_sequence"])
    batch = extract_region(graph, 0, len(seq), 19, chrom_display="n")
    want = compute_results(ctcf, [batch], threshold=1.0, recomb=True)
    pd.testing.assert_frame_equal(_canon(got), _canon(want), check_exact=True)
    # histograms count the N windows at min_score even though they are
    # never reported
    from grafimo_tpu.models.pvalue import PvalueLookup

    lookup = PvalueLookup(ctcf.pval_table)
    assert lookup.pvalue(ctcf.min_score) == 1.0


def test_runscan_fetch_tiers(toy_graph, ctcf, monkeypatch):
    """The block-fetch machinery must be exact across all three hit-fetch
    tiers (speculative SMALLK indices / per-slice top-k fetch / full
    bitmask fallback) and across multiple flush blocks."""
    import grafimo_tpu.runscan as rs

    batch = extract_region(toy_graph, 0, 50, 19, chrom_display="x")
    want = compute_results(ctcf, [batch], threshold=1.0, recomb=True)
    for smallk, topk, flush in [(2, 4, 1), (4, 64, 2), (1, 2, 3)]:
        monkeypatch.setattr(rs, "SCAN_SMALLK", smallk)
        monkeypatch.setattr(rs, "SCAN_TOPK", topk)
        monkeypatch.setattr(rs, "SCAN_FLUSH_SLICES", flush)
        monkeypatch.setattr(rs, "MAX_BASES_PER_DISPATCH", 64)
        rr = build_region_runs(toy_graph, "x", [(0, 50)], 19)
        got = compute_results_runs(
            [ctcf], rr, threshold=1.0, recomb=True
        )[ctcf.motif_id]
        pd.testing.assert_frame_equal(
            _canon(got), _canon(want), check_exact=True
        )


def test_qvalue_threshold_single_pass(toy_graph, ctcf, monkeypatch):
    """--qvalueT derives q-cutoffs from the SAME pass's histogram (q >= p
    under BH, so the p-cutoff superset covers every q < t hit) — no
    hist-only pre-pass re-uploading every batch."""
    import grafimo_tpu.runscan as rs

    calls = []
    real = rs.scan_batches

    def counting(*args, **kwargs):
        calls.append(kwargs.get("collect_hits", True))
        return real(*args, **kwargs)

    monkeypatch.setattr(rs, "scan_batches", counting)
    rr = build_region_runs(toy_graph, "x", [(0, 50)], 19)
    rs.compute_results_runs([ctcf], rr, threshold=0.95, qval_t=True,
                            recomb=True)
    assert calls == [True]


def test_reconstruct_hits_batch_matches_scalar(toy_graph):
    """The vectorised report reconstructor equals reconstruct_hit
    field-for-field on every window of every run type (backbone, cluster
    combinations)."""
    from grafimo_tpu.graph.runs import (
        reconstruct_hit,
        reconstruct_hits_batch,
        region_runs,
    )

    k = 19
    for run in region_runs(toy_graph, 0, 50, k):
        offs = np.nonzero(run.valid)[0]
        if not len(offs):
            continue
        begins, ends, seq_bytes, is_ref, freqs = reconstruct_hits_batch(
            toy_graph, run, offs, k
        )
        for i, o in enumerate(offs.tolist()):
            hit = reconstruct_hit(toy_graph, run, o, k)
            assert int(begins[i]) == hit.begin
            assert int(ends[i]) == hit.end
            assert seq_bytes[i].tobytes().decode("ascii") == hit.seq
            assert bool(is_ref[i]) == hit.is_ref
            assert int(freqs[i]) == hit.freq


def test_batch_wire_stats_categories(toy_graph, ctcf):
    """Wire accounting covers every batch row exactly once and splits by
    residency category (ROADMAP item 1's measurement gate)."""
    from grafimo_tpu.runscan import (
        _format_wire_stats,
        batch_runs,
        batch_wire_stats,
    )

    k = ctcf.width
    rrs = build_region_runs(toy_graph, "x", [(0, 45)], k)
    batches = batch_runs(rrs, k)
    stats = batch_wire_stats(batches, k)
    assert sum(s["rows"] for s in stats.values()) == sum(
        len(b.chunks) for b in batches
    )
    assert all(s["bytes"] >= 0 for s in stats.values())
    # the toy graph has a resident backbone row and cluster rows
    assert stats["backbone"]["rows"] > 0
    line = _format_wire_stats(stats)
    assert line.startswith("wire: ") and "backbone" in line


def test_topk_row_overflow_forces_bitmask_tier():
    """A row holding more hits than the per-row slot capacity must report
    n_hits past topk so the caller takes the exact bitmask fallback; rows
    within capacity compact exactly and in ascending order."""
    import jax.numpy as jnp

    from grafimo_tpu.ops.score_runs import (
        _ROW_SLOTS,
        _topk_package,
        pack_bits,
        unpack_hitbits,
    )

    noff, m = 130, 1
    topk = 4096
    rng = np.random.default_rng(11)

    def package(mask):
        hitbits = jnp.asarray(pack_bits(mask[:, :, 0]))[:, :, None]
        hist = jnp.zeros((8, m), jnp.int32)
        _h, _hb, nh, top = _topk_package(
            hist, hist, hitbits, noff, m, topk
        )
        return int(nh), np.asarray(top)

    # sparse: a few hits per row, exact ascending compaction
    mask = np.zeros((6, noff, m), bool)
    mask[rng.integers(0, 6, 17), rng.integers(0, noff, 17), 0] = True
    nh, top = package(mask)
    want = np.flatnonzero(mask.reshape(-1))
    assert nh == len(want)
    np.testing.assert_array_equal(top[:nh] - 1, want)
    # overflow: one row exceeds the slot capacity while total <= topk
    mask2 = np.zeros((6, noff, m), bool)
    mask2[2, : _ROW_SLOTS + 3, 0] = True
    nh2, _ = package(mask2)
    assert nh2 > topk  # bitmask tier
    # the packed bits themselves stay exact for the fallback
    rt = unpack_hitbits(
        np.asarray(jnp.asarray(pack_bits(mask2[:, :, 0]))[:, :, None]),
        noff,
    )
    np.testing.assert_array_equal(rt, mask2)


def test_topk_package_tiered_matches_flat():
    """The byte-tiered hit compaction must reproduce the flat bit-space
    reference exactly: identical (hist, hitbits, n_hits) always, and
    identical top_vals whenever no row overflows its slot capacity (on
    overflow both report n_hits > topk and the caller takes the bitmask
    tier without reading top_vals)."""
    import jax.numpy as jnp

    from grafimo_tpu.ops.score_runs import (
        _ROW_SLOTS,
        _topk_package_flat,
        _topk_package_tiered,
        pack_bits,
    )

    rng = np.random.default_rng(7)
    cases = []
    for b, noff, m, p in [
        (8, 130, 1, 0.02),   # noff % 8 != 0
        (16, 64, 2, 0.05),   # multi-motif: candidate order needs the sort
        (4, 200, 3, 0.01),
        (8, 96, 2, 0.0),     # empty slice
        (8, 40, 2, 0.6),     # dense: total > topk, rows overflow
    ]:
        mask = rng.random((b, noff, m)) < p
        cases.append((mask, noff, m))
    # adversarial m=2 ordering case: early offsets on motif 1 only, later
    # offsets on motif 0 — ascending flat order interleaves the motifs
    mask = np.zeros((4, 64, 2), bool)
    mask[1, 0:8, 1] = True
    mask[1, 3:11, 0] = True
    cases.append((mask, 64, 2))
    # exactly at capacity / one over capacity
    for extra in (0, 1):
        mask = np.zeros((3, 300, 2), bool)
        idx = rng.choice(600, _ROW_SLOTS + extra, replace=False)
        mask[1].reshape(-1)[idx] = True
        cases.append((mask, 300, 2))

    topk = 256
    for mask, noff, m in cases:
        b = mask.shape[0]
        pad = (-noff) % 8
        mp = np.pad(mask, ((0, 0), (0, pad), (0, 0)))
        hitbits = jnp.asarray(
            np.stack(
                [pack_bits(mp[:, :, mi]) for mi in range(m)], axis=2
            )
        )
        hist = jnp.asarray(
            rng.integers(0, 100, (16, m)).astype(np.int32)
        )
        acc = jnp.zeros((16, m), jnp.int32)
        rf = _topk_package_flat(acc, hist, hitbits, noff, m, topk)
        rt = _topk_package_tiered(acc, hist, hitbits, noff, m, topk)
        np.testing.assert_array_equal(np.asarray(rf[0]), np.asarray(rt[0]))
        np.testing.assert_array_equal(np.asarray(rf[1]), np.asarray(rt[1]))
        assert int(rf[2]) == int(rt[2])
        per_row = mask.reshape(b, -1).sum(axis=1)
        if (per_row <= _ROW_SLOTS).all():
            np.testing.assert_array_equal(
                np.asarray(rf[3]), np.asarray(rt[3])
            )
            # and both match the oracle when within the compact tier
            if int(rf[2]) <= topk:
                want = np.flatnonzero(mask.reshape(-1))
                got = np.asarray(rt[3])
                got = got[got > 0] - 1
                np.testing.assert_array_equal(got, want)


def test_window_scores_select_matches_conv():
    """The select/LUT formulation and the conv must agree bit-for-bit
    (the default is hardware-measured, score_runs.py SELECT_CONV_MAX_M;
    both stay correct)."""
    import jax.numpy as jnp

    import grafimo_tpu.ops.score_runs as sr

    rng = np.random.default_rng(13)
    k = 11
    codes = jnp.asarray(rng.integers(0, 4, (8, 64)).astype(np.uint8)
                        .astype(np.int32))
    pwm = jnp.asarray(
        rng.integers(0, 1000, (k, 4, 3)).astype(np.float32)
    )
    old = sr.SELECT_CONV_MAX_M
    try:
        sr.SELECT_CONV_MAX_M = 16
        got_select = np.asarray(sr._window_scores(codes, pwm, k))
        sr.SELECT_CONV_MAX_M = 0
        got_conv = np.asarray(sr._window_scores(codes, pwm, k))
    finally:
        sr.SELECT_CONV_MAX_M = old
    np.testing.assert_array_equal(got_select, got_conv)
    # host oracle
    c = np.asarray(codes)
    p = np.asarray(pwm).astype(np.int64)
    want = np.zeros_like(got_conv, dtype=np.int64)
    for o in range(64 - k + 1):
        for j in range(k):
            want[:, o, :] += p[j, c[:, o + j], :]
    np.testing.assert_array_equal(got_conv, want)


def test_score_mismatch_raises_without_retry(toy_graph, ctcf, monkeypatch):
    """The device/host exactness guard (_DeviceHostMismatch) is fatal:
    a hit whose host score is absent from the device histogram raises
    after ONE scan — a mismatch is a precision or hardware fault, and a
    rescan would only hide it."""
    import grafimo_tpu.runscan as rmod

    real_scan = rmod.scan_batches
    real_host = rmod._score_windows_host
    scans = []

    def counting(*args, **kw):
        scans.append(1)
        return real_scan(*args, **kw)

    def off_by_one(*args, **kw):
        return real_host(*args, **kw) + 1

    monkeypatch.setattr(rmod, "scan_batches", counting)
    monkeypatch.setattr(rmod, "_score_windows_host", off_by_one)
    rr = build_region_runs(toy_graph, "x", [(0, 50)], ctcf.width)
    with pytest.raises(rmod._DeviceHostMismatch):
        compute_results_runs([ctcf], rr, threshold=1.0, recomb=True)
    assert scans == [1]
