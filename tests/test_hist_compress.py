"""Exact per-column histogram compression (ops/score_runs._score_codes
``hist_bases`` + runscan expansion): the compressed device histogram,
expanded back to absolute scores, must be bit-identical to the full-range
histogram — including N-window replacement values, invalid offsets and
mixed per-column bases."""

import numpy as np
import pytest

from conftest import frame
from grafimo_tpu.graph.sitegraph import build_graph
from grafimo_tpu.io.vcf import VcfRecord
from grafimo_tpu.ops.score_runs import (
    pack_bits,
    pack_run_seqs,
    scan_runs_device_topk,
)
from grafimo_tpu.runscan import build_region_runs, compute_results_runs
from tests.test_scale_configs import _motif


def test_kernel_compressed_hist_expands_to_full():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    k = 11
    m = 6
    B, R = 16, 96
    noff = R - k + 1
    codes = rng.integers(0, 4, (B, R))
    packed = pack_run_seqs(codes)
    # some N bases and some invalid offsets
    nbits_raw = rng.random((B, R)) < 0.02
    nbits = pack_bits(nbits_raw)
    vbits_raw = rng.random((B, noff)) < 0.9
    vbits = pack_bits(vbits_raw)
    # columns with deliberately different bases: shift each PWM by a
    # different constant
    pwm = np.stack(
        [
            rng.integers(0, 400, (k, 4)) + 100 * c
            for c in range(m)
        ],
        axis=-1,
    ).astype(np.float32)
    bases = pwm.min(axis=1).sum(axis=0).astype(np.int64)
    tops = pwm.max(axis=1).sum(axis=0).astype(np.int64)
    comp_size = int((tops - bases).max()) + 2
    mins = pwm.reshape(-1, m).min(axis=0).astype(np.int32)
    cuts = np.full(m, 10**9, np.int32)
    hist_size = int(tops.max()) + 1

    full = np.asarray(
        scan_runs_device_topk(
            jnp.zeros((hist_size, m), jnp.int32), packed, nbits, vbits,
            pwm, mins, cuts, k, hist_size, 64,
        )[0]
    )
    comp = np.asarray(
        scan_runs_device_topk(
            jnp.zeros((comp_size, m), jnp.int32), packed, nbits, vbits,
            pwm, mins, cuts, k, comp_size, 64,
            hist_bases=bases.astype(np.int32),
        )[0]
    )
    expanded = np.zeros_like(full)
    for col in range(m):
        b0 = int(bases[col])
        sp = int(tops[col] - bases[col] + 1)
        expanded[int(mins[col]), col] += comp[0, col]
        expanded[b0 : b0 + sp, col] += comp[1 : 1 + sp, col]
        assert not comp[1 + sp :, col].any()
    np.testing.assert_array_equal(expanded, full)
    # sanity: N-windows actually exercised bin 0 for some column
    assert comp[0].sum() > 0
    # totals = valid windows only
    assert expanded.sum() == vbits_raw.sum() * m


@pytest.mark.parametrize("seed", [7, 8])
def test_end_to_end_compressed_equals_full(monkeypatch, seed):
    """Single-device scans (compression active) produce byte-identical
    reports and q-values to GRAFIMO_HIST_COMPRESS=off runs."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list("ACGT"), 700))
    # splice in a few N runs so N-window bins are exercised
    seq = seq[:100] + "NNNN" + seq[104:400] + "NN" + seq[402:]
    records = []
    for pos0 in sorted(rng.choice(np.arange(5, 690), 8, replace=False)):
        pos0 = int(pos0)
        ref1 = seq[pos0]
        if ref1 == "N":
            continue
        alt = rng.choice([c for c in "ACGT" if c != ref1])
        records.append(
            VcfRecord(
                chrom="h", pos=pos0 + 1, ref=ref1, alts=[alt],
                gt=[int(rng.integers(0, 2)) for _ in range(4)],
            )
        )
    graph = build_graph("h", seq, records)
    motifs = [_motif(rng, 9, "HC01"), _motif(rng, 9, "HC02")]

    monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")
    # compression is off by default; the tests force it on
    monkeypatch.setenv("GRAFIMO_HIST_COMPRESS", "force")
    rr = build_region_runs(graph, "h", [(0, graph.length)], 9)
    got = compute_results_runs(motifs, rr, threshold=0.5, recomb=True)

    monkeypatch.setenv("GRAFIMO_HIST_COMPRESS", "off")
    rr2 = build_region_runs(graph, "h", [(0, graph.length)], 9)
    want = compute_results_runs(motifs, rr2, threshold=0.5, recomb=True)

    assert set(got) == set(want)
    for mid in got:
        pd.testing.assert_frame_equal(
            frame(got[mid]), frame(want[mid]), check_exact=True
        )
        assert len(got[mid]) > 0
