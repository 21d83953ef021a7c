"""Differential test: C++ run builder vs the python reference builder."""

import numpy as np
import pytest

from conftest import frame
from grafimo_tpu.graph.runs import region_runs
from grafimo_tpu.graph.sitegraph import build_graph
from grafimo_tpu.io.fasta import read_fasta
from grafimo_tpu.io.vcf import iter_vcf_records

native = pytest.importorskip("grafimo_tpu.native")
try:
    native._lib()
except Exception as _e:  # pragma: no cover - env without g++/native
    pytest.skip(f"native engine unavailable: {_e}", allow_module_level=True)


def _codes_of(run):
    lut = np.full(256, 4, dtype=np.uint8)
    for i, ch in enumerate("ACGT"):
        lut[ord(ch)] = i
    return lut[np.frombuffer(run.seq.encode("ascii"), np.uint8)]


def assert_native_matches(graph, rs, re_, k):
    py_runs = region_runs(graph, rs, re_, k)
    cc = native.build_region_runs_native(graph, rs, re_, k)
    assert len(cc) == len(py_runs)
    for pr, cr in zip(py_runs, cc):
        assert cr.ref == pr.ref
        np.testing.assert_array_equal(cr.codes, _codes_of(pr))
        np.testing.assert_array_equal(cr.valid, pr.valid)


def test_native_toy_graph(input_dir):
    seqs = read_fasta(str(input_dir / "test.fa"))
    records = list(iter_vcf_records(str(input_dir / "test.vcf.gz"), "x"))
    graph = build_graph("x", seqs["x"], records)
    for rs, re_, k in [(0, 20, 19), (0, 50, 19), (5, 45, 7), (0, 50, 4)]:
        assert_native_matches(graph, rs, re_, k)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_native_random_graphs(seed):
    from tests.test_runs_differential import _random_graph

    rng = np.random.default_rng(seed)
    graph = _random_graph(rng, length=600, n_var=20, n_samples=4)
    for rs, re_, k in [(0, 600, 12), (55, 480, 9), (200, 340, 17)]:
        assert_native_matches(graph, rs, re_, k)


def test_native_dense_snp_chain():
    """2^17-combination SNP chain: the native candidate DFS must emit the
    identical run set as the python spec (no region-level fallback)."""
    from tests.test_runs_differential import _dense_snp_graph

    graph = _dense_snp_graph()
    assert_native_matches(graph, 0, 220, 10)


def test_native_runs_through_scan(input_dir):
    """End-to-end: the run-scan engine with native payloads must equal the
    python-payload result."""
    import pandas as pd

    from grafimo_tpu.models.parse import load_motifs
    from grafimo_tpu.runscan import build_region_runs, compute_results_runs
    from grafimo_tpu.utils.constants import UNIF

    seqs = read_fasta(str(input_dir / "test.fa"))
    records = list(iter_vcf_records(str(input_dir / "test.vcf.gz"), "x"))
    graph = build_graph("x", seqs["x"], records)
    motif = load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1, False)[0]
    rr = build_region_runs(graph, "x", [(0, 50)], 19)
    # ensure the native path actually produced the payloads
    assert all(not r._run_cache for r in rr)
    got = compute_results_runs([motif], rr, threshold=1.0, recomb=True)[
        motif.motif_id
    ]
    assert len(got) > 0


def test_native_batcher_matches_python_batcher(input_dir, monkeypatch):
    """The C++ batch pipeline (incl. native patch-descriptor emission)
    and the pure-python path must cover the same chunks with the same
    residency categorisation and produce identical scan results."""
    import pandas as pd

    from grafimo_tpu.models.parse import load_motifs
    from grafimo_tpu.runscan import (
        batch_runs,
        batch_wire_stats,
        build_region_runs,
        compute_results_runs,
    )
    from grafimo_tpu.utils.constants import UNIF

    seqs = read_fasta(str(input_dir / "test.fa"))
    records = list(iter_vcf_records(str(input_dir / "test.vcf.gz"), "x"))
    motif = load_motifs(
        str(input_dir / "MA0139.1.meme"), UNIF, 0.1, False
    )[0]
    k = motif.width
    outs = {}
    for label, disable in [("native", None), ("python", "1")]:
        if disable:
            monkeypatch.setenv("GRAFIMO_TPU_NO_NATIVE", disable)
            import grafimo_tpu.native as nat

            monkeypatch.setattr(nat, "_LIB", None)
            monkeypatch.setattr(
                nat, "_LIB_ERR",
                RuntimeError("disabled for differential test"),
            )
        graph = build_graph("x", seqs["x"], records)
        rrs = build_region_runs(graph, "x", [(0, 50), (5, 45)], k)
        batches = batch_runs(rrs, k)
        stats = batch_wire_stats(batches, k)
        chunks = sorted(
            (c.source, c.chunk_off, b.R, b.patches is not None)
            for b in batches
            for c in b.chunks
        )
        rrs2 = build_region_runs(graph, "x", [(0, 50), (5, 45)], k)
        df = compute_results_runs(
            [motif], rrs2, threshold=1.0, recomb=True
        )[motif.motif_id]
        outs[label] = (stats, chunks, df)
    assert outs["native"][0] == outs["python"][0]
    assert outs["native"][1] == outs["python"][1]
    a = frame(outs["native"][2]).sort_values(
        ["p-value", "start", "stop", "strand", "matched_sequence"]
    ).reset_index(drop=True)
    b = frame(outs["python"][2]).sort_values(
        ["p-value", "start", "stop", "strand", "matched_sequence"]
    ).reset_index(drop=True)
    pd.testing.assert_frame_equal(a, b, check_exact=True)
