"""BASELINE.json config-ladder coverage (configs 3-5, synthetic scale):
many-PWM single-pass scans, mixed widths over a 24-graph directory, and
q-values merged over the whole multi-graph hit set."""

import numpy as np
import pandas as pd
import pytest

from conftest import frame
from grafimo_tpu.cli import main
from grafimo_tpu.graph.sitegraph import build_graph
from grafimo_tpu.io.vcf import VcfRecord
from grafimo_tpu.models.background import load_bg
from grafimo_tpu.models.motif import Motif
from grafimo_tpu.models.parse import _prepare_counts_motif
from grafimo_tpu.models.process import process_motif
from grafimo_tpu.runscan import build_region_runs, compute_results_runs
from grafimo_tpu.utils.constants import UNIF


def _motif(rng, k, mid):
    counts = rng.integers(1, 50, (4, k)).astype(np.float64)
    return process_motif(
        _prepare_counts_motif(
            Motif(motif_id=mid, motif_name=mid, counts=counts, width=k),
            load_bg(UNIF, False),
            0.1,
        )
    )


def _graph(rng, chrom, length=240, n_snp=4):
    seq = "".join(rng.choice(list("ACGT"), length))
    records = []
    for pos0 in sorted(
        rng.choice(np.arange(5, length - 5), n_snp, replace=False)
    ):
        pos0 = int(pos0)
        ref1 = seq[pos0]
        alt = rng.choice([c for c in "ACGT" if c != ref1])
        gt = [int(rng.integers(0, 2)) for _ in range(4)]
        records.append(
            VcfRecord(chrom=chrom, pos=pos0 + 1, ref=ref1, alts=[alt], gt=gt)
        )
    return build_graph(chrom, seq, records)


def test_exact_hist_many_columns_matches_unrolled():
    """The lax.map histogram path (m > 8 columns) is bit-identical to the
    unrolled path."""
    import jax.numpy as jnp

    from grafimo_tpu.ops.score_runs import _exact_hist

    rng = np.random.default_rng(0)
    hist_size = 801
    scores = rng.integers(-1, hist_size, (64, 30, 12)).astype(np.int32)
    got = np.asarray(_exact_hist(jnp.asarray(scores), hist_size))
    want = np.stack(
        [
            np.bincount(
                scores[:, :, c][scores[:, :, c] >= 0], minlength=hist_size
            )
            for c in range(12)
        ],
        axis=1,
    )
    np.testing.assert_array_equal(got, want)


def test_hundred_pwm_single_pass():
    """Config 5 shape: 100 same-width PWMs (200 device columns with
    reverse complements) scanned in ONE pass; per-motif results equal the
    individual scans."""
    rng = np.random.default_rng(42)
    k = 8
    motifs = [_motif(rng, k, f"J{i:03d}") for i in range(100)]
    graph = _graph(rng, "j", length=400, n_snp=6)
    rr = build_region_runs(graph, "j", [(0, graph.length)], k)
    dfs = compute_results_runs(motifs, rr, threshold=0.05, recomb=True)
    assert set(dfs) == {m.motif_id for m in motifs}
    # sampled motifs must match their individual single-motif scans
    for mi in (0, 37, 99):
        rr2 = build_region_runs(graph, "j", [(0, graph.length)], k)
        want = compute_results_runs(
            [motifs[mi]], rr2, threshold=0.05, recomb=True
        )[motifs[mi].motif_id]
        pd.testing.assert_frame_equal(
            frame(dfs[motifs[mi].motif_id]), frame(want), check_exact=True
        )


def test_fifty_motif_mixed_width_ladder():
    """JASPAR-CORE-shaped regression: ~50 PWMs over the real width
    distribution (tools/bench_jaspar_ladder.WIDTH_PMF), scanned as the
    production per-width ladder over one pangenome graph; sampled motifs
    must equal their individual single-motif scans exactly."""
    import sys as _sys
    from pathlib import Path

    _sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from tools.bench_jaspar_ladder import WIDTH_PMF

    rng = np.random.default_rng(21)
    widths = list(WIDTH_PMF)
    probs = np.array([WIDTH_PMF[w] for w in widths])
    probs = probs / probs.sum()
    ks = rng.choice(widths, size=50, p=probs)
    motifs = [
        _motif(rng, int(k), f"L{i:02d}") for i, k in enumerate(ks)
    ]
    graph = _graph(rng, "m", length=900, n_snp=14)
    by_width = {}
    for mo in motifs:
        by_width.setdefault(mo.width, []).append(mo)
    assert len(by_width) > 5, "width mix expected"
    dfs = {}
    for k in sorted(by_width):
        rr = build_region_runs(graph, "m", [(0, 900)], k)
        dfs.update(
            compute_results_runs(
                by_width[k], rr, threshold=0.02, recomb=True
            )
        )
    assert set(dfs) == {m.motif_id for m in motifs}
    assert sum(len(d) for d in dfs.values()) > 0
    for mi in (0, 17, 43):
        mo = motifs[mi]
        rr2 = build_region_runs(graph, "m", [(0, 900)], mo.width)
        want = compute_results_runs(
            [mo], rr2, threshold=0.02, recomb=True
        )[mo.motif_id]
        pd.testing.assert_frame_equal(
            frame(dfs[mo.motif_id]), frame(want), check_exact=True
        )


def test_whole_genome_24_graph_directory(tmp_path, capsys):
    """Config 4 shape: 24 per-chromosome graphs scanned in one findmotif
    run with mixed-width motifs; q-values are computed over the hit set
    merged across ALL graphs (exact global BH from the accumulated
    histogram)."""
    rng = np.random.default_rng(7)
    gdir = tmp_path / "graphs"
    gdir.mkdir()
    chroms = [str(i) for i in range(1, 23)] + ["X", "Y"]
    bed_lines = []
    for c in chroms:
        g = _graph(rng, c)
        g.save(str(gdir / f"{c}.gvt.npz"))
        bed_lines.append(f"chr{c}\t0\t{g.length}\n")
    bed = tmp_path / "all.bed"
    bed.write_text("".join(bed_lines))
    # mixed widths: one pass per distinct width, shared across motifs
    meme = tmp_path / "two.meme"
    lines = ["MEME version 4", "", "ALPHABET= ACGT", ""]
    for mid, w in [("W9", 9), ("W13", 13)]:
        lines.append(f"MOTIF {mid}")
        lines.append(
            f"letter-probability matrix: alength= 4 w= {w} nsites= 100 E= 0"
        )
        for _ in range(w):
            p = rng.dirichlet([1.0] * 4)
            lines.append(" ".join(f"{x:.6f}" for x in p))
        lines.append("")
    meme.write_text("\n".join(lines))
    out = tmp_path / "res"
    assert main(
        [
            "findmotif",
            "-d", str(gdir),
            "-b", str(bed),
            "-m", str(meme),
            "-t", "0.5",
            "--recomb",
            "-o", str(out),
        ]
    ) == 0
    stdout = capsys.readouterr().out
    # one scan pass per width bucket -> exactly two counter lines
    assert stdout.count("Scanned sequences:") == 2
    for mid in ("W9", "W13"):
        df = pd.read_csv(
            out / f"grafimo_out_{mid}.tsv", sep="\t", index_col=0
        )
        seq_chroms = {
            s.split(":")[0] for s in df["sequence_name"].tolist()
        }
        # hits from many chromosomes in one merged, q-valued report
        assert len(seq_chroms) >= 12
        assert (df["q-value"] <= 1.0).all()
        # global BH: q-values are computed over the merged histogram, so
        # the smallest p-value's q must satisfy q >= p
        assert (df["q-value"] >= df["p-value"] - 1e-12).all()
