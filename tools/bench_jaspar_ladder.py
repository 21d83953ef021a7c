"""End-to-end JASPAR-CORE-scale mixed-width ladder benchmark.

BASELINE.json config 5 is "all of JASPAR CORE vertebrates (~800 PWMs,
widths ~6-30) against a pangenome".  The real file cannot be fetched
offline, so this synthesises 800 PWMs drawn from
JASPAR CORE vertebrates' published width histogram (mode 10-12, median
~11, 5% tail above 21) with realistic per-column information content,
writes ONE multi-motif MEME file, and runs the REAL ``findmotif``
workflow over a synthetic pangenome chromosome: per-width extraction
passes shared by all same-width motifs (reference ``grafimo.py:176``,
``motif_set.py:97-102``), device-resident scans, exact per-motif
q-values, one report per motif.

Timed: motif processing, per-width ladder, total wall; prints
window-strand-motif/s.

Run alone on the accelerator:

    timeout 7200 python -u tools/bench_jaspar_ladder.py [Mbp] [n_motifs]
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# JASPAR CORE vertebrates width histogram (approximate, JASPAR 2020
# non-redundant vertebrates, 746 profiles): P(width)
WIDTH_PMF = {
    6: 0.02, 7: 0.03, 8: 0.07, 9: 0.07, 10: 0.12, 11: 0.14, 12: 0.11,
    13: 0.08, 14: 0.08, 15: 0.09, 16: 0.05, 17: 0.04, 18: 0.03,
    19: 0.02, 20: 0.015, 21: 0.015, 22: 0.01, 23: 0.008, 24: 0.007,
    25: 0.005, 26: 0.004, 28: 0.003, 30: 0.003,
}


def synth_meme(path: str, n_motifs: int, rng) -> dict:
    """Write ``n_motifs`` synthetic PWMs as one MEME file; returns the
    width histogram."""
    widths = list(WIDTH_PMF)
    probs = np.array([WIDTH_PMF[w] for w in widths])
    probs = probs / probs.sum()
    lines = [
        "MEME version 4", "",
        "ALPHABET= ACGT", "",
        "strands: + -", "",
        "Background letter frequencies (from uniform background):",
        "A 0.25000 C 0.25000 G 0.25000 T 0.25000", "",
    ]
    histo = {}
    for i in range(n_motifs):
        k = int(rng.choice(widths, p=probs))
        histo[k] = histo.get(k, 0) + 1
        nsites = int(rng.integers(20, 5000))
        lines.append(f"MOTIF M{i:04d} TF{i:04d}")
        lines.append(
            "letter-probability matrix: alength= 4 w= "
            f"{k} nsites= {nsites} E= 0"
        )
        # realistic IC profile: strong core, fuzzy flanks
        for j in range(k):
            edge = min(j, k - 1 - j) / max(1, (k - 1) / 2)
            conc = 0.15 + 2.5 * edge  # low conc = peaky column
            p = rng.dirichlet([conc] * 4)
            p = np.maximum(p, 1e-4)
            p = p / p.sum()
            lines.append(" ".join(f"{x:.6f}" for x in p))
        lines.append("")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
    return histo


def main() -> None:
    mbp = float(sys.argv[1]) if len(sys.argv) > 1 else 10.0
    n_motifs = int(sys.argv[2]) if len(sys.argv) > 2 else 800
    L = int(mbp * 1_000_000)
    H = 5096
    rng = np.random.default_rng(0)

    from grafimo_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from grafimo_tpu.graph.sitegraph import build_graph
    from grafimo_tpu.io.vcf import VcfRecord
    from grafimo_tpu.models.parse import load_motifs
    from grafimo_tpu.runscan import build_region_runs, compute_results_runs
    from grafimo_tpu.utils.constants import UNIF

    meme_path = os.path.join(tempfile.gettempdir(), "jaspar_core_like.meme")
    histo = synth_meme(meme_path, n_motifs, rng)
    all_widths = sorted(sum([[w] * c for w, c in histo.items()], []))
    print(
        f"{n_motifs} PWMs over {len(histo)} widths "
        f"(median {int(np.median(all_widths))})",
        file=sys.stderr,
    )

    t0 = time.perf_counter()
    motifs = load_motifs(meme_path, UNIF, 0.1, False)
    t_process = time.perf_counter() - t0
    print(
        f"motif processing (parse + log-odds + Staden DP x{n_motifs}): "
        f"{t_process:.1f}s",
        file=sys.stderr,
    )

    t0 = time.perf_counter()
    seq = rng.integers(0, 4, L).astype(np.uint8).tobytes().translate(
        bytes.maketrans(bytes(range(4)), b"ACGT")
    ).decode()
    positions = np.sort(
        rng.choice(np.arange(1, L - 10), L // 30, replace=False)
    )
    keep = np.ones(len(positions), bool)
    keep[1:] = np.diff(positions) > 0
    positions = positions[keep]
    gt_all = (rng.integers(0, 7, (len(positions), H)) == 0).astype(
        np.int32
    )
    records = [
        VcfRecord(
            "c", int(p) + 1, seq[p],
            ["ACGT"[("ACGT".index(seq[p]) + 1) % 4]], gt_all[i],
        )
        for i, p in enumerate(positions)
    ]
    graph = build_graph("c", seq, records)
    print(
        f"pangenome synth + graph build ({len(records)} variants x {H} "
        f"haplotypes): {time.perf_counter() - t0:.1f}s",
        file=sys.stderr,
    )

    by_width = {}
    for mo in motifs:
        by_width.setdefault(mo.width, []).append(mo)

    total_hits = 0
    total_wsm = 0  # window-strand-motif scorings
    per_width = {}
    t_all = time.perf_counter()
    for k in sorted(by_width):
        ms = by_width[k]
        t0 = time.perf_counter()
        rr = build_region_runs(graph, "c", [(0, L)], k)
        tables = compute_results_runs(
            ms, rr, threshold=1e-6, recomb=False, verbose=False
        )
        dt = time.perf_counter() - t0
        nh = sum(len(t) for t in tables.values())
        total_hits += nh
        # windows/strand for this width ~ haplotype window mass; use the
        # scan's own counters via the hists is not returned here — use
        # the backbone approximation L - k + 1 plus combination mass is
        # already counted by compute_results_runs' printouts; keep the
        # conservative (L-k+1)*2 per motif
        wsm = (L - k + 1) * 2 * len(ms)
        total_wsm += wsm
        per_width[k] = {
            "motifs": len(ms), "s": round(dt, 1), "hits": nh,
            "gwsm_per_s": round(wsm / dt / 1e9, 3),
        }
        print(
            f"width {k:2d} x {len(ms):3d} motifs: {dt:7.1f}s  "
            f"{wsm / dt / 1e9:6.3f} G window-strand-motif/s  hits={nh}",
            file=sys.stderr, flush=True,
        )
    wall = time.perf_counter() - t_all
    print(json.dumps({
        "n_motifs": n_motifs,
        "mbp": mbp,
        "haplotypes": H,
        "widths": len(by_width),
        "motif_processing_s": round(t_process, 1),
        "ladder_wall_s": round(wall, 1),
        "total_window_strand_motif": total_wsm,
        "gwsm_per_s": round(total_wsm / wall / 1e9, 3),
        "total_hits": total_hits,
        "per_width": per_width,
    }))


if __name__ == "__main__":
    main()
