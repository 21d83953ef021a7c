"""Wire-residency measurement on a realistic-indel chromosome.

ROADMAP item 1's gate: indel combinations ride the packed path (patch
descriptors only cover substitutions) — build the span-splice expansion
only if packed wire is material on REAL variant mixes.  This synthesises
a 1KGP-like chromosome (~12% indels: mostly 1-2bp, geometric tail,
~55/45 del/ins split, rare-skewed allele frequencies) and prints the
per-category host->device wire bytes (``runscan.batch_wire_stats``)
for the production resident batching, next to a SNP-only control.

CPU-only (no process opens the accelerator):

    timeout 1200 python tools/bench_indel_wire.py [Mbp]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from grafimo_tpu.graph.sitegraph import build_graph  # noqa: E402
from grafimo_tpu.io.vcf import VcfRecord  # noqa: E402
from grafimo_tpu.runscan import (  # noqa: E402
    _format_wire_stats,
    batch_runs,
    batch_wire_stats,
    build_region_runs,
)

K = 19
BASES = "ACGT"


def synth_records(rng, seq: str, H: int, indel_frac: float):
    """1KGP-like records: density 1/30bp; ``indel_frac`` of sites are
    indels (len ~ geometric(0.45), capped 12; 55% deletions), allele
    frequencies rare-skewed (beta(0.2, 1.8))."""
    L = len(seq)
    positions = np.sort(
        rng.choice(np.arange(1, L - 20), L // 30, replace=False)
    )
    records = []
    last = 0
    n_indel = 0
    for p in positions:
        p = int(p)
        if p < last:
            continue
        af = float(rng.beta(0.2, 1.8))
        gt = (rng.random(H) < af).astype(np.int32)
        if not gt.any():
            gt[int(rng.integers(0, H))] = 1  # singletons, like real VCFs
        if rng.random() < indel_frac:
            ln = min(12, 1 + int(rng.geometric(0.45)))
            if rng.random() < 0.55 and p + ln + 1 < L:  # deletion
                ref = seq[p - 1 : p + ln]
                rec = VcfRecord("c", p, ref, [ref[0]], gt)
                last = p + ln
            else:  # insertion
                ins = "".join(rng.choice(list(BASES), ln))
                rec = VcfRecord("c", p, seq[p - 1], [seq[p - 1] + ins], gt)
                last = p + 1
            n_indel += 1
        else:  # SNP
            alt = BASES[(BASES.index(seq[p]) + 1) % 4]
            rec = VcfRecord("c", p + 1, seq[p], [alt], gt)
            last = p + 1
        records.append(rec)
    return records, n_indel


def run_one(rng, seq, H, indel_frac, label):
    records, n_indel = synth_records(rng, seq, H, indel_frac)
    t0 = time.perf_counter()
    graph = build_graph("c", seq, records)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    rr = build_region_runs(graph, "c", [(0, len(seq))], K)
    batches = batch_runs(rr, K)
    t_batch = time.perf_counter() - t0
    stats = batch_wire_stats(batches, K)
    tot_b = sum(s["bytes"] for s in stats.values())
    tot_w = sum(s["windows"] for s in stats.values())
    print(
        f"[{label}] {len(records)} variants ({n_indel} indels, "
        f"{100 * n_indel / len(records):.1f}%), build {t_build:.1f}s, "
        f"batch {t_batch:.1f}s",
        file=sys.stderr,
    )
    print(f"[{label}] {_format_wire_stats(stats)}", file=sys.stderr)
    return {
        "n_variants": len(records),
        "indel_pct": round(100 * n_indel / len(records), 1),
        "wire": stats,
        "packed_wire_pct": round(
            100 * stats["packed"]["bytes"] / max(1, tot_b), 1
        ),
        "packed_window_pct": round(
            100 * stats["packed"]["windows"] / max(1, tot_w), 2
        ),
        "total_wire_mib": round(tot_b / 2**20, 2),
    }


def main() -> None:
    mbp = float(sys.argv[1]) if len(sys.argv) > 1 else 4.0
    L = int(mbp * 1_000_000)
    H = 5096
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 4, L).astype(np.uint8).tobytes().translate(
        bytes.maketrans(bytes(range(4)), b"ACGT")
    ).decode()
    out = {
        "mbp": mbp,
        "haplotypes": H,
        "k": K,
        "indel12": run_one(rng, seq, H, 0.12, "12% indels (1KGP-like)"),
        "snp_only": run_one(rng, seq, H, 0.0, "SNP-only control"),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
