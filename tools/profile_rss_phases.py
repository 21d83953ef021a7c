"""Phase-wise host-RSS attribution for the findmotif pipeline.

Nothing bounds findmotif's host-side accumulation at chromosome scale,
so its RSS grows with chromosome length.  This tool
synthesises a pocketed 1KGP-profile chromosome (same generator as
bench_chrom_scale), builds the graph, then walks the findmotif phases
IN PROCESS on the CPU backend with a sampling thread reading
/proc/self/status, printing peak RSS deltas per phase plus the sizes
of the dominant structures — the measurement that decides WHERE the
streaming cut must go before any code moves.

Usage: python tools/profile_rss_phases.py [--mbp 10] [--skip-scan]
"""

import argparse
import gc
import os
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


class PeakSampler:
    def __init__(self):
        self.peak = rss_mb()
        self._stop = False
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        while not self._stop:
            self.peak = max(self.peak, rss_mb())
            time.sleep(0.05)

    def reset(self):
        self.peak = rss_mb()

    def stop(self):
        self._stop = True


def deep_nbytes(obj, seen=None) -> int:
    """numpy-array bytes reachable from obj (dataclasses/lists/dicts)."""
    if seen is None:
        seen = set()
    oid = id(obj)
    if oid in seen:
        return 0
    seen.add(oid)
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    total = 0
    if isinstance(obj, dict):
        for v in obj.values():
            total += deep_nbytes(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            total += deep_nbytes(v, seen)
    elif hasattr(obj, "__dict__"):
        for v in vars(obj).values():
            total += deep_nbytes(v, seen)
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=10.0)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "grafimo_rssprof"))
    ap.add_argument("--skip-scan", action="store_true")
    ap.add_argument("--reuse", action="store_true")
    ap.add_argument("--budget-mb", type=int, default=0,
                    help="GRAFIMO_HOST_BUDGET_MB for the batch phase")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.budget_mb:
        os.environ["GRAFIMO_HOST_BUDGET_MB"] = str(args.budget_mb)

    from tools.bench_chrom_scale import (
        make_variants,
        synth_chrom,
        write_fasta,
        write_vcf,
    )

    os.makedirs(args.workdir, exist_ok=True)
    L = int(args.mbp * 1e6)
    H = 5096
    fa = os.path.join(args.workdir, f"chr_{args.mbp}.fa")
    vcf = os.path.join(args.workdir, f"chr_{args.mbp}.vcf.gz")
    gdir = os.path.join(args.workdir, f"graph_{args.mbp}")
    sampler = PeakSampler()

    def phase(name, fn):
        gc.collect()
        base = rss_mb()
        sampler.reset()
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        gc.collect()
        end = rss_mb()
        print(
            f"[{name:<28}] {dt:8.1f}s  rss {base:8.0f} -> {end:8.0f} MB"
            f"  (peak {max(sampler.peak, end):8.0f} MB)",
            flush=True,
        )
        return out

    if not (args.reuse and os.path.isfile(fa) and os.path.isfile(vcf)):
        rng = np.random.default_rng(0)
        seq, pos, _ = synth_chrom(rng, L, H)
        variants, n_indel = make_variants(rng, seq, pos, H)
        print(f"synth: {len(variants)} variants ({n_indel} indels)")
        phase("write fasta", lambda: write_fasta(fa, "chrP", seq))
        phase("write vcf", lambda: write_vcf(vcf, "chrP", seq, variants, H))
        del seq, pos, variants

    from grafimo_tpu.config import BuildVG
    from grafimo_tpu.workflows import buildvg

    if not (args.reuse and os.path.isdir(gdir)):
        phase(
            "buildvg",
            lambda: buildvg(
                BuildVG(reference_genome=fa, vcf=vcf, outdir=gdir)
            ),
        )

    from grafimo_tpu.models.parse import load_motifs
    from grafimo_tpu.utils.constants import UNIF
    from grafimo_tpu.workflows import load_graph_file

    gvt = [
        os.path.join(gdir, f)
        for f in os.listdir(gdir)
        if ".gvt" in f
    ][0]
    graph = phase("load graph", lambda: load_graph_file(gvt))
    motif = load_motifs(
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tests", "data", "input", "MA0139.1.meme",
        ),
        UNIF, 0.1, False,
    )[0]
    k = motif.width

    from grafimo_tpu.runscan import (
        batch_runs,
        batch_wire_stats,
        build_region_runs,
        compute_results_runs,
    )

    rrs = phase(
        "build_region_runs",
        lambda: build_region_runs(graph, "chrP", [(0, len(graph.seq))], k),
    )
    batches = phase(
        "batch_runs", lambda: batch_runs(rrs, k, threads=2)
    )
    n_rows = sum(
        (b.gstart.shape[0] if b.gstart is not None else b.packed.shape[0])
        for b in batches
    )
    n_chunks = sum(len(b.chunks) for b in batches)
    arr_mb = sum(deep_nbytes(b) for b in batches) / 1e6
    print(
        f"  batches: {len(batches)}, rows {n_rows}, chunks {n_chunks}, "
        f"array bytes {arr_mb:.0f} MB"
    )
    # RunChunk object overhead estimate
    import sys as _s

    if n_chunks:
        c = batches[0].chunks[0]
        per = (
            _s.getsizeof(c)
            + _s.getsizeof(c.source)
            + _s.getsizeof(c.source[1])
        )
        print(
            f"  chunk obj est: {per} B/chunk -> {per * n_chunks / 1e6:.0f}"
            " MB total"
        )
    cache_runs = sum(len(rr._run_cache) for rr in rrs)
    cache_mb = sum(deep_nbytes(rr._run_cache) for rr in rrs) / 1e6
    seq_mb = sum(
        len(run.seq)
        for rr in rrs
        for run in rr._run_cache.values()
        if hasattr(run, "seq") and run.seq
    ) / 1e6
    print(
        f"  run caches: {cache_runs} runs, arrays {cache_mb:.0f} MB, "
        f"seq strings {seq_mb:.0f} MB"
    )
    pay_mb = sum(
        deep_nbytes(rr.payloads) for rr in rrs if rr.payloads
    ) / 1e6
    print(f"  payloads: {pay_mb:.0f} MB")
    print("  " + str(batch_wire_stats(batches, k))[:300])

    if not args.skip_scan:
        del batches
        gc.collect()
        res = phase(
            "compute_results_runs",
            lambda: compute_results_runs(
                [motif], rrs, threshold=1e-4, verbose=False, cores=2
            ),
        )
        for name, df in res.items():
            print(f"  results {name}: {len(df)} hits")
    sampler.stop()
    print(f"final rss {rss_mb():.0f} MB")


if __name__ == "__main__":
    main()
