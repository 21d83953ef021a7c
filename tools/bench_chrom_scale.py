"""Chromosome-scale synthetic validation (BASELINE configs 2/4 class).

No input is downloaded, so the 1KGP chromosome is synthesised at the
real profile (reference workload: hg38 + ~78M
variants of 2548 individuals, BASELINE.md): variant density 1/30 bp,
12% indels (geometric lengths, 55/45 del/ins), rare-skewed allele
frequencies (beta(0.2, 1.8), singletons forced like real VCFs),
5096 haplotypes (2548 diploid samples), plus MHC-like dense pockets at
5x density.  The run then exercises the REAL user path end to end:

1. write the chromosome FASTA and a bgzipped (BGZF) VCF with 2548
   diploid sample columns;
2. ``buildvg`` through the CLI in a subprocess (native threaded VCF
   scanner + graph build + ``.gvt`` save), peak RSS recorded;
3. whole-chromosome CTCF (MA0139.1) ``findmotif`` through the CLI on
   the default backend (one region spanning the chromosome — the
   ``MAX_BASES_PER_DISPATCH`` slicing path), peak RSS + wall recorded;
4. a rerun of the scan, asserting identical hit counts (determinism);
5. optionally ``--dir N``: N more chromosomes into one directory and a
   multi-graph directory scan with globally merged q-values.

Prints ONE JSON line with every measured number.  ``chip_smoke.py``
reuses the generator below.

Usage (one process on the accelerator at a time):

    timeout 7200 python tools/bench_chrom_scale.py [--mbp 50]
        [--dir 0] [--dir-mbp 8] [--workdir DIR]
        [--cpu-scan]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from grafimo_tpu.graph.vgproto import _bgzf_block  # noqa: E402

BASES = np.frombuffer(b"ACGT", np.uint8)
K = 19


def synth_chrom(rng, L: int, H: int, pockets: int = 3):
    """Sequence codes + variant tuples at the 1KGP profile with
    ``pockets`` MHC-like dense windows (5x density over 200 kb)."""
    seq = rng.integers(0, 4, L).astype(np.uint8)
    density = np.full(L, 1 / 30.0)
    pocket_spans = []
    for i in range(pockets):
        c = int((i + 1) * L / (pockets + 1))
        lo, hi = max(1, c - 100_000), min(L - 100, c + 100_000)
        density[lo:hi] *= 5
        pocket_spans.append((lo, hi))
    pos = np.flatnonzero(rng.random(L) < density)
    pos = pos[(pos > 1) & (pos < L - 30)]
    return seq, pos, pocket_spans


def make_variants(rng, seq, pos, H):
    """Per-site (pos0, ref, alt, carriers) tuples; 12% indels."""
    out = []
    last = 0
    n_indel = 0
    afs = rng.beta(0.2, 1.8, len(pos))
    kinds = rng.random(len(pos))
    for i, p in enumerate(pos):
        p = int(p)
        if p < last:
            continue
        # 1KGP-like site frequency spectrum: ~55% singleton/very-rare
        # (2504-sample 1KGP has ~64% MAF<0.5%), the rest beta-skewed
        if rng.random() < 0.55:
            n_car = int(rng.geometric(0.5))  # 1, 2, 3... halving
        else:
            af = float(afs[i])
            n_car = min(H, max(1, int(round(af * H))))
        if n_car < H // 8:
            # rare variant: sample with replacement + dedup (collision
            # odds tiny; avoids numpy choice's O(H) permutation)
            carriers = np.unique(rng.integers(0, H, n_car))
        else:
            carriers = rng.choice(H, size=n_car, replace=False)
        if kinds[i] < 0.12:
            ln = min(12, 1 + int(rng.geometric(0.45)))
            if rng.random() < 0.55 and p + ln + 1 < len(seq):  # deletion
                ref = seq[p - 1 : p + ln]
                alt = ref[:1]
                last = p + ln
            else:  # insertion
                ref = seq[p - 1 : p]
                alt = np.concatenate([ref, rng.integers(0, 4, ln)])
                last = p + 1
            n_indel += 1
        else:
            ref = seq[p : p + 1]
            alt = np.array([(int(seq[p]) + 1) % 4], np.uint8)
            last = p + 1
        out.append((p, ref, alt, carriers))
    return out, n_indel


def write_fasta(path, name, seq):
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        txt = BASES[seq].tobytes()
        for i in range(0, len(txt), 60):
            f.write(txt[i : i + 60] + b"\n")


class BgzfWriter:
    def __init__(self, path):
        self.f = open(path, "wb")
        self.buf = bytearray()

    def write(self, b: bytes):
        self.buf += b
        while len(self.buf) >= 60000:
            self.f.write(_bgzf_block(bytes(self.buf[:60000]), level=1))
            del self.buf[:60000]

    def close(self):
        if self.buf:
            self.f.write(_bgzf_block(bytes(self.buf), level=1))
        self.f.write(_bgzf_block(b""))  # EOF marker
        self.f.close()


def write_vcf(path, chrom, seq, variants, H):
    """BGZF VCF with 2548 diploid phased sample columns."""
    n_s = H // 2
    w = BgzfWriter(path)
    w.write(b"##fileformat=VCFv4.2\n")
    w.write(
        ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
         + "\t".join(f"s{i}" for i in range(n_s)) + "\n").encode()
    )
    # template row of 0|0 genotypes; carriers patched per record:
    # sample j's field "0|0\t" sits at bytes [4j, 4j+4) — haplotype h
    # (sample h//2, allele h%2) is byte 4*(h//2) + 2*(h%2)
    template = np.frombuffer(b"0|0\t" * n_s, np.uint8).copy()
    template[-1] = 0x0A  # newline ends the row
    for p, ref, alt, carriers in variants:
        # indels anchor at 0-based p-1 (1-based p); SNPs at p (p+1)
        pos1 = p if len(ref) > 1 or len(alt) > 1 else p + 1
        head = (
            f"{chrom}\t{pos1}\t.\t{BASES[ref].tobytes().decode()}\t"
            f"{BASES[alt].tobytes().decode()}\t99\tPASS\t.\tGT\t"
        ).encode()
        row = template.copy()
        row[4 * (carriers // 2) + 2 * (carriers % 2)] = 0x31  # '1'
        w.write(head)
        w.write(row.tobytes())
    w.close()


def run_cli(args, backend=None, timeout=7200):
    """Run the CLI in a subprocess; returns (rc, seconds, maxrss_kb)."""
    prog = (
        "import sys, resource\n"
        + (
            "import jax\njax.config.update('jax_platforms', "
            f"'{backend}')\n" if backend else ""
        )
        + "from grafimo_tpu.cli import main\n"
        "rc = main(sys.argv[1:])\n"
        "print('MAXRSS_KB',"
        " resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,"
        " file=sys.stderr)\n"
        "sys.exit(rc)\n"
    )
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", prog, *args],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=timeout,
    )
    dt = time.perf_counter() - t0
    rss = None
    for ln in proc.stderr.splitlines():
        if ln.startswith("MAXRSS_KB"):
            rss = int(ln.split()[1])
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:])
        raise RuntimeError(f"CLI failed rc={proc.returncode}: {args[:4]}")
    return dt, rss, proc.stderr + proc.stdout


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=50.0)
    ap.add_argument("--dir", type=int, default=0,
                    help="additional chromosomes for a directory scan")
    ap.add_argument("--dir-mbp", type=float, default=8.0)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "grafimo_scale"))
    ap.add_argument("--cpu-scan", action="store_true",
                    help="findmotif on the CPU backend (debug)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bed-span", type=int, default=0,
                    help="scan only the first N bases (0 = whole chrom)")
    ap.add_argument("--reuse", action="store_true",
                    help="reuse existing workdir inputs/graphs")
    ap.add_argument("--encode-regions", type=int, default=0,
                    help="also scan N random 270bp regions (the "
                         "reference's ENCODE-peak workload shape)")
    args = ap.parse_args()

    H = 5096
    wd = args.workdir
    os.makedirs(wd, exist_ok=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    motif = os.path.join(here, "tests", "data", "input", "MA0139.1.meme")
    rng = np.random.default_rng(args.seed)
    out = {"mbp": args.mbp, "haplotypes": H, "k": K}

    # --- synth + write inputs -------------------------------------------
    L = int(args.mbp * 1e6)
    gdir = os.path.join(wd, "graphs")
    if args.reuse and os.path.isfile(os.path.join(gdir, "21.gvt.npz")):
        out["reused"] = True
    else:
        t0 = time.perf_counter()
        seq, pos, pockets = synth_chrom(rng, L, H)
        variants, n_indel = make_variants(rng, seq, pos, H)
        out["n_variants"] = len(variants)
        out["n_indels"] = n_indel
        out["dense_pockets"] = len(pockets)
        write_fasta(os.path.join(wd, "ref.fa"), "21", seq)
        write_vcf(os.path.join(wd, "synth.vcf.gz"), "21", seq, variants,
                  H)
        out["synth_s"] = round(time.perf_counter() - t0, 1)
        out["vcf_bytes"] = os.path.getsize(
            os.path.join(wd, "synth.vcf.gz"))
        print(
            f"# synth: {len(variants)} variants ({n_indel} indels) "
            f"in {out['synth_s']}s, VCF {out['vcf_bytes']/2**20:.0f} "
            f"MiB",
            file=sys.stderr,
        )
        # buildvg (CPU backend; native VCF scanner + graph build)
        dt, rss, _ = run_cli(
            ["buildvg", "-l", os.path.join(wd, "ref.fa"),
             "-v", os.path.join(wd, "synth.vcf.gz"), "-o", gdir,
             "--reindex", "--verbose"],
            backend="cpu",
        )
        out["buildvg_s"] = round(dt, 1)
        out["buildvg_maxrss_gb"] = round((rss or 0) / 2**20, 2)
        out["gvt_bytes"] = os.path.getsize(
            os.path.join(gdir, "21.gvt.npz"))
        print(f"# buildvg: {dt:.0f}s, peak RSS "
              f"{out['buildvg_maxrss_gb']} GB", file=sys.stderr)

    # --- whole-chromosome findmotif ------------------------------------
    bed = os.path.join(wd, "whole.bed")
    span = args.bed_span or L
    with open(bed, "w") as f:
        f.write(f"chr21\t0\t{span}\n")
    backend = "cpu" if args.cpu_scan else None
    runs = []
    for rep in range(2):
        outdir = os.path.join(wd, f"out_rep{rep}")
        dt, rss, err = run_cli(
            ["findmotif", "-d", gdir, "-b", bed, "-m", motif,
             "-o", outdir, "--verbose"],
            backend=backend,
        )
        n_hits = sum(1 for _ in open(
            os.path.join(outdir, "grafimo_out.tsv"))) - 1
        windows = None
        for ln in err.splitlines():
            if "Scanned sequences" in ln:
                windows = int(ln.split()[-1])
        wire = [ln.strip() for ln in err.splitlines()
                if ln.strip().startswith("wire:")]
        runs.append({"wall_s": round(dt, 1), "hits": n_hits,
                     "windows": windows,
                     "maxrss_gb": round((rss or 0) / 2**20, 2),
                     "wire": wire[:4]})
        print(f"# findmotif rep{rep}: {dt:.0f}s, {n_hits} hits, "
              f"{windows} windows, RSS {runs[-1]['maxrss_gb']} GB",
              file=sys.stderr)
    out["scan"] = runs
    out["deterministic"] = runs[0]["hits"] == runs[1]["hits"]
    assert out["deterministic"], "hit counts differ across reruns!"

    # --- ENCODE-peak-shaped region scan (the reference's headline
    # workload: CTCF x 3000 ChIP-seq peak regions, ~270 bp each) --------
    if args.encode_regions:
        ebed = os.path.join(wd, "encode_like.bed")
        r3 = np.random.default_rng(7)
        starts = np.sort(r3.integers(0, L - 300, args.encode_regions))
        with open(ebed, "w") as f:
            for s0 in starts:
                f.write(f"chr21\t{int(s0)}\t{int(s0) + 270}\n")
        dt, rss, err = run_cli(
            ["findmotif", "-d", gdir, "-b", ebed, "-m", motif,
             "-o", os.path.join(wd, "out_encode"), "--verbose"],
            backend=backend,
        )
        n_hits = sum(1 for _ in open(
            os.path.join(wd, "out_encode", "grafimo_out.tsv"))) - 1
        windows = None
        for ln in err.splitlines():
            if "Scanned sequences" in ln:
                windows = int(ln.split()[-1])
        out["encode_scan"] = {
            "regions": args.encode_regions, "wall_s": round(dt, 1),
            "hits": n_hits, "windows": windows,
            "maxrss_gb": round((rss or 0) / 2**20, 2),
        }
        print(f"# encode-like scan: {dt:.0f}s, {n_hits} hits, "
              f"{windows} windows", file=sys.stderr)

    # --- directory scan with globally merged q-values -------------------
    if args.dir:
        t0 = time.perf_counter()
        names = []
        for i in range(args.dir):
            Ld = int(args.dir_mbp * 1e6)
            # pocket-free: the main chromosome exercises the MHC-like
            # pockets; the directory leg measures multi-graph merge
            sq, ps, _ = synth_chrom(rng, Ld, H, pockets=0)
            vs, _ni = make_variants(rng, sq, ps, H)
            nm = f"d{i+1}"
            write_fasta(os.path.join(wd, f"{nm}.fa"), nm, sq)
            write_vcf(os.path.join(wd, f"{nm}.vcf.gz"), nm, sq, vs, H)
            run_cli(
                ["buildvg", "-l", os.path.join(wd, f"{nm}.fa"),
                 "-v", os.path.join(wd, f"{nm}.vcf.gz"), "-o", gdir],
                backend="cpu",
            )
            names.append((nm, Ld))
        out["dir_build_s"] = round(time.perf_counter() - t0, 1)
        dbed = os.path.join(wd, "dir.bed")
        with open(dbed, "w") as f:
            for nm, Ld in names:
                f.write(f"chr{nm}\t0\t{Ld}\n")
        dt, rss, err = run_cli(
            ["findmotif", "-d", gdir, "-b", dbed, "-m", motif,
             "-o", os.path.join(wd, "out_dir"), "--verbose"],
            backend=backend,
        )
        n_hits = sum(1 for _ in open(
            os.path.join(wd, "out_dir", "grafimo_out.tsv"))) - 1
        out["dir_scan"] = {
            "chroms": args.dir, "mbp_each": args.dir_mbp,
            "wall_s": round(dt, 1), "hits": n_hits,
            "maxrss_gb": round((rss or 0) / 2**20, 2),
        }
        print(f"# dir scan ({args.dir} graphs): {dt:.0f}s, "
              f"{n_hits} hits", file=sys.stderr)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
