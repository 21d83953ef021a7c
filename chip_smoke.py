#!/usr/bin/env python3
"""Run ``findmotif`` end to end on one GPU and check that it is exact.

    python chip_smoke.py [--seed 0] [--mbp 20] [--workdir DIR]
    python chip_smoke.py --four-cards [--seed 0] [--mbp 20]

Without options every phase runs in this one process, the only one that
opens the card; helper processes run with ``JAX_PLATFORMS=cpu``:

1. device: ``jax.devices()[0].platform`` must be ``gpu``;
2. golden: ``tests/data/expected/scoring_results.tsv`` reproduced on the
   card through the per-window engine, as ``tests/test_scoring_parity.py``
   does;
3. tutorial: ``buildvg`` + ``findmotif -t 0.01`` on ``tutorials/data``
   through the CLI; TSV and GFF3 byte-identical to the same CLI run in a
   CPU child;
4. kernels: one batch of each device kind (packed, resident, patched,
   spliced, strided backbone) at B=2048, R=2048, k=19 with m=2 and m=24
   motif columns through ``runscan.scan_batches``; histograms and hits
   equal to a numpy reference that scores the same windows on the host;
5. chromosome: a seeded synthetic chromosome at the 1000 Genomes profile
   (``tools/bench_chrom_scale.py``: 5096 haplotypes, a variant every
   ~30 bp, 12% indels, three dense pockets): ``buildvg``, then CTCF
   ``findmotif -t 1e-4`` over the whole chromosome twice (identical
   reports), a 16-motif scan (32 PWM columns of one width), and a 1 Mbp
   sub-region around a pocket whose integer histograms, hits and report
   equal those of the same ``compute_results_runs`` call in a CPU child.

``--four-cards`` runs only the multi-card path and what it is compared
with: the chromosome scan on all four cards against the same scan with
``GRAFIMO_TPU_SINGLE_DEVICE=1`` (byte-identical reports, equal
histograms, no card left idle), and the ``(data, motif)`` steps of
``parallel/pipeline.py`` on 4x1 and 2x2 meshes against one device.

Precision: the window contraction is a convolution of bf16 one-hot codes
with the PWM split into two bf16-exact planes, accumulated in f32; every
partial sum is an integer below 2^24, and neither operand is f32, so no
TF32 rounding enters.  The histogram is an int32 scatter-add, exact in
any order.  Every comparison here is therefore exact: tolerance 0.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.  A failed check
raises: the script exits non-zero and prints no such line.
"""

import argparse
import contextlib
import csv
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
INPUT = os.path.join(HERE, "tests", "data", "input")
CTCF = os.path.join(INPUT, "MA0139.1.meme")
TUTORIAL = os.path.join(HERE, "tutorials", "data")
REPORTS = ("grafimo_out.tsv", "grafimo_out.gff")
H = 5096  # 2548 diploid 1000 Genomes samples
CHR22_MBP = 50.8


def check_device(devices) -> None:
    """Refuse to run anywhere but a GPU: nothing carries on on the CPU."""
    platform = devices[0].platform if devices else None
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found platform {platform!r}"
        )


def result_line(devices) -> str:
    """The last line of a passing run."""
    d = devices[0]
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": d.platform,
                "kind": d.device_kind,
                "count": len(devices),
            },
        }
    )


def compare_reports(a_dir: str, b_dir: str, names=REPORTS) -> None:
    """Require byte-identical report files; name the first differing
    line otherwise."""
    for name in names:
        with open(os.path.join(a_dir, name), "rb") as f:
            a = f.read()
        with open(os.path.join(b_dir, name), "rb") as f:
            b = f.read()
        if a == b:
            continue
        la, lb = a.split(b"\n"), b.split(b"\n")
        i = next(
            (j for j, (x, y) in enumerate(zip(la, lb)) if x != y),
            min(len(la), len(lb)),
        )
        raise AssertionError(
            f"{name} differs between {a_dir} and {b_dir} at line {i}: "
            f"{la[i] if i < len(la) else b'<end>'!r} != "
            f"{lb[i] if i < len(lb) else b'<end>'!r}"
        )


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    print(f"[{name}] ok, wall {time.perf_counter() - t0:.3f} s", flush=True)


def _ctcf():
    from grafimo_tpu.models.parse import load_motifs
    from grafimo_tpu.utils.constants import UNIF

    return load_motifs(CTCF, UNIF, 0.1, False)[0]


def run_cli(argv) -> None:
    """The CLI in this process (the one on the card)."""
    from grafimo_tpu.cli import main

    if main(list(argv) + ["--debug"]) != 0:
        raise RuntimeError(f"CLI failed: {argv}")


def run_cli_cpu(argv) -> None:
    """The same CLI in a child that never opens the card."""
    subprocess.run(
        [sys.executable, "-c",
         "import sys; from grafimo_tpu.cli import main; "
         "sys.exit(main(sys.argv[1:]))", *argv, "--debug"],
        cwd=HERE, env=dict(os.environ, JAX_PLATFORMS="cpu"), check=True,
        stdout=subprocess.DEVNULL,
    )


@contextlib.contextmanager
def record_scans(after=None):
    """Collect every ``runscan.scan_batches`` result (integer histograms
    and raw hits) of the scans run inside the block; call ``after()``
    at the end of each scan, while its device buffers are still live."""
    import grafimo_tpu.runscan as rs

    seen = []
    real = rs.scan_batches

    def recording(*args, **kwargs):
        res = real(*args, **kwargs)
        seen.append(res)
        if after is not None:
            after()
        return res

    rs.scan_batches = recording
    try:
        yield seen
    finally:
        rs.scan_batches = real


@contextlib.contextmanager
def count_pool_maps():
    """Record the result count of every ``ProcessPoolExecutor.map`` run
    inside the block (the motif pool of ``models/parse.process_motifs``
    falls back to sequential processing on any pool failure)."""
    import concurrent.futures as cf

    real = cf.ProcessPoolExecutor
    maps = []

    class Counting(real):
        def map(self, *args, **kwargs):
            out = list(super().map(*args, **kwargs))
            maps.append(len(out))
            return iter(out)

    cf.ProcessPoolExecutor = Counting
    try:
        yield maps
    finally:
        cf.ProcessPoolExecutor = real


# --- golden ---------------------------------------------------------------


def _tsv_records(path: str):
    conv = {
        "start": int, "stop": int, "haplotype_frequency": int,
        "score": float, "p-value": float, "q-value": float,
    }
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    header = rows[0][1:]
    recs = sorted(
        tuple(conv.get(h, str)(v) for h, v in zip(header, r[1:]))
        for r in rows[1:]
    )
    return header, recs


def phase_golden(wd: str) -> None:
    from grafimo_tpu.report.writer import write_tsv
    from grafimo_tpu.scan import compute_results
    from grafimo_tpu.windows import iter_windows_tsv_dir

    table = compute_results(
        _ctcf(), iter_windows_tsv_dir(INPUT, 19), threshold=1.0,
        no_qvalue=False, qval_t=False, no_reverse=False, recomb=True,
    )
    out = os.path.join(wd, "scoring_results.tsv")
    write_tsv(out, table)
    golden = os.path.join(
        HERE, "tests", "data", "expected", "scoring_results.tsv"
    )
    got, want = _tsv_records(out), _tsv_records(golden)
    if got != want:
        raise AssertionError("scoring_results.tsv not reproduced")
    with open(out, "rb") as a, open(golden, "rb") as b:
        same_bytes = a.read() == b.read()
    print(f"golden: {len(got[1])} rows equal to scoring_results.tsv "
          f"(bytes identical: {same_bytes})")


# --- tutorial -------------------------------------------------------------


def phase_tutorial(wd: str) -> None:
    outs = {}
    for side, run in (("gpu", run_cli), ("cpu", run_cli_cpu)):
        gdir = os.path.join(wd, f"tutorial_graphs_{side}")
        outs[side] = os.path.join(wd, f"tutorial_out_{side}")
        run(["buildvg", "-l", os.path.join(TUTORIAL, "xy.fa"),
             "-v", os.path.join(TUTORIAL, "xy2.vcf.gz"), "-o", gdir])
        run(["findmotif", "-d", gdir,
             "-b", os.path.join(TUTORIAL, "regions.bed"),
             "-m", os.path.join(TUTORIAL, "example.meme"),
             "-k", os.path.join(TUTORIAL, "bg_nt"),
             "-t", "0.01", "-o", outs[side]])
    compare_reports(outs["gpu"], outs["cpu"])
    with open(os.path.join(outs["gpu"], REPORTS[0])) as f:
        n = sum(1 for _ in f) - 1
    print(f"tutorial: {n} hits, TSV and GFF3 byte-identical to the CPU run")


# --- kernels --------------------------------------------------------------


def _kernel_pwm(motif, m: int, rng):
    """``m`` PWM columns: CTCF and position-permuted copies (same score
    distribution, so one integer cutoff serves all), both strands."""
    from grafimo_tpu.ops.score_jax import reverse_complement_pwm
    from grafimo_tpu.ops.score_runs import pwms_to_conv_kernel

    mats = []
    sm = np.asarray(motif.score_matrix)
    for i in range(m // 2):
        p = sm if i == 0 else sm[:, rng.permutation(motif.width)]
        mats += [p, reverse_complement_pwm(p)]
    return pwms_to_conv_kernel(mats)


def reference_scan(codes, nmask, valid, kernel, min_scores, cutoffs, k,
                   hist_size):
    """Numpy scoring of every stride-1 window of ``(B, R)`` code rows:
    N-containing windows score ``min_scores``, invalid windows drop.
    Returns ``(hist (hist_size, M) int64, hits set of (row, off, col))``.
    """
    from concurrent.futures import ThreadPoolExecutor

    b, r = codes.shape
    noff = r - k + 1
    lut = np.asarray(kernel).astype(np.int32)  # (k, 4, M)
    m = lut.shape[-1]
    cum = np.concatenate(
        [np.zeros((b, 1), np.int64), np.cumsum(nmask, axis=1)], axis=1
    )
    has_n = (cum[:, k:] - cum[:, :-k]) > 0
    codes = np.minimum(codes, 3)

    def block(lo):
        hi = min(lo + 64, b)
        acc = np.zeros((hi - lo, noff, m), np.int32)
        for j in range(k):
            acc += lut[j][codes[lo:hi, j:j + noff]]
        acc = np.where(has_n[lo:hi, :, None], min_scores[None, None], acc)
        v = valid[lo:hi]
        hist = np.stack(
            [np.bincount(acc[:, :, c][v], minlength=hist_size)
             for c in range(m)], axis=1,
        )
        rows, offs, cols = np.nonzero(
            v[:, :, None] & (acc >= cutoffs[None, None])
        )
        return hist, list(zip((rows + lo).tolist(), offs.tolist(),
                              cols.tolist()))

    hist = np.zeros((hist_size, m), np.int64)
    hits = set()
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for h, hl in pool.map(block, range(0, b, 64)):
            hist += h
            hits.update(hl)
    return hist, hits


def _kernel_batches(rng, b: int, r: int, k: int):
    """One ``DeviceBatch`` per device kind over a seeded genome with
    sparse N bases, and each row's host codes / N mask / validity."""
    from grafimo_tpu.ops.score_runs import pack_bits, pack_run_seqs
    from grafimo_tpu.runscan import PATCH_SLOTS, DeviceBatch, RunChunk

    stride = r - k + 1
    lg = b * stride + 4 * r
    g = rng.integers(0, 4, lg).astype(np.uint8)
    gn = rng.random(lg) < 1e-3
    text = np.frombuffer(b"ACGT", np.uint8)[g]
    text[gn] = ord("N")

    class Genome:
        """Duck-typed graph: the resident path reads ``.seq`` only."""

        seq = text.tobytes().decode()

    noff = r - k + 1
    out = {}
    for kind in ("packed", "resident", "patched", "spliced", "strided"):
        valid = rng.random((b, noff)) < 0.99
        chunks = [RunChunk((kind, (i, 0)), 0) for i in range(b)]
        if kind == "packed":
            codes = rng.integers(0, 4, (b, r)).astype(np.uint8)
            nmask = rng.random((b, r)) < 2e-4
            batch = DeviceBatch(
                R=r, packed=pack_run_seqs(codes), nbits=pack_bits(nmask),
                vbits=pack_bits(valid), chunks=chunks,
            )
            out[kind] = (batch, codes, nmask, valid)
            continue
        if kind == "strided":
            gstart = (r + stride * np.arange(b)).astype(np.int32)
        else:
            gstart = rng.integers(r, lg - 2 * r, b).astype(np.int32)
        idx = gstart[:, None].astype(np.int64) + np.arange(r)[None, :]
        codes, nmask = g[idx], gn[idx]
        extra = {}
        if kind in ("patched", "spliced"):
            pat = np.full((b, PATCH_SLOTS), -1, np.int16)
            if kind == "spliced":
                splice = np.full((b, 4), 0x7FFF, np.int16)
                bound = rng.integers(k, r - k, b)
                shift = rng.integers(-8, 9, b)
                splice[:, 0], splice[:, 1] = bound, shift
                sidx = idx + shift[:, None]
                sel = np.arange(r)[None, :] >= bound[:, None]
                codes = np.where(sel, g[sidx], codes)
                nmask = np.where(sel, gn[sidx], nmask)
                extra["splice"] = splice
            # patches overwrite bases; a spliced row's N plane drops at
            # patched offsets, a patched row keeps the genome's, so its
            # patches stay off N bases (patchable rows carry none)
            rows = np.arange(b)
            for slot in range(3):
                pos = rng.integers(0, r, b)
                base = rng.integers(0, 4, b)
                live = (
                    np.ones(b, bool) if kind == "spliced"
                    else ~nmask[rows, pos]
                )
                pat[live, slot] = pos[live] * 4 + base[live]
                codes[rows[live], pos[live]] = base[live]
                nmask[rows[live], pos[live]] = False
            extra["patches"] = pat
        batch = DeviceBatch(
            R=r, packed=None, nbits=None, vbits=pack_bits(valid),
            chunks=chunks, gstart=gstart, graph=Genome, **extra,
        )
        out[kind] = (batch, codes, nmask, valid)
    return out


def phase_kernels(b: int = 2048, r: int = 2048, ms=(2, 24), seed=0):
    from grafimo_tpu.models.pvalue import PvalueLookup
    from grafimo_tpu.runscan import scan_batches

    motif = _ctcf()
    k = motif.width
    hs = 1000 * k + 1
    rng = np.random.default_rng(seed)
    cut = PvalueLookup(motif.pval_table).score_cutoff(1e-3)
    for m in ms:
        kernel = _kernel_pwm(motif, m, rng)
        mins = np.full(m, motif.min_score, np.int32)
        cuts = np.full(m, cut, np.int32)
        for kind, (batch, codes, nmask, valid) in _kernel_batches(
            rng, b, r, k
        ).items():
            t0 = time.perf_counter()
            res = scan_batches([batch], kernel, mins, cuts, k, hs)
            t_dev = time.perf_counter() - t0
            got_hits = {(src[1][0], off, col) for src, off, col in res.hits}
            t0 = time.perf_counter()
            want_hist, want_hits = reference_scan(
                codes, nmask, valid, kernel, mins, cuts, k, hs
            )
            t_ref = time.perf_counter() - t0
            if not np.array_equal(res.hists, want_hist):
                raise AssertionError(f"{kind} m={m}: histogram differs")
            if got_hits != want_hits:
                raise AssertionError(
                    f"{kind} m={m}: {len(got_hits ^ want_hits)} hits differ"
                )
            print(
                f"kernels: {kind} m={m} B={b} R={r}: histogram "
                f"{int(want_hist.sum())} windows (checksum "
                f"{int((want_hist * np.arange(hs)[:, None]).sum())}), "
                f"{len(want_hits)} hits equal to numpy "
                f"(scan {t_dev:.3f} s incl. compile, reference "
                f"{t_ref:.1f} s)"
            )


# --- chromosome -----------------------------------------------------------


def synth_chromosome(wd: str, mbp: float, seed: int):
    """Seeded 1000 Genomes-profile chromosome ``21`` as FASTA + BGZF VCF;
    returns ``(fasta, vcf, length, pocket spans)``."""
    sys.path.insert(0, HERE)
    from tools.bench_chrom_scale import (
        make_variants,
        synth_chrom,
        write_fasta,
        write_vcf,
    )

    rng = np.random.default_rng(seed)
    length = int(mbp * 1e6)
    seq, pos, pockets = synth_chrom(rng, length, H)
    variants, n_indel = make_variants(rng, seq, pos, H)
    fa, vcf = os.path.join(wd, "chrom.fa"), os.path.join(wd, "chrom.vcf.gz")
    write_fasta(fa, "21", seq)
    write_vcf(vcf, "21", seq, variants, H)
    print(
        f"chromosome: {length} bp, {len(variants)} variants "
        f"({n_indel} indels), {H} haplotypes, {len(pockets)} dense "
        f"pockets; {mbp} Mbp cuts chr22's {CHR22_MBP} Mbp for the "
        "script's run time"
    )
    return fa, vcf, length, pockets


def write_ladder_meme(path: str, n: int, k: int, seed: int) -> None:
    """``n`` seeded width-``k`` motifs in one MEME file."""
    rng = np.random.default_rng(seed)
    lines = ["MEME version 4", "", "ALPHABET= ACGT", "",
             "strands: + -", "",
             "Background letter frequencies",
             "A 0.25 C 0.25 G 0.25 T 0.25", ""]
    for i in range(n):
        lines.append(f"MOTIF L{i:03d} LADDER{i:03d}")
        lines.append(
            f"letter-probability matrix: alength= 4 w= {k} nsites= 100 E= 0"
        )
        for _ in range(k):
            p = np.maximum(rng.dirichlet([0.4] * 4), 1e-4)
            lines.append(" ".join(f"{x:.6f}" for x in p / p.sum()))
        lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def subregion_scan(graph_path: str, lo: int, hi: int, out_dir: str):
    """One ``compute_results_runs`` call over ``[lo, hi)`` of the graph:
    writes its integer histograms and raw hits (``scan.npz``) and its
    report (``report.tsv``) to ``out_dir``."""
    from grafimo_tpu.graph.sitegraph import SiteGraph
    from grafimo_tpu.report.writer import write_tsv
    from grafimo_tpu.runscan import build_region_runs, compute_results_runs

    os.makedirs(out_dir, exist_ok=True)
    motif = _ctcf()
    graph = SiteGraph.load(graph_path)
    rr = build_region_runs(graph, "21", [(lo, hi)], motif.width)
    with record_scans() as seen:
        tables = compute_results_runs([motif], rr, threshold=1e-3)
    (res,) = seen
    hits = np.array(
        [(s[1][0], s[1][1], off, col) for s, off, col in res.hits],
        dtype=np.int64,
    ).reshape(-1, 4)
    keys = [s[0] for s, _o, _c in res.hits]
    np.savez(
        os.path.join(out_dir, "scan.npz"), hists=res.hists, hits=hits,
        keys=np.array(keys, dtype=str),
    )
    write_tsv(os.path.join(out_dir, "report.tsv"), tables[motif.motif_id])


def _compare_subregion(a: str, b: str) -> int:
    with np.load(os.path.join(a, "scan.npz")) as x, np.load(
        os.path.join(b, "scan.npz")
    ) as y:
        for name in ("hists", "hits", "keys"):
            if not np.array_equal(x[name], y[name]):
                raise AssertionError(f"sub-region {name} differ")
        n_hits = len(x["hits"])
    compare_reports(a, b, ["report.tsv"])
    return n_hits


def _findmotif(gdir, bed, motif_file, out, threshold="1e-4", after=None):
    with record_scans(after) as seen:
        t0 = time.perf_counter()
        run_cli(["findmotif", "-d", gdir, "-b", bed, "-m", motif_file,
                 "-t", threshold, "-o", out, "--verbose"])
        wall = time.perf_counter() - t0
    hists = sum(res.hists for res in seen)
    n_hits = 0
    for name in os.listdir(out):
        if name.endswith(".tsv"):
            with open(os.path.join(out, name)) as f:
                n_hits += sum(1 for _ in f) - 1
    print(
        f"findmotif {os.path.basename(out)}: {wall:.3f} s, "
        f"{int(hists[:, 0].sum())} windows/strand, {n_hits} report rows"
    )
    return hists


def build_chromosome(wd: str, mbp: float, seed: int):
    fa, vcf, length, pockets = synth_chromosome(wd, mbp, seed)
    gdir = os.path.join(wd, "graphs")
    t0 = time.perf_counter()
    run_cli(["buildvg", "-l", fa, "-v", vcf, "-o", gdir])
    print(f"buildvg: {time.perf_counter() - t0:.3f} s")
    bed = os.path.join(wd, "whole.bed")
    with open(bed, "w") as f:
        f.write(f"chr21\t0\t{length}\n")
    return gdir, bed, pockets


def phase_chromosome(wd: str, mbp: float, seed: int) -> None:
    gdir, bed, pockets = build_chromosome(wd, mbp, seed)
    outs = [os.path.join(wd, f"ctcf_rep{i}") for i in range(2)]
    hists = [_findmotif(gdir, bed, CTCF, o) for o in outs]
    if not np.array_equal(hists[0], hists[1]):
        raise AssertionError("rerun histograms differ")
    compare_reports(outs[0], outs[1])
    print("chromosome: rerun identical (histograms and reports); the "
          "device/host score guard held on every hit")
    ladder = os.path.join(wd, "ladder.meme")
    write_ladder_meme(ladder, 16, 19, seed)
    with count_pool_maps() as maps:
        _findmotif(gdir, bed, ladder, os.path.join(wd, "ladder_out"))
    if maps != [16]:
        raise AssertionError(f"motif pool did not process the file: {maps}")
    print("chromosome: 16 motifs x 2 strands = 32 PWM columns of width 19 "
          "scanned; motif processing ran its fork pool with the card up")
    lo0, hi0 = pockets[0]
    mid = (lo0 + hi0) // 2
    lo, hi = max(0, mid - 500_000), mid + 500_000
    graph = os.path.join(gdir, "21.gvt.npz")
    dev, cpu = os.path.join(wd, "sub_gpu"), os.path.join(wd, "sub_cpu")
    subregion_scan(graph, lo, hi, dev)
    subprocess.run(
        [sys.executable, "-c",
         "import sys; import chip_smoke as s; "
         "s.subregion_scan(sys.argv[1], int(sys.argv[2]), "
         "int(sys.argv[3]), sys.argv[4])", graph, str(lo), str(hi), cpu],
        cwd=HERE, env=dict(os.environ, JAX_PLATFORMS="cpu"), check=True,
        stdout=subprocess.DEVNULL,
    )
    n = _compare_subregion(dev, cpu)
    print(f"chromosome: sub-region {lo}-{hi} (pocket {lo0}-{hi0}): "
          f"histograms, {n} hits and report equal to the CPU child")


# --- four cards -----------------------------------------------------------


def check_mesh_steps(devices) -> None:
    """The explicit ``(data, motif)`` steps of ``parallel/pipeline.py``
    (window step, run scan, resident scan) on an n x 1 and, for even n,
    an n/2 x 2 mesh: every output equal to the same step on one device."""
    from grafimo_tpu.models.pvalue import PvalueLookup
    from grafimo_tpu.ops.score_jax import (
        hist_size_for_width,
        pwms_to_flat,
        reverse_complement_pwm,
    )
    from grafimo_tpu.ops.score_runs import (
        bytes_to_words,
        pack_bits,
        pack_run_seqs,
    )
    from grafimo_tpu.parallel.pipeline import (
        make_mesh,
        pad_batch,
        sharded_resident_scan,
        sharded_run_scan,
        sharded_scan_step,
    )

    n = len(devices)
    motif = _ctcf()
    k = motif.width
    pwms = [motif.score_matrix, reverse_complement_pwm(motif.score_matrix)]
    pwm = pwms_to_flat(pwms)
    kern = np.stack([np.asarray(p, np.float32).T for p in pwms], axis=-1)
    mins = np.array([motif.min_score] * 2, np.int32)
    cut = PvalueLookup(motif.pval_table).score_cutoff(1e-2)
    cuts = np.array([cut] * 2, np.int32)
    hs = hist_size_for_width(k)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (n * 16 + 3, k)).astype(np.uint8)
    r = 64
    noff = r - k + 1
    b_rows = n * 4
    packed = pack_run_seqs(rng.integers(0, 4, (b_rows, r)).astype(np.uint8))
    nbits = pack_bits(rng.random((b_rows, r)) < 0.01)
    vbits = pack_bits(rng.random((b_rows, noff)) < 0.95)
    genome = rng.integers(0, 4, 4096).astype(np.uint8)
    genome4 = bytes_to_words(pack_run_seqs(genome[None, :])[0])
    gstart = rng.integers(0, 4096 - r, b_rows).astype(np.int32)

    def run_all(n_data, n_motif):
        mesh = make_mesh(n_data, n_motif, devices=devices[: n_data * n_motif])
        padded, n_valid = pad_batch(codes, n_data)
        s, h, hits = sharded_scan_step(mesh, hs)(padded, pwm, mins, cuts)
        outs = [np.asarray(s)[:n_valid], h, hits]
        outs += sharded_run_scan(mesh, k, hs)(
            packed, nbits, vbits, kern, mins, cuts
        )
        outs += sharded_resident_scan(mesh, r, k, hs)(
            genome4, gstart, vbits, kern, mins, cuts
        )
        return [np.asarray(o) for o in outs]

    want = run_all(1, 1)
    if int(want[1].sum()) != len(codes) * 2:
        raise AssertionError("window step lost windows")
    shapes = [(n, 1)] + ([(n // 2, 2)] if n % 2 == 0 else [])
    for n_data, n_motif in shapes:
        got = run_all(n_data, n_motif)
        for i, (g, w) in enumerate(zip(got, want)):
            if not np.array_equal(g, w):
                raise AssertionError(
                    f"mesh {n_data}x{n_motif}: output {i} differs from "
                    "one device"
                )
    print(
        f"mesh steps: {' and '.join(f'{a}x{b}' for a, b in shapes)} equal "
        f"to one device (hist checksums {int(want[1].sum())}/"
        f"{int(want[3].sum())}/{int(want[6].sum())}, hits "
        f"{want[2].tolist()}/{want[5].tolist()}/{want[8].tolist()})"
    )


def card_bytes(devices):
    """Bytes in use on each card now, and the bytes of live arrays held by
    the first card alone.  (Peak bytes would mislead: XLA autotunes on
    the first card while it compiles.)"""
    import jax

    used = [d.memory_stats()["bytes_in_use"] for d in devices]
    alone = sum(
        a.nbytes for a in jax.live_arrays()
        if a.sharding.device_set == {devices[0]}
    )
    return used, alone


def phase_four_cards(wd: str, mbp: float, seed: int, devices) -> None:
    if len(devices) != 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found {len(devices)}")
    with phase("mesh-steps"):
        check_mesh_steps(devices)
    with phase("four-card-scan"):
        gdir, bed, _pockets = build_chromosome(wd, mbp, seed)
        mesh_out = os.path.join(wd, "ctcf_four")
        probes = []
        h_mesh = _findmotif(
            gdir, bed, CTCF, mesh_out,
            after=lambda: probes.append(card_bytes(devices)),
        )
        ((used, alone),) = probes
        print("bytes in use per card at the end of the four-card scan: "
              + ", ".join(str(u) for u in used)
              + f"; live arrays on the first card alone: {alone} bytes")
        if min(used) < max(used) // 4 or alone > 1 << 20:
            raise AssertionError("the scan's buffers sit on one card")
        os.environ["GRAFIMO_TPU_SINGLE_DEVICE"] = "1"
        try:
            one_out = os.path.join(wd, "ctcf_one")
            h_one = _findmotif(gdir, bed, CTCF, one_out)
        finally:
            del os.environ["GRAFIMO_TPU_SINGLE_DEVICE"]
        if not np.array_equal(h_mesh, h_one):
            raise AssertionError("four-card histograms differ from one card")
        compare_reports(mesh_out, one_out)
        print("four-card scan: reports byte-identical and histograms equal "
              "to the single-card scan")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mbp", type=float, default=20.0,
                    help="synthetic chromosome length (Mbp)")
    ap.add_argument("--workdir", default=os.path.join(HERE, ".smoke"))
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU path and its comparison")
    args = ap.parse_args()

    sys.path.insert(0, HERE)
    import jax

    from grafimo_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    check_device(devices)
    print(card_line())
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(args.workdir, args.mbp, args.seed, devices)
    else:
        with phase("golden"):
            phase_golden(args.workdir)
        with phase("tutorial"):
            phase_tutorial(args.workdir)
        with phase("kernels"):
            phase_kernels(seed=args.seed)
        with phase("chromosome"):
            phase_chromosome(args.workdir, args.mbp, args.seed)
    print(f"total wall {time.perf_counter() - t0:.3f} s")
    shutil.rmtree(args.workdir, ignore_errors=True)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
