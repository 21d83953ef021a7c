"""Motif PWM parsers: JASPAR, MEME (multi-motif), TRANSFAC, PFM.

Reference: ``src/grafimo/motif_ops.py:126-968`` and format sniffers
``utils.py:212-405``.  All parsers normalise matrices to A,C,G,T row order
(the tensor layout used by the scoring kernels) and hand off to the exact
float64 processing pipeline in :mod:`grafimo_tpu.models.process`.
"""

import os
from typing import List

import numpy as np

from grafimo_tpu.errors import MotifFileFormatError, MotifFileReadError
from grafimo_tpu.models.background import load_bg
from grafimo_tpu.models.motif import Motif, MotifSet
from grafimo_tpu.models.process import (
    apply_pseudocount_counts,
    apply_pseudocount_meme,
    norm_motif,
    process_motif,
)
from grafimo_tpu.utils.constants import DNA_ALPHABET
from grafimo_tpu.utils.sniff import sniff_motif_format


def _reorder_to_acgt(matrix_rows: List[List[float]], nucs: List[str]) -> np.ndarray:
    """Stack per-nucleotide rows into a (4, width) float64 array in A,C,G,T
    order regardless of file row order."""
    rowmap = {n: r for n, r in zip(nucs, matrix_rows)}
    return np.array([rowmap[n] for n in DNA_ALPHABET], dtype=np.float64)


def parse_jaspar(motif_file: str) -> Motif:
    """JASPAR format: ``>id\\tname`` header then ``A [ counts ]`` rows
    (reference ``motif_ops.py:126-232``)."""
    nucs: List[str] = []
    counts: List[List[float]] = []
    with open(motif_file) as handle:
        header = handle.readline().strip()[1:]
        if not header:
            raise MotifFileReadError(f"{motif_file} seems to be empty")
        parts = header.split("\t")
        motif_id = parts[0]
        motif_name = parts[1] if len(parts) > 1 else motif_id
        for line in handle:
            line = line.strip()
            if not line:
                break
            nuc = line[:1].upper()
            row = [float(c) for c in line[1:].split()[1:][:-1]]
            nucs.append(nuc)
            counts.append(row)
    if not counts:
        raise MotifFileReadError(f"{motif_file} seems to be empty")
    if any(len(c) != len(counts[0]) for c in counts):
        raise MotifFileReadError("motif counts width mismatch")
    matrix = _reorder_to_acgt(counts, nucs)
    return Motif(
        motif_id=motif_id,
        motif_name=motif_name,
        counts=matrix,
        width=matrix.shape[1],
    )


def parse_meme(motif_file: str) -> List[Motif]:
    """MEME multi-motif format (reference ``motif_ops.py:364-637``)."""
    motifs: List[Motif] = []
    with open(motif_file) as handle:
        # alphabet line (must be DNA)
        for line in handle:
            if line.startswith("ALPHABET"):
                break
        else:
            raise MotifFileReadError(f"no ALPHABET line in {motif_file}")
        alphabet = line.strip().replace("ALPHABET= ", "")
        if alphabet != "ACGT":
            raise MotifFileReadError("the motif is not built on DNA alphabet")
        while True:
            for line in handle:
                if line.startswith("MOTIF"):
                    break
            else:
                break  # EOF: all motifs read
            ids = line.split()
            if len(ids) == 2:
                motif_id = motif_name = ids[1]
            else:
                motif_id, motif_name = ids[1:3]
            # statistics line
            for line in handle:
                if line.startswith("letter-probability matrix:"):
                    break
            else:
                raise MotifFileReadError(
                    f"unexpected EOF in {motif_file} (missing statistics)"
                )
            width = int(line.split("w=")[1].split()[0])
            nsites = int(line.split("nsites=")[1].split()[0])
            # probability rows: columns are A C G T
            a, c, g, t = [], [], [], []
            pos = 0
            for line in handle:
                freqs = line.split()
                if len(freqs) != 4:
                    if pos < width:
                        raise MotifFileReadError("unexpected end of motif")
                    break
                a.append(np.double(freqs[0]))
                c.append(np.double(freqs[1]))
                g.append(np.double(freqs[2]))
                t.append(np.double(freqs[3]))
                pos += 1
            matrix = np.array([a, c, g, t], dtype=np.float64)
            motifs.append(
                Motif(
                    motif_id=motif_id,
                    motif_name=motif_name,
                    counts=matrix,
                    width=width,
                    nsites=nsites,
                )
            )
    if not motifs:
        raise MotifFileReadError(f"no motifs found in {motif_file}")
    return motifs


def parse_transfac(motif_file: str) -> Motif:
    """TRANSFAC format (reference ``motif_ops.py:701-804``)."""
    motif_id = motif_name = None
    nucs: List[str] = []
    counts = {}
    with open(motif_file) as handle:
        for line in handle:
            line = line.strip()
            if not line:
                continue
            line_split = line.split(None, 1)
            field = line_split[0].strip()
            if field == "AC":
                motif_id = line_split[1].strip()
            elif field == "ID":
                motif_name = line_split[1].strip()
            elif field in ("P0", "PO"):
                nucs = line_split[1].strip().split()[:4]
                if nucs != DNA_ALPHABET:
                    raise MotifFileReadError("not a DNA TRANSFAC motif")
                counts = {nt: [] for nt in nucs}
                width = 0
                for line in handle:
                    line_split = line.strip().split(None, 1)
                    field = line_split[0].strip()
                    try:
                        position = int(field)
                    except ValueError:
                        break
                    if len(line_split) != 2:
                        raise MotifFileReadError("invalid count line")
                    width += 1
                    if position != width:
                        raise MotifFileReadError(
                            "mismatching motif width and position"
                        )
                    row = line_split[1].strip().split()[:4]
                    if len(row) != 4:
                        raise MotifFileReadError("not a DNA motif")
                    for nt, cval in zip(nucs, row):
                        counts[nt].append(float(cval))
    if motif_id is None or motif_name is None or not counts:
        raise MotifFileReadError(f"incomplete TRANSFAC motif in {motif_file}")
    if any(len(counts[nucs[0]]) != len(counts[nt]) for nt in counts):
        raise MotifFileReadError("motif width mismatch in counts")
    matrix = _reorder_to_acgt([counts[nt] for nt in nucs], nucs)
    return Motif(
        motif_id=motif_id,
        motif_name=motif_name,
        counts=matrix,
        width=matrix.shape[1],
    )


def parse_pfm(motif_file: str) -> Motif:
    """PFM format: 4 count rows (A,C,G,T), optional JASPAR-style header
    (reference ``motif_ops.py:871-968``)."""
    motif_id = ""
    motif_name = ""
    counts: List[List[float]] = []
    with open(motif_file) as handle:
        for line in handle:
            line = line.strip()
            if not line:
                raise MotifFileReadError(f"{motif_file} seems empty")
            if line.startswith(">"):
                motif_id, motif_name = line[1:].split()
                continue
            counts.append([float(c) for c in line.split()])
    if len(counts) != 4:
        raise MotifFileReadError("PFM motifs need counts for each nucleotide")
    if any(len(c) != len(counts[0]) for c in counts):
        raise MotifFileReadError("mismatch in counts length")
    if not motif_id and not motif_name:
        motif_id = motif_name = os.path.basename(motif_file)
    matrix = np.array(counts, dtype=np.float64)
    return Motif(
        motif_id=motif_id,
        motif_name=motif_name,
        counts=matrix,
        width=matrix.shape[1],
    )


def _prepare_counts_motif(motif: Motif, bgs, pseudocount: float) -> Motif:
    """Counts-based preparation shared by JASPAR/TRANSFAC/PFM
    (reference ``motif_ops.py:197-225``)."""
    motif.bg = bgs
    colsum = motif.counts.sum(0)
    probs = motif.counts / colsum
    probs = norm_motif(probs, motif.width)
    motif.probs = apply_pseudocount_counts(
        motif.counts, probs, pseudocount, bgs, motif.width
    )
    return motif


def _prepare_meme_motif(motif: Motif, bgs, pseudocount: float) -> Motif:
    """Probability-based preparation (reference ``motif_ops.py:482-507``)."""
    motif.bg = bgs
    probs = norm_motif(motif.counts, motif.width)
    motif.probs = apply_pseudocount_meme(
        probs, pseudocount, motif.nsites, motif.width, bgs
    )
    return motif


def load_motifs(
    motif_file: str,
    bg_file: str,
    pseudocount: float,
    no_reverse: bool,
) -> List[Motif]:
    """Parse + fully process every motif in ``motif_file``
    (reference ``get_motif_pwm``, ``motif_ops.py:1116-1186``)."""
    fmt = sniff_motif_format(motif_file)
    bgs = load_bg(bg_file, no_reverse)
    if fmt == "jaspar":
        raw = [parse_jaspar(motif_file)]
        prepared = [_prepare_counts_motif(m, bgs, pseudocount) for m in raw]
    elif fmt == "meme":
        raw = parse_meme(motif_file)
        prepared = [_prepare_meme_motif(m, bgs, pseudocount) for m in raw]
    elif fmt == "transfac":
        raw = [parse_transfac(motif_file)]
        prepared = [_prepare_counts_motif(m, bgs, pseudocount) for m in raw]
    elif fmt == "pfm":
        raw = [parse_pfm(motif_file)]
        prepared = [_prepare_counts_motif(m, bgs, pseudocount) for m in raw]
    else:  # pragma: no cover - sniffer already raises
        raise MotifFileFormatError(f"unsupported motif format {fmt}")
    return process_motifs(prepared)


def process_motifs(prepared: List[Motif]) -> List[Motif]:
    """Run the per-motif float64 pipeline (log-odds, scaling, Staden DP)
    over many motifs, in parallel for large multi-motif files (the
    reference pools MEME processing the same way, ``motif_ops.py:303-348``).

    Processes, not threads: numpy's elementwise ops hold the GIL.  A
    ``fork`` context keeps children from re-importing jax; the pool may
    fork after the GPU backend is up, which is safe because children do
    numpy-only work and never touch JAX (``chip_smoke.py`` runs a
    16-motif file through this pool with the card in use).  Per-motif processing is independent and order is preserved, so
    the result is bit-identical to the sequential path (tested,
    ``test_multi_motif.py``).  Any pool failure falls back to sequential.
    """
    n = len(prepared)
    workers = min(os.cpu_count() or 1, n // 8)
    if n >= 16 and workers > 1:
        try:
            import multiprocessing
            import signal
            from concurrent.futures import ProcessPoolExecutor

            ctx = multiprocessing.get_context("fork")
            # reference SIGINT discipline around fork pools
            # (motif_ops.py:304-338): children inherit SIG_IGN so a
            # Ctrl-C only reaches the parent, which terminates the pool
            # cleanly instead of orphaning workers mid-compute
            old_handler = signal.signal(signal.SIGINT, signal.SIG_IGN)
            pool = ProcessPoolExecutor(max_workers=workers, mp_context=ctx)
            signal.signal(signal.SIGINT, old_handler)
            try:
                return list(
                    pool.map(
                        process_motif, prepared,
                        chunksize=max(1, n // (workers * 4)),
                    )
                )
            except KeyboardInterrupt:
                pool.shutdown(wait=False, cancel_futures=True)
                raise
            finally:
                pool.shutdown(wait=True)
        except KeyboardInterrupt:
            raise
        except Exception:
            pass
    return [process_motif(m) for m in prepared]


def load_motif_set(
    motif_files: List[str], bg_file: str, pseudocount: float, no_reverse: bool
) -> MotifSet:
    ms = MotifSet()
    for fn in motif_files:
        ms.add(load_motifs(fn, bg_file, pseudocount, no_reverse))
    return ms
