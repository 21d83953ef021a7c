"""Production scan engine: run-compressed extraction + device conv scan.

End-to-end flow per (width, regions):

1. host builds runs (``graph/runs.py``) — no window materialisation;
2. runs are chunked into fixed-length buckets, bit-packed and streamed to
   the device (``ops/score_runs.py``): the conv kernel scores EVERY
   stride-1 window on both strands, histograms the integer scores and
   returns packed hit bits;
3. host reconstructs metadata (coordinates, haplotype frequency, node
   path, ref flag) only for hits, computes exact p-values from the Staden
   table, exact BH q-values from the histogram, and assembles the report.

This is the fast path behind ``findmotif``; the per-window engine
(``scan.py``) remains as the semantic reference and TSV-compat path.
"""

import os
import time
from dataclasses import dataclass, field, replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from grafimo_tpu.graph.runs import (
    Run,
    _anchor_bounds,
    _anchor_window_fallback,
    _del_prefix,
    build_single_run,
    dense_cluster_runs,
    cluster_sites,
    nth_combination,
    reconstruct_hits_batch,
    region_runs,
)
from grafimo_tpu.graph.sitegraph import SiteGraph
from grafimo_tpu.models.motif import Motif
from grafimo_tpu.models.pvalue import PvalueLookup
from grafimo_tpu.ops.qvalue import qvalues_from_histogram
from grafimo_tpu.ops.score_runs import (
    bytes_to_words,
    pack_bits,
    pack_run_seqs,
    pwms_to_conv_kernel,
    unpack_hitbits,
)
from grafimo_tpu.ops.score_jax import reverse_complement_pwm
from grafimo_tpu.report.results import (
    ResultTable,
    apply_report_filters,
    build_results_df,
)
from grafimo_tpu.utils.constants import RANGE

BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)
# device-resident cluster runs: patch slots per row and the minimum
# bucket where the descriptor (4B gstart + 2B/slot) beats packed bytes
# (R/4 sequence + R/8 N plane).  Short buckets hold the bulk of cluster
# rows (e.g. 94% of wire bytes on a k=11 pangenome pass rode packed R=64
# rows before this) and their combination runs rarely carry more than a
# few substitutions, so they use a narrow 4-slot descriptor: 4+8 bytes
# vs 24 packed at R=64.
PATCH_SLOTS = 16
PATCH_SLOTS_SHORT = 4
SHORT_PATCH_R = 256  # buckets at or below use the narrow descriptor
MIN_PATCH_R = 64
# on-device hit compaction capacity per scan slice; > SCAN_TOPK hits in
# one slice falls back to fetching its full bitmask
SCAN_TOPK = 1 << 13
# hit flat-indices fetched speculatively per slice inside the block
# fetch (covers almost every slice; SCAN_SMALLK < n_hits <= SCAN_TOPK
# costs one extra per-slice fetch)
SCAN_SMALLK = 1 << 10
# slices per device->host fetch block; also bounds int32 histogram
# accumulation (the int64 host total absorbs each block)
SCAN_FLUSH_SLICES = 1024
# device-batch size cap: rows are sliced so rows*R stays under this many
# bases per dispatch (bounds the one-hot / scores device footprint: 16M
# bases => ~130MB one-hot + ~260MB scores at m=4 — small against one
# card's memory)
MAX_BASES_PER_DISPATCH = 1 << 24
# the CPU debug backend holds every intermediate of a slice in host RAM
# and runs the tests with several workers; it slices 32x finer (slicing
# is result-invariant — test_runscan.py pins exactness at budget=64)
MAX_BASES_PER_DISPATCH_CPU = 1 << 19


def _dispatch_cap() -> int:
    """Backend-dependent ``MAX_BASES_PER_DISPATCH`` (module constants
    stay monkeypatchable for the slicing-invariance tests)."""
    try:
        import jax

        if jax.default_backend() == "cpu":
            return min(MAX_BASES_PER_DISPATCH, MAX_BASES_PER_DISPATCH_CPU)
    except Exception:
        # cannot determine the backend (import failure, broken device
        # init): assume the conservative CPU cap
        return min(MAX_BASES_PER_DISPATCH, MAX_BASES_PER_DISPATCH_CPU)
    return MAX_BASES_PER_DISPATCH
_SEQ_LUT = np.full(256, 0, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _SEQ_LUT[ord(_c)] = _i
_N_LUT = np.ones(256, dtype=bool)
for _c in "ACGTacgt":
    _N_LUT[ord(_c)] = False


@dataclass
class RunPayload:
    """Scan payload of one run: enough to score it, not to report it."""

    codes: np.ndarray  # uint8 (L,) 0..3, 4 = N
    valid: np.ndarray  # bool (L-k+1,)
    ref: Tuple[int, int]  # (cluster_idx, combo_idx); (-1, 0) = backbone


@dataclass
class RunChunk:
    source: Tuple[str, Tuple[int, int]]  # (region key, run ref)
    chunk_off: int  # offset of this chunk within the run


class ChunkTable:
    """Array-backed drop-in for ``List[RunChunk]`` on native batches.

    Chromosome-scale scans carry millions of rows per graph; one python
    ``RunChunk`` (+ its tuples) costs ~250 B and an allocation, so the
    per-row object list was both the extraction-wall and the RSS tail
    after the round-5 native dense decomposition.  The C++ batcher
    already returns the chunk identity as int32 meta columns — this
    view keeps them as arrays and materialises a ``RunChunk`` only when
    a row is actually touched (hit bookkeeping touches only hit rows).
    """

    __slots__ = ("keys", "key_idx", "c_idx", "x_idx", "off")

    def __init__(self, keys, key_idx, c_idx, x_idx, off):
        self.keys = keys  # region-key list, indexed by key_idx
        self.key_idx = key_idx
        self.c_idx = c_idx
        self.x_idx = x_idx
        self.off = off

    @classmethod
    def from_meta(cls, keys: List[str], meta: np.ndarray) -> "ChunkTable":
        """``meta`` int32 ``(rows, 4)``: key idx, cluster, combo, off."""
        return cls(
            keys, meta[:, 0].copy(), meta[:, 1].copy(),
            meta[:, 2].copy(), meta[:, 3].copy(),
        )

    def take(self, sel) -> "ChunkTable":
        """Row subset (bool mask or index array), still array-backed."""
        return ChunkTable(
            self.keys, self.key_idx[sel], self.c_idx[sel],
            self.x_idx[sel], self.off[sel],
        )

    def __len__(self) -> int:
        return len(self.key_idx)

    def __getitem__(self, i: int) -> RunChunk:
        return RunChunk(
            (
                self.keys[int(self.key_idx[i])],
                (int(self.c_idx[i]), int(self.x_idx[i])),
            ),
            int(self.off[i]),
        )

    def __iter__(self):
        for i in range(len(self.key_idx)):
            yield self[i]


@dataclass
class DeviceBatch:
    R: int
    packed: Optional[np.ndarray]  # None for device-resident batches
    nbits: Optional[np.ndarray]
    vbits: np.ndarray
    chunks: List[RunChunk]
    # device-resident backbone batches: rows are genome slices, expanded
    # on device from the HBM-resident packed chromosome (uploaded once);
    # each row is a 4-byte genome offset instead of R/4 sequence bytes
    gstart: Optional[np.ndarray] = None  # int32 (B,) genome base offsets
    graph: Optional[SiteGraph] = None
    # device-resident CLUSTER batches: substitution-only combination runs
    # expand from the genome at gstart and apply per-row patches
    # (pos*4+base int16, -1 = empty) on device
    patches: Optional[np.ndarray] = None  # int16 (B, PATCH_SLOTS)
    # device-resident INDEL cluster batches: piecewise genome alignment —
    # (bound, shift) int16 pairs, bound 0x7fff = unused; rows with a
    # splice also carry patches for inserted/substituted bases
    splice: Optional[np.ndarray] = None  # int16 (B, 2*SPLICE_BREAKS)


def _resident_genome(graph: SiteGraph):
    """Packed whole-chromosome planes for on-device expansion (cached on
    the graph), as int32 words (``ops/score_runs.bytes_to_words`` — the
    expand kernels gather words): ``(codes words, n-plane words or
    None)``."""
    cached = getattr(graph, "_resident_genome_cache", None)
    if cached is not None:
        return cached
    seq_bytes = np.frombuffer(graph.seq.encode("ascii"), np.uint8)
    codes = _SEQ_LUT[seq_bytes]
    nmask = _N_LUT[seq_bytes]
    pad4 = (-len(codes)) % 4
    if pad4:
        codes = np.concatenate([codes, np.zeros(pad4, np.uint8)])
    # margin past the chromosome end: the strided kernel
    # (ops/score_runs._expand_strided) decodes b*stride + R codes from
    # the slice's first row start — one whole extra stride past the
    # last row's span — and the last backbone row can start as late as
    # L - k (a remainder chunk that re-lands in the top bucket keeps
    # the row starts uniform), so the read extends up to
    # stride + R - k ~= 2R codes past the chromosome end, plus <= 47
    # codes of word rounding.  The reads are vbits-masked; the slice
    # must merely stay in bounds — an undersized margin does NOT fail
    # loudly: jax.lax.dynamic_slice CLAMPS an out-of-range start and
    # silently shifts the whole span (caught round 4 at 50 Mbp /
    # k = 19: the final slice clamped 22 words and dropped tail hits;
    # regression: tests/test_resident_scan.py strided-tail tests).
    # Bytes here are packed codes (4/byte): R//2 + 16 bytes = 2R + 64
    # codes; the same array appended to the 1-bit N plane gives
    # 8x that many code-bits — both cover the bound for every k >= 1.
    margin = np.zeros(BUCKETS[-1] // 2 + 16, np.uint8)
    codes4 = bytes_to_words(
        np.concatenate([pack_run_seqs(codes[None, :])[0], margin])
    )
    nplane = (
        bytes_to_words(
            np.concatenate([pack_bits(nmask[None, :])[0], margin])
        )
        if nmask.any()
        else None
    )
    cached = (codes4, nplane)
    graph._resident_genome_cache = cached
    return cached


@dataclass
class RegionRuns:
    key: str
    graph: SiteGraph
    display: str
    start: int
    stop: int
    width: int
    # scan payloads; None = deferred to the native batch pipeline
    # (batch_runs builds device batches straight from C++ buffers)
    payloads: Optional[List[RunPayload]]
    _run_cache: Dict[Tuple[int, int], Run] = field(default_factory=dict)

    def get_run(self, ref: Tuple[int, int]) -> Run:
        """Materialise run metadata lazily (hits only)."""
        run = self._run_cache.get(ref)
        if run is None:
            run = build_single_run(
                self.graph, self.start, self.stop, self.width, ref
            )
            assert run is not None
            self._run_cache[ref] = run
        return run


def _payload_from_run(run: Run) -> RunPayload:
    seq_bytes = np.frombuffer(run.seq.encode("ascii"), np.uint8)
    codes = _SEQ_LUT[seq_bytes].copy()
    codes[_N_LUT[seq_bytes]] = 4
    return RunPayload(codes=codes, valid=run.valid, ref=run.ref)


def build_region_runs(
    graph: SiteGraph,
    display: str,
    regions: Sequence[Tuple[int, int]],
    k: int,
) -> List[RegionRuns]:
    """Build scan payloads for every region.

    When the native batch pipeline is available, payload construction is
    deferred entirely to one C++ call per graph inside
    :func:`batch_runs`; otherwise the python builder materialises
    payloads here.  Hit metadata is reconstructed lazily either way.
    """
    native_ok = _native_batcher() is not None
    out = []
    for start, stop in regions:
        key = f"{display}:{start}-{stop}"
        payloads: Optional[List[RunPayload]] = None
        cache: Dict[Tuple[int, int], Run] = {}
        if not native_ok:
            payloads = []
            try:
                for run in region_runs(graph, start, stop, k):
                    payloads.append(_payload_from_run(run))
                    cache[run.ref] = run
            except Exception as e:
                # a failing region is a warning, not a fatal error — the
                # scan continues without it (reference
                # extract_regions.py:328-331)
                import sys

                sys.stderr.write(
                    f"\033[33mWARNING: skipping region {key}: {e}\033[0m\n"
                )
                continue
        out.append(
            RegionRuns(
                key=key,
                graph=graph,
                display=display,
                start=start,
                stop=stop,
                width=k,
                payloads=payloads,
                _run_cache=cache,
            )
        )
    return out


def save_batches(
    path: str, batches: List[DeviceBatch], region_keys: List[str]
) -> None:
    """Persist device-ready batches as a scan checkpoint (SURVEY.md §5.4:
    the reference had none — its tmp TSV dir was an implicit, deleted
    intermediate; this is an explicit, reusable one)."""
    assert all(
        b.packed is not None for b in batches
    ), "device-resident batches are not checkpointable (batch_runs resident=False)"
    key_index = {key: i for i, key in enumerate(region_keys)}
    arrays = {
        "region_keys": np.frombuffer(
            "\n".join(region_keys).encode("utf-8"), dtype=np.uint8
        ),
        "n_batches": np.array([len(batches)], dtype=np.int64),
    }
    for bi, b in enumerate(batches):
        meta = np.array(
            [
                (
                    key_index[c.source[0]], c.source[1][0], c.source[1][1],
                    c.chunk_off,
                )
                for c in b.chunks
            ],
            dtype=np.int32,
        ).reshape(-1, 4)
        arrays[f"b{bi}_R"] = np.array([b.R], dtype=np.int64)
        arrays[f"b{bi}_packed"] = b.packed
        arrays[f"b{bi}_nbits"] = b.nbits
        arrays[f"b{bi}_vbits"] = b.vbits
        arrays[f"b{bi}_meta"] = meta
    # write-then-rename: a Ctrl-C / crash mid-write never leaves a
    # truncated checkpoint behind for the next run to trip over
    tmp = f"{path}.tmp"
    try:
        with open(tmp, "wb") as fh:  # file object: savez can't append .npz
            np.savez_compressed(fh, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_batches(path: str) -> Tuple[List[DeviceBatch], List[str]]:
    """Load a scan checkpoint written by :func:`save_batches`."""
    with np.load(path) as data:
        region_keys = bytes(data["region_keys"]).decode("utf-8").split("\n")
        batches = []
        for bi in range(int(data["n_batches"][0])):
            meta = data[f"b{bi}_meta"]
            chunks = ChunkTable.from_meta(region_keys, meta)
            batches.append(
                DeviceBatch(
                    R=int(data[f"b{bi}_R"][0]),
                    packed=data[f"b{bi}_packed"],
                    nbits=data[f"b{bi}_nbits"],
                    vbits=data[f"b{bi}_vbits"],
                    chunks=chunks,
                )
            )
    return batches, region_keys


def _native_batcher():
    """The C++ batch pipeline entry, or None when unavailable."""
    try:
        from grafimo_tpu.native import batch_regions_native

        return batch_regions_native
    except Exception:
        return None


def batch_runs(
    region_runs_list: List[RegionRuns], k: int, buckets=BUCKETS,
    threads: int = 0, resident: bool = True,
) -> List[DeviceBatch]:
    """Chunk + bucket + bit-pack all run payloads into device batches.

    Deferred (``payloads is None``) regions go through the C++ batch
    pipeline — one call per graph covering run construction, chunking and
    bit packing; the rest use the python path below.

    With ``resident`` (the default), backbone rows — genome slices, the
    bulk of the window mass — become device-resident batches: a 4-byte
    genome offset per row, expanded on device from the once-uploaded
    packed chromosome (``ops/score_runs.scan_runs_resident_topk``).
    Disable for scan checkpoints (``--cache-dir``), which persist full
    row payloads.
    """
    batches: List[DeviceBatch] = []
    by_key = {rr.key: rr for rr in region_runs_list}
    python_rrs = [rr for rr in region_runs_list if rr.payloads is not None]
    native_rrs = [rr for rr in region_runs_list if rr.payloads is None]
    if native_rrs:
        fn = _native_batcher()
        groups: Dict[int, List[RegionRuns]] = {}
        for rr in native_rrs:
            groups.setdefault(id(rr.graph), []).append(rr)
        # per-bucket patch-slot policy (0 disables native patch emission;
        # see PATCH_SLOTS/SHORT_PATCH_R above) — only meaningful for
        # resident scans, checkpoints persist full payloads
        sorted_buckets = sorted(buckets)
        bucket_slots = [
            0
            if (not resident or r < MIN_PATCH_R)
            else (PATCH_SLOTS_SHORT if r <= SHORT_PATCH_R else PATCH_SLOTS)
            for r in sorted_buckets
        ]
        for group in groups.values():
            try:
                per_bucket_native, overflow_pairs, dense_fallbacks = fn(
                    group[0].graph,
                    [(rr.start, rr.stop) for rr in group],
                    k,
                    sorted_buckets,
                    n_threads=threads,
                    bucket_slots=bucket_slots,
                    # over-dense clusters decompose IN C++ for resident
                    # scans (rows carry lazily-resolvable dense refs);
                    # checkpoint scans (resident=False) keep the legacy
                    # python path — their (-2, n) ref ordinals are part
                    # of the persisted format
                    dense=resident,
                )
                # over-dense clusters (candidate-combination cap) the
                # native engine did NOT decompose (checkpoint mode, or
                # a cluster too large for the int32 dense-ref
                # encoding): anchored short combination runs for THOSE
                # clusters only (graph/runs.dense_cluster_runs).  Dense
                # payloads ride a shim RegionRuns sharing the
                # original's key and run cache so hit reconstruction
                # resolves (-2, i) refs through the same region.
                n_fb: Dict[int, int] = {}
                clusters_of: Dict[int, list] = {}
                for ri, ci in overflow_pairs:
                    rr = group[ri]
                    if ri not in clusters_of:
                        clusters_of[ri] = cluster_sites(
                            rr.graph, rr.start, rr.stop, k
                        )
                    fb_payloads = []
                    for run in dense_cluster_runs(
                        rr.graph, clusters_of[ri][ci], rr.start, rr.stop, k
                    ):
                        run.ref = (-2, n_fb.setdefault(ri, 0))
                        n_fb[ri] += 1
                        rr._run_cache[run.ref] = run
                        fb_payloads.append(_payload_from_run(run))
                    if fb_payloads:
                        python_rrs.append(
                            dc_replace(rr, payloads=fb_payloads)
                        )
                # ultra-dense anchors past the per-anchor combination
                # cap: exact per-window rows for those anchors only
                # (runs._anchor_window_fallback — mirrors the python
                # dense generator's per-anchor escape hatch)
                delpref_of: Dict[Tuple[int, int], list] = {}
                for ri, ci, ai in dense_fallbacks:
                    rr = group[ri]
                    if ri not in clusters_of:
                        clusters_of[ri] = cluster_sites(
                            rr.graph, rr.start, rr.stop, k
                        )
                    cl = clusters_of[ri][ci]
                    dp = delpref_of.get((ri, ci))
                    if dp is None:
                        dp = delpref_of[(ri, ci)] = _del_prefix(cl)
                    _l, j_reach = _anchor_bounds(cl, dp, ai, k)
                    fb_payloads = []
                    for run in _anchor_window_fallback(
                        rr.graph, cl, ai, j_reach, rr.start, rr.stop, k
                    ):
                        run.ref = (-2, n_fb.setdefault(ri, 0))
                        n_fb[ri] += 1
                        rr._run_cache[run.ref] = run
                        fb_payloads.append(_payload_from_run(run))
                    if fb_payloads:
                        python_rrs.append(
                            dc_replace(rr, payloads=fb_payloads)
                        )
                region_lo = np.array(
                    [max(0, rr.start) for rr in group], dtype=np.int64
                )
                group_keys = [rr.key for rr in group]
                for r_len, d in per_bucket_native.items():
                    p = d.get("patched")
                    if p is not None and len(p["meta"]):
                        batches.append(
                            DeviceBatch(
                                R=r_len, packed=None, nbits=None,
                                vbits=p["vbits"],
                                chunks=ChunkTable.from_meta(
                                    group_keys, p["meta"]
                                ),
                                gstart=p["gstart"].astype(np.int32),
                                graph=group[0].graph,
                                patches=p["patches"],
                            )
                        )
                    sp = d.get("spliced")
                    if sp is not None and len(sp["meta"]):
                        batches.append(
                            DeviceBatch(
                                R=r_len, packed=None, nbits=None,
                                vbits=sp["vbits"],
                                chunks=ChunkTable.from_meta(
                                    group_keys, sp["meta"]
                                ),
                                gstart=sp["gstart"].astype(np.int32),
                                graph=group[0].graph,
                                patches=sp["patches"],
                                splice=sp["splice"],
                            )
                        )
                    if "meta" not in d:
                        continue
                    meta = d["meta"]
                    chunks = ChunkTable.from_meta(group_keys, meta)
                    bb = meta[:, 1] == -1
                    if resident and bb.any():
                        gstart = (
                            region_lo[meta[bb, 0]] + meta[bb, 3]
                        ).astype(np.int32)
                        batches.append(
                            DeviceBatch(
                                R=r_len, packed=None, nbits=None,
                                vbits=d["vbits"][bb],
                                chunks=chunks.take(bb),
                                gstart=gstart, graph=group[0].graph,
                            )
                        )
                        rest = ~bb
                        if rest.any():
                            batches.append(
                                DeviceBatch(
                                    R=r_len,
                                    packed=d["packed"][rest],
                                    nbits=d["nbits"][rest],
                                    vbits=d["vbits"][rest],
                                    chunks=chunks.take(rest),
                                )
                            )
                    else:
                        batches.append(
                            DeviceBatch(
                                R=r_len, packed=d["packed"],
                                nbits=d["nbits"], vbits=d["vbits"],
                                chunks=chunks,
                            )
                        )
            except Exception as e:
                import sys

                sys.stderr.write(
                    f"\033[33mWARNING: native batcher failed ({e}); "
                    f"falling back to python extraction\033[0m\n"
                )
                for rr in group:
                    rr.payloads = []
                    for run in region_runs(rr.graph, rr.start, rr.stop, k):
                        rr.payloads.append(_payload_from_run(run))
                        rr._run_cache[run.ref] = run
                    python_rrs.append(rr)
    region_runs_list = python_rrs
    n_native_batches = len(batches)  # native patch emission already done
    per_bucket: Dict[int, List[Tuple[np.ndarray, np.ndarray, np.ndarray, RunChunk]]] = {}
    res_bucket: Dict[Tuple[int, int], List[Tuple[int, np.ndarray, RunChunk]]] = {}
    res_graphs: Dict[int, SiteGraph] = {}
    max_r = buckets[-1]
    stride_base = max_r - k + 1
    for rr in region_runs_list:
        lo_region = max(0, rr.start)
        for payload in rr.payloads:
            codes = payload.codes
            nmask = codes >= 4
            L = len(codes)
            noff_total = L - k + 1
            pos = 0
            while pos < noff_total:
                take_off = min(stride_base, noff_total - pos)
                chunk_len = take_off + k - 1
                r = next(b for b in buckets if b >= chunk_len)
                c_valid = np.zeros(r - k + 1, dtype=bool)
                c_valid[:take_off] = payload.valid[pos : pos + take_off]
                chunk = RunChunk((rr.key, payload.ref), pos)
                if resident and payload.ref[0] == -1:
                    gk = (r, id(rr.graph))
                    res_graphs[id(rr.graph)] = rr.graph
                    res_bucket.setdefault(gk, []).append(
                        (lo_region + pos, c_valid, chunk)
                    )
                else:
                    c_codes = np.zeros(r, dtype=np.uint8)
                    c_codes[:chunk_len] = codes[pos : pos + chunk_len]
                    c_n = np.zeros(r, dtype=bool)
                    c_n[:chunk_len] = nmask[pos : pos + chunk_len]
                    per_bucket.setdefault(r, []).append(
                        (c_codes, c_n, c_valid, chunk)
                    )
                pos += take_off
    for r, rows in per_bucket.items():
        packed = pack_run_seqs(np.stack([x[0] for x in rows]))
        nbits = pack_bits(np.stack([x[1] for x in rows]))
        vbits = pack_bits(np.stack([x[2] for x in rows]))
        batches.append(
            DeviceBatch(
                R=r, packed=packed, nbits=nbits, vbits=vbits,
                chunks=[x[3] for x in rows],
            )
        )
    for (r, gid), rows in res_bucket.items():
        batches.append(
            DeviceBatch(
                R=r, packed=None, nbits=None,
                vbits=pack_bits(np.stack([x[1] for x in rows])),
                chunks=[x[2] for x in rows],
                gstart=np.array([x[0] for x in rows], dtype=np.int32),
                graph=res_graphs[gid],
            )
        )
    if resident:
        # python-built batches only: the native pipeline already emitted
        # patch descriptors for its substitution-only cluster chunks
        batches = batches[:n_native_batches] + _convert_patchable(
            batches[n_native_batches:], by_key, k
        )
    return batches


def _patch_info(rr: RegionRuns, ref: Tuple[int, int], k: int):
    """Patch representation of one cluster combination run, or None when
    it is not substitution-only (indels, lowercase/ambiguous alt bases, or
    patches over genome N).  Returns ``(flank_l, [(genome coord, base
    code)])`` — the run is then ``genome[flank_l:...]`` with those bases
    substituted (memoised per run ref)."""
    c_idx, _x_idx = ref
    if c_idx < 0:
        return None  # backbone / fallback windows
    memo = getattr(rr, "_patch_cache", None)
    if memo is None:
        memo = rr._patch_cache = {}
    if ref in memo:
        return memo[ref]
    clusters = cluster_sites(rr.graph, rr.start, rr.stop, k)
    cluster = clusters[c_idx]
    combo = nth_combination(cluster, ref[1])
    info = None
    patches = []
    ok = True
    for site, a in zip(cluster, combo):
        allele = site.alleles[a]
        if len(allele) != site.ref_end - site.ref_start:
            ok = False
            break
        if a == 0:
            continue
        for o, ch in enumerate(allele):
            refc = rr.graph.seq[site.ref_start + o]
            if ch == refc:
                continue
            code = "ACGT".find(ch)
            if code < 0 or refc not in "ACGT":
                ok = False
                break
            patches.append((site.ref_start + o, code))
        if not ok:
            break
    if ok:
        flank_l = max(0, cluster[0].ref_start - (k - 1))
        info = (flank_l, patches)
    memo[ref] = info
    return info


def _convert_patchable(
    batches: List[DeviceBatch], by_key: Dict[str, RegionRuns], k: int
) -> List[DeviceBatch]:
    """Split substitution-only cluster rows out of packed batches into
    device-resident patched batches (4B offset + 2B/patch on the wire
    instead of R/4 packed sequence bytes).  Rows keep their chunk
    bookkeeping; scores are bit-identical by construction (positions past
    the chunk read genome instead of zero padding, but no valid window
    reaches them)."""
    out: List[DeviceBatch] = []
    for b in batches:
        if b.packed is None or b.R < MIN_PATCH_R:
            out.append(b)
            continue
        slots = PATCH_SLOTS_SHORT if b.R <= SHORT_PATCH_R else PATCH_SLOTS
        conv: Dict[int, list] = {}  # graph id -> [row indices]
        conv_data: Dict[int, list] = {}  # graph id -> [(gstart, patches)]
        graphs: Dict[int, SiteGraph] = {}
        for i, chunk in enumerate(b.chunks):
            rr = by_key.get(chunk.source[0])
            if rr is None:
                continue
            info = _patch_info(rr, chunk.source[1], k)
            if info is None:
                continue
            flank_l, coord_patches = info
            g0 = flank_l + chunk.chunk_off
            row = [
                (c - g0) * 4 + code
                for c, code in coord_patches
                if g0 <= c < g0 + b.R
            ]
            if len(row) > slots:
                continue
            gid = id(rr.graph)
            graphs[gid] = rr.graph
            conv.setdefault(gid, []).append(i)
            conv_data.setdefault(gid, []).append((g0, row))
        if not conv:
            out.append(b)
            continue
        moved = set()
        for gid, idxs in conv.items():
            moved.update(idxs)
            pat = np.full((len(idxs), slots), -1, dtype=np.int16)
            for j, (_g0, row) in enumerate(conv_data[gid]):
                pat[j, : len(row)] = row
            out.append(
                DeviceBatch(
                    R=b.R, packed=None, nbits=None,
                    vbits=b.vbits[idxs],
                    chunks=[b.chunks[i] for i in idxs],
                    gstart=np.array(
                        [g for g, _ in conv_data[gid]], dtype=np.int32
                    ),
                    graph=graphs[gid],
                    patches=pat,
                )
            )
        rest = [i for i in range(len(b.chunks)) if i not in moved]
        if rest:
            out.append(
                DeviceBatch(
                    R=b.R,
                    packed=b.packed[rest],
                    nbits=b.nbits[rest],
                    vbits=b.vbits[rest],
                    chunks=[b.chunks[i] for i in rest],
                )
            )
    return out


def batch_wire_stats(batches: List[DeviceBatch], k: int) -> Dict[str, dict]:
    """Host->device wire bytes per row category — the measurement that
    decides where residency work pays (multi-indel combinations keep
    the packed path).

    Categories: ``backbone`` (4B genome-offset descriptors), ``patched``
    (4B offset + 2B/patch-slot substitution descriptors), ``spliced``
    (patched + 4B per splice entry — indel combinations), ``packed``
    (R/4 sequence + R/8 N-mask bytes — multi-indel chunks, short
    buckets, fallback windows).  Validity bitmaps are charged to every
    category (scan_batches skips them for clean slices, so this is an
    upper bound).
    """
    stats = {
        c: {"rows": 0, "bytes": 0, "windows": 0}
        for c in ("backbone", "patched", "spliced", "packed")
    }
    for b in batches:
        n = len(b.chunks)
        noff = b.R - k + 1
        vbytes = n * ((noff + 7) // 8)
        if b.gstart is not None and b.splice is not None:
            s = stats["spliced"]
            s["bytes"] += (
                n * (4 + 2 * b.splice.shape[1] + 2 * b.patches.shape[1])
                + vbytes
            )
        elif b.gstart is not None and b.patches is not None:
            s = stats["patched"]
            s["bytes"] += n * (4 + 2 * b.patches.shape[1]) + vbytes
        elif b.gstart is not None:
            s = stats["backbone"]
            s["bytes"] += n * 4 + vbytes
        else:
            s = stats["packed"]
            s["bytes"] += n * (b.R // 4 + b.R // 8) + vbytes
        s["rows"] += n
        s["windows"] += n * noff
    return stats


def _format_wire_stats(stats: Dict[str, dict]) -> str:
    tot = max(1, sum(s["bytes"] for s in stats.values()))
    parts = [
        f"{c} {s['rows']} rows / {s['bytes'] / 1024:.0f} KiB "
        f"({100 * s['bytes'] / tot:.0f}%)"
        for c, s in stats.items()
        if s["rows"]
    ]
    return "wire: " + ", ".join(parts) if parts else "wire: no batches"


@dataclass
class RunScanResult:
    hists: np.ndarray  # (hist_size, M) int64
    hits: List[Tuple[Tuple[str, int], int, int]]  # (source, offset, col)
    n_windows_per_col: np.ndarray
    scoring_time: float = 0.0


_SHARD_KERNEL_FACTORIES: Dict[object, dict] = {}


def _shard_kernels_for(mesh) -> dict:
    """Per-mesh cache of :func:`_make_shard_kernels` (the wrapped
    steppers own jit caches — rebuilding them per scan_batches call
    would recompile every per-width pass)."""
    got = _SHARD_KERNEL_FACTORIES.get(mesh)
    if got is None:
        got = _make_shard_kernels(mesh)
        _SHARD_KERNEL_FACTORIES[mesh] = got
    return got


def _make_shard_kernels(mesh):
    """shard_map-wrapped production kernels for multi-device hosts.

    Every shard runs the ORIGINAL single-device kernel on its
    static-shaped row block, and the only collectives are an explicit
    ``psum`` of the ``(hist_size, m)`` histogram + scalar hit counts and
    the stacked top-index lists — no partitioner choices at all (GSPMD
    auto-sharding of the same kernels once picked an all-gather plan for
    the compressed histogram that deadlocked XLA:CPU's in-process
    communicator).

    Returned wrappers are call-compatible with the ``*_topk`` kernels
    they wrap.  Cross-shard semantics:

    * histogram: per-shard zero-based accumulation, ``psum``, added to
      the donated accumulator in the outer jit — bit-identical;
    * ``n_hits``: per-shard counts summed.  Exact whenever the compact
      list is consumed (no shard overflowed); when any shard overflows
      its slots both values exceed ``topk`` and the caller takes the
      same exact bitmask fallback;
    * ``top_vals``: per-shard ascending flat indices are shifted into
      the global row space (``+ shard * rows_local * noff * m``) —
      shards own disjoint ascending ranges, so the global first-``K``
      list is the sorted concatenation (empty slots sort past
      ``INT32_MAX``), identical to the single-device list.

    Bit-parity with the single-device dispatch is pinned by
    ``tests/test_parallel.py::test_scan_batches_mesh_identity`` (this
    path) on the 8-device CPU mesh.
    """
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import grafimo_tpu.ops.score_runs as _sr

    # arg layouts AFTER hist_acc, BEFORE the static ints: True = row-
    # sharded over 'data' (dim 0), False = replicated
    LAYOUT = {
        "device": (True, True, True, False, False, False),
        "resident": (False, False, True, True, False, False, False),
        "patched": (False, False, True, True, True, False, False, False),
        "spliced": (
            False, False, True, True, True, True, False, False, False,
        ),
        # strided/onehot rows are IMPLICIT — (lo, b, stride) defines
        # them, no per-row offset array exists — so the only (possibly)
        # row-sharded operand is vbits; the row split happens inside the
        # body by offsetting each shard's lo and dividing the static b
        "strided": (False, False, False, True, False, False, False),
        "onehot": (False, False, False, True, False, False, False),
    }
    INNER = {
        "device": _sr.scan_runs_device_topk,
        "resident": _sr.scan_runs_resident_topk,
        "patched": _sr.scan_runs_resident_patched_topk,
        "spliced": _sr.scan_runs_resident_spliced_topk,
        "strided": _sr.scan_runs_resident_strided_topk,
        "onehot": _sr.scan_runs_resident_onehot_topk,
    }
    # kinds whose kstat leads with (b, stride) instead of (r, k): the
    # caller cannot pad their rows (a pad row would read genome past
    # the resident plane's margin), so the dispatch only routes here
    # when b divides the mesh
    IMPLICIT_ROWS = ("strided", "onehot")
    n_shards = int(mesh.shape["data"])

    @functools.lru_cache(maxsize=64)
    def _build(kind, none_mask, kstat, m, noff):
        inner = INNER[kind]
        layout = LAYOUT[kind]
        hist_size_ = kstat[-2]
        topk = kstat[-1]
        live_row = [
            row for i, row in enumerate(layout) if not none_mask[i]
        ] + [False]  # + hist_bases (replicated)
        in_specs = tuple(P("data") if row else P() for row in live_row)

        def body(*args):
            it = iter(args)
            full = [
                None if none_mask[i] else next(it)
                for i in range(len(layout))
            ]
            bases = next(it)
            zero = jnp.zeros((hist_size_, m), jnp.int32)
            shard = jax.lax.axis_index("data").astype(jnp.int32)
            kstat_local = kstat
            if kind in IMPLICIT_ROWS:
                # rows are (lo, b, stride)-implicit: each shard scans
                # its own contiguous b/n block by offsetting lo — the
                # caller guarantees b % n_shards == 0
                b_tot, stride_ = kstat[0], kstat[1]
                rows_local = b_tot // n_shards
                full[2] = full[2] + shard * jnp.int32(
                    rows_local * stride_
                )
                kstat_local = (rows_local,) + kstat[1:]
            else:
                rows_local = full[layout.index(True)].shape[0]
            h, hb, nh, tv = inner(
                zero, *full, *kstat_local, hist_bases=bases
            )
            h = jax.lax.psum(h, "data")
            # shift per-shard ascending flat indices (+1-coded, row
            # stride noff*m) into the global row space: shards own
            # contiguous disjoint ascending ranges
            tv = jnp.where(
                tv > 0, tv + shard * (rows_local * noff * m), 0
            )
            return h, hb, nh[None], tv[None]

        out_specs = (
            P(),
            P("data"),
            P("data"),
            P("data"),
        )
        shmap = jax.shard_map(
            body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )

        @functools.partial(jax.jit, donate_argnums=(0,))
        def stepper(hist_acc, *arrays):
            h, hb, nh_st, tv_st = shmap(*arrays)
            nh = nh_st.sum().astype(jnp.int32)
            flat = tv_st.reshape(-1)
            k_slots = min(topk, flat.shape[0])
            key = jnp.where(flat > 0, flat, jnp.int32(0x7FFFFFFF))
            merged = jax.lax.sort(key)[:k_slots]
            tv = jnp.where(merged == jnp.int32(0x7FFFFFFF), 0, merged)
            return hist_acc + h, hb, nh, tv

        return stepper

    def wrap(kind):
        n_arr = len(LAYOUT[kind])

        def call(hist_acc, *args, hist_bases=None):
            arrays = args[:n_arr]
            kstat = tuple(int(s) for s in args[n_arr:])
            m = hist_acc.shape[1]
            if kind == "device":
                r = arrays[0].shape[1] * 4  # packed (B, R/4)
                noff = r - kstat[0] + 1
            elif kind in IMPLICIT_ROWS:
                noff = kstat[2] - kstat[3] + 1  # (b, stride, r, k, ...)
            else:
                noff = kstat[0] - kstat[1] + 1  # r - k + 1
            none_mask = tuple(a is None for a in arrays)
            stepper = _build(kind, none_mask, kstat, m, noff)
            live = [a for a in arrays if a is not None] + [hist_bases]
            return stepper(hist_acc, *live)

        return call

    return {k_: wrap(k_) for k_ in
            ("device", "resident", "patched", "spliced",
             "strided", "onehot")}


def scan_batches(
    batches: List[DeviceBatch],
    pwm_kernel: np.ndarray,
    min_scores: np.ndarray,
    cutoffs: np.ndarray,
    k: int,
    hist_size: int,
    collect_hits: bool = True,
    progress: bool = False,
) -> RunScanResult:
    import jax
    import jax.numpy as jnp

    from grafimo_tpu.ops.score_runs import (
        absorb_slice,
        nplane_genome,
        onehot_genome,
        package_block,
        scan_runs_device_topk,
        scan_runs_resident_onehot_topk,
        scan_runs_resident_patched_topk,
        scan_runs_resident_spliced_topk,
        scan_runs_resident_strided_topk,
        scan_runs_resident_topk,
    )

    TOPK = SCAN_TOPK
    SMALLK = SCAN_SMALLK
    FLUSH_SLICES = SCAN_FLUSH_SLICES
    # multi-device: shard slice rows over a (data,) mesh of all local
    # devices; every shard runs the SAME kernel (SURVEY.md §2.18:
    # data-parallel windows, replicated PWM + chromosome).  Sharding never
    # changes values, only layout, so the single-device and N-device paths
    # are bit-identical.  One device => plain local execution.
    import os

    # local devices only: auto-sharding device_puts host-local numpy
    # arrays, which cannot land on non-addressable devices of a multi-
    # process run (multi-host data parallelism shards REGIONS per
    # process instead, parallel/cluster.py)
    devs = jax.local_devices()
    mesh = None
    _shardmap_on = False
    if len(devs) > 1 and not os.environ.get("GRAFIMO_TPU_SINGLE_DEVICE"):
        from jax.sharding import Mesh, NamedSharding, PartitionSpec

        mesh = Mesh(np.asarray(devs), ("data",))
        s_rep = NamedSharding(mesh, PartitionSpec())
        s_rows = NamedSharding(mesh, PartitionSpec("data"))
        n_data = len(devs)
        # shard_map dispatch (default): every shard runs the original
        # single-device kernel and only explicit psums cross devices.
        # The GSPMD auto-shard path (GRAFIMO_SHARDMAP_SCAN=0) is kept
        # for A-B comparison.
        _shardmap_on = os.environ.get("GRAFIMO_SHARDMAP_SCAN", "1") != "0"
        if _shardmap_on:
            _sk = _shard_kernels_for(mesh)
            scan_runs_device_topk = _sk["device"]
            scan_runs_resident_topk = _sk["resident"]
            scan_runs_resident_patched_topk = _sk["patched"]
            scan_runs_resident_spliced_topk = _sk["spliced"]
            scan_runs_resident_strided_topk = _sk["strided"]
            scan_runs_resident_onehot_topk = _sk["onehot"]

    def _rep(x):
        """Replicate over the mesh (no-op single-device)."""
        return jax.device_put(x, s_rep) if mesh is not None else x

    def _rows(x):
        """Shard dim 0 over the mesh data axis (no-op single-device)."""
        return jax.device_put(x, s_rows) if mesh is not None else x

    pwm_dev = _rep(pwm_kernel)
    mins_dev = _rep(min_scores.astype(np.int32))
    cuts_dev = _rep(cutoffs.astype(np.int32))
    # Exact per-column histogram compression: column m's window scores
    # can only fall in [base_m, top_m] = [sum_j min, sum_j max] of its
    # PWM columns (~40-50% of the full RANGE*k span for real motifs),
    # plus the N-window replacement value min_scores[m].  Device
    # histograms run over the compressed bins (0 = N value, 1+i =
    # base_m + i; ops/score_runs._score_codes) and expand back to
    # absolute scores at each flush.  PWM entries are integers <= 1020
    # held exactly in f32, so the sums below are exact.
    pwm_np = np.asarray(pwm_kernel)
    # HBM-resident packed chromosomes, uploaded once per scan
    genome_dev: Dict[int, tuple] = {}
    # resident ONE-HOT genome (8 bytes/base + 1 byte/base N plane),
    # decoded on device once per chromosome for the strided fast path;
    # at most one chromosome's one-hot planes stay resident at a time
    # (LRU-1: whole-genome scans visit chromosomes in batch order)
    onehot_dev: Dict[int, tuple] = {}

    def _onehot_for(graph):
        gkey = id(graph)
        if gkey not in onehot_dev:
            onehot_dev.clear()
            g4, gn = genome_dev[gkey]
            goh = onehot_genome(g4)
            gn8 = nplane_genome(gn) if gn is not None else None
            onehot_dev[gkey] = (goh, gn8)
        return onehot_dev[gkey]

    m = pwm_kernel.shape[-1]
    # GRAFIMO_HIST_COMPRESS=force turns compression on.  Off by default:
    # with the scatter-add histogram it saves no device time on an H100
    # (PERF.md, "Findings").
    use_comp = os.environ.get("GRAFIMO_HIST_COMPRESS", "off") == "force"
    if use_comp:
        hist_bases = pwm_np.min(axis=1).sum(axis=0).astype(np.int64)
        hist_tops = pwm_np.max(axis=1).sum(axis=0).astype(np.int64)
    else:
        hist_bases = np.zeros(pwm_np.shape[-1], np.int64)
        hist_tops = np.full(pwm_np.shape[-1], hist_size - 1, np.int64)
    hist_spans = hist_tops - hist_bases + 1
    comp_size = int(hist_spans.max()) + 1
    bases_dev = _rep(hist_bases.astype(np.int32))
    mins_i64 = min_scores.astype(np.int64)
    hits: List[Tuple[Tuple[str, int], int, int]] = []
    t0 = time.perf_counter()
    # everything accumulates on device (donated buffers); ONE device->
    # host round trip per FLUSH_SLICES slices fetches histogram + hit
    # counts + compacted hit indices together
    hist_acc = _rep(jnp.zeros((comp_size, m), jnp.int32))
    nh_acc = _rep(jnp.zeros((FLUSH_SLICES,), jnp.int32))
    top_acc = _rep(jnp.zeros((FLUSH_SLICES, SMALLK), jnp.int32))
    hist_host = np.zeros((hist_size, m), dtype=np.int64)

    def _absorb_comp(comp: np.ndarray) -> None:
        """Expand one compressed device histogram block into the
        absolute-score accumulator (linear, exact: bin 0 is the
        N-window value min_scores[col], bin 1+i is base_col + i)."""
        for col in range(m):
            b0 = int(hist_bases[col])
            sp = int(hist_spans[col])
            hist_host[int(mins_i64[col]), col] += int(comp[0, col])
            hist_host[b0 : b0 + sp, col] += comp[1 : 1 + sp, col]
            if comp[1 + sp :, col].any():
                raise _DeviceHostMismatch(
                    "device histogram holds scores above the motif's "
                    "maximum possible score — device scoring fault"
                )
    # per-slice entries [batch, row0, hitbits, top_idx, n_hits, top_small]
    pending: List[list] = []
    n_in_block = 0
    # kernel dispatches since the last flush, counted UNCONDITIONALLY —
    # hist-only passes (collect_hits=False, e.g. the --qvalueT pre-pass)
    # must flush too, or genome-scale scans push single int32 histogram
    # bins toward overflow before the final flush
    since_flush = 0
    # live progress (reference's polling progress bar,
    # utils.py:607-654): enqueued/confirmed slice counts + windows/s +
    # ETA, at most one line per second, overwritten in place on a tty
    slices_done = 0
    slices_confirmed = 0
    total_slices = 0
    for _b in batches:
        _rows_per = max(
            1, (_dispatch_cap() // max(1, m // 4)) // _b.R
        )
        _n = (
            _b.gstart.shape[0]
            if _b.gstart is not None
            else _b.packed.shape[0]
        )
        total_slices += -(-_n // _rows_per)
    last_progress = [t0]

    def _progress():
        if not progress:
            return
        import sys

        now = time.perf_counter()
        if now - last_progress[0] < 1.0 and slices_done < total_slices:
            return
        last_progress[0] = now
        elapsed = now - t0
        nwin = int(hist_host[:, 0].sum())
        frac = slices_confirmed / max(1, total_slices)
        rate = nwin / elapsed if elapsed > 0 else 0.0
        eta = (
            f"{elapsed * (1.0 - frac) / frac:.0f}s" if frac > 0 else "--"
        )
        end = "\r" if sys.stderr.isatty() else "\n"
        sys.stderr.write(
            f"scan: {slices_done}/{total_slices} slices enqueued, "
            f"{slices_confirmed} done ({100 * frac:.0f}%), "
            f"{nwin:,} windows/strand, {rate:,.0f} windows/s, "
            f"ETA {eta}{end}"
        )

    def _flush():
        nonlocal hist_acc, nh_acc, top_acc, n_in_block, since_flush
        nonlocal slices_confirmed
        since_flush = 0
        n_pow2 = 1
        while n_pow2 < n_in_block:
            n_pow2 *= 2
        n_pow2 = min(n_pow2, FLUSH_SLICES)
        flat = np.asarray(
            package_block(
                hist_acc, nh_acc, top_acc, n_pow2 if n_in_block else 0
            )
        )
        hs = comp_size * m
        _absorb_comp(flat[:hs].astype(np.int64).reshape(comp_size, m))
        hist_acc = _rep(jnp.zeros((comp_size, m), jnp.int32))
        # the fetch above is a stream barrier: every enqueued slice has
        # executed by the time it returns
        slices_confirmed = slices_done
        _progress()
        if not n_in_block:
            return
        nh_blk = flat[hs : hs + n_pow2]
        tops = flat[hs + n_pow2 :].reshape(n_pow2, SMALLK)
        base = len(pending) - n_in_block
        for j in range(n_in_block):
            ent = pending[base + j]
            nh = int(nh_blk[j])
            ent[4] = nh
            ent[5] = tops[j]
            # release device buffers that can no longer be needed (frees
            # HBM while the scan is still running)
            if nh <= SMALLK:
                ent[2] = ent[3] = None
            elif nh <= TOPK:
                ent[2] = None
            else:
                # dense slice: the bitmask fallback never reads top_idx
                # (its contents clamp past topk) — free it now
                ent[3] = None
        nh_acc = _rep(jnp.zeros((FLUSH_SLICES,), jnp.int32))
        top_acc = _rep(jnp.zeros((FLUSH_SLICES, SMALLK), jnp.int32))
        n_in_block = 0

    for batch in batches:
        # slice large batches so device intermediates stay bounded; the
        # dominant intermediates scale with rows*R (one-hot) AND with
        # rows*noff*M (scores / hit predicates), so shrink slices as the
        # motif-column count grows
        budget = _dispatch_cap() // max(1, m // 4)
        rows_per = max(1, budget // batch.R)
        noff_b = batch.R - k + 1
        # expected vbits bytes for an all-valid row (tail bits zero)
        full_row = np.full((noff_b + 7) // 8, 0xFF, dtype=np.uint8)
        if noff_b % 8:
            full_row[-1] = (1 << (noff_b % 8)) - 1
        if batch.gstart is not None:
            gkey = id(batch.graph)
            if gkey not in genome_dev:
                # cached ACROSS scan_batches calls (per-width passes and
                # the qvalueT path reuse the same chromosome): the genome
                # crosses the link once per process, not once per pass
                cache_key = (tuple(devs), mesh is not None)
                cached = getattr(batch.graph, "_genome_dev_cache", None)
                if cached is not None and cached[0] == cache_key:
                    genome_dev[gkey] = cached[1]
                else:
                    c4, npl = _resident_genome(batch.graph)
                    put = (
                        _rep(c4) if mesh is not None else jax.device_put(c4),
                        (
                            _rep(npl)
                            if mesh is not None
                            else jax.device_put(npl)
                        )
                        if npl is not None
                        else None,
                    )
                    genome_dev[gkey] = put
                    batch.graph._genome_dev_cache = (cache_key, put)
        n_rows = (
            batch.gstart.shape[0]
            if batch.gstart is not None
            else batch.packed.shape[0]
        )
        for lo in range(0, n_rows, rows_per):
            hi = min(lo + rows_per, n_rows)
            # clean slices skip the mask uploads entirely (static None
            # branch in ops/score_runs._scan_core)
            vb = batch.vbits[lo:hi]
            vb = None if (vb == full_row).all() else vb
            # pad rows to a multiple of the mesh data axis; pad rows are
            # all-invalid (zero vbits) so they never reach histograms,
            # hit bits or hit indices
            pad = (-(hi - lo)) % n_data if mesh is not None else 0
            if pad:
                if vb is None:
                    vb = np.tile(full_row, (hi - lo, 1))
                vb = np.concatenate(
                    [vb, np.zeros((pad, vb.shape[1]), np.uint8)]
                )
            if vb is not None:
                vb = _rows(vb)
            if batch.gstart is not None:
                g4, gn = genome_dev[id(batch.graph)]
                gs = batch.gstart[lo:hi]
                if pad:
                    gs = np.concatenate([gs, np.zeros(pad, gs.dtype)])
                if batch.patches is not None:
                    pt = batch.patches[lo:hi]
                    if pad:
                        pt = np.concatenate(
                            [
                                pt,
                                np.full(
                                    (pad, pt.shape[1]), -1, dtype=pt.dtype
                                ),
                            ]
                        )
                    if batch.splice is not None:
                        sp = batch.splice[lo:hi]
                        if pad:
                            sp = np.concatenate(
                                [
                                    sp,
                                    np.full(
                                        (pad, sp.shape[1]), 0x7FFF,
                                        dtype=sp.dtype,
                                    ),
                                ]
                            )
                        hist_acc, hitbits, n_hits, top_idx = (
                            scan_runs_resident_spliced_topk(
                                hist_acc, g4, gn, _rows(gs), _rows(sp),
                                _rows(pt), vb, pwm_dev, mins_dev,
                                cuts_dev, batch.R, k, comp_size, TOPK,
                                hist_bases=bases_dev,
                            )
                        )
                    else:
                        hist_acc, hitbits, n_hits, top_idx = (
                            scan_runs_resident_patched_topk(
                                hist_acc, g4, gn, _rows(gs), _rows(pt),
                                vb, pwm_dev, mins_dev, cuts_dev, batch.R,
                                k, comp_size, TOPK, hist_bases=bases_dev,
                            )
                        )
                else:
                    # uniformly strided slices (whole-region backbone
                    # chunk sequences) skip the per-row word gather —
                    # the expansion becomes one span decode + reshapes
                    stride = batch.R - k + 1
                    # mesh eligibility: the strided kernels shard rows
                    # by splitting b inside the shard_map body, so b
                    # must divide the mesh and NO pad rows may exist (a
                    # pad row would read genome past the plane margin).
                    # pad > 0 already fails the diff check below (pad
                    # gs entries are 0), so full slices — the vast
                    # majority at chromosome scale — route here and
                    # remainder slices take the gather fallback.
                    if (
                        len(gs) > 1
                        and (
                            mesh is None
                            or (_shardmap_on and len(gs) % n_data == 0)
                        )
                        and 2 * stride >= batch.R
                        and (np.diff(gs) == stride).all()
                    ):
                        # the span decode must stay inside the padded
                        # plane: dynamic_slice would CLAMP an
                        # out-of-range start and silently shift every
                        # row of the slice (see _resident_genome's
                        # margin derivation)
                        _need = (int(gs[0]) // 16) + (
                            len(gs) * stride + batch.R + 15
                        ) // 16 + 1
                        if _need > g4.shape[0]:
                            # not an assert: under python -O the guard
                            # would vanish and the clamped slice would
                            # silently drop tail hits
                            raise RuntimeError(
                                f"strided span {_need} words exceeds "
                                f"the resident plane {g4.shape[0]} — "
                                "margin regression in _resident_genome"
                            )
                        # GRAFIMO_ONEHOT_GENOME=1: resident one-hot
                        # genome variant — on an H100 within a few
                        # per cent of the word kernel either way
                        # (ops/score_runs.scan_runs_resident_onehot_topk)
                        # at 8 bytes/base of device memory; opt-in.
                        if os.environ.get("GRAFIMO_ONEHOT_GENOME"):
                            goh, gn8 = _onehot_for(batch.graph)
                            hist_acc, hitbits, n_hits, top_idx = (
                                scan_runs_resident_onehot_topk(
                                    hist_acc, goh,
                                    gn8 if gn is not None else None,
                                    jnp.int32(int(gs[0])), vb, pwm_dev,
                                    mins_dev, cuts_dev, len(gs), stride,
                                    batch.R, k, comp_size, TOPK,
                                    hist_bases=bases_dev,
                                )
                            )
                        else:
                            hist_acc, hitbits, n_hits, top_idx = (
                                scan_runs_resident_strided_topk(
                                    hist_acc, g4, gn,
                                    jnp.int32(int(gs[0])), vb, pwm_dev,
                                    mins_dev, cuts_dev, len(gs), stride,
                                    batch.R, k, comp_size, TOPK,
                                    hist_bases=bases_dev,
                                )
                            )
                    else:
                        hist_acc, hitbits, n_hits, top_idx = (
                            scan_runs_resident_topk(
                                hist_acc, g4, gn, _rows(gs), vb,
                                pwm_dev, mins_dev, cuts_dev, batch.R, k,
                                comp_size, TOPK, hist_bases=bases_dev,
                            )
                        )
            else:
                nb = batch.nbits[lo:hi]
                nb = None if not nb.any() else nb
                pk = batch.packed[lo:hi]
                if pad:
                    pk = np.concatenate(
                        [pk, np.zeros((pad, pk.shape[1]), np.uint8)]
                    )
                    if nb is not None:
                        nb = np.concatenate(
                            [nb, np.zeros((pad, nb.shape[1]), np.uint8)]
                        )
                if nb is not None:
                    nb = _rows(nb)
                hist_acc, hitbits, n_hits, top_idx = scan_runs_device_topk(
                    hist_acc, _rows(pk), nb, vb,
                    pwm_dev, mins_dev, cuts_dev, k, comp_size, TOPK,
                    hist_bases=bases_dev,
                )
            since_flush += 1
            slices_done += 1
            _progress()
            if collect_hits:
                nh_acc, top_acc = absorb_slice(
                    nh_acc, top_acc, n_hits, top_idx,
                    np.int32(n_in_block),
                )
                pending.append([batch, lo, hitbits, top_idx, 0, None])
                n_in_block += 1
            if since_flush >= FLUSH_SLICES:
                _flush()
    _flush()
    if progress:
        import sys

        if sys.stderr.isatty():
            sys.stderr.write("\n")
    hist_total = hist_host
    for (batch, row0, hitbits, top_idx, nh, top_small) in pending:
        if nh == 0:
            continue
        noff = batch.R - k + 1
        if nh <= SMALLK:
            # speculative small fetch already covered this slice
            flat = top_small[:nh] - 1
        elif nh <= TOPK:
            # compacted path: a few KB of flat indices for this slice
            flat = np.asarray(top_idx)[:nh] - 1
        else:
            flat = None
        if flat is not None:
            rows, rem = np.divmod(flat, noff * m)
            offs, cols = np.divmod(rem, m)
        else:
            # dense slice: fall back to the full bitmask
            mask = unpack_hitbits(np.asarray(hitbits), noff)
            rows, offs, cols = np.nonzero(mask)
        for row, off, col in zip(
            rows.tolist(), offs.tolist(), cols.tolist()
        ):
            chunk = batch.chunks[row0 + row]
            hits.append((chunk.source, chunk.chunk_off + off, col))
    dt = time.perf_counter() - t0
    return RunScanResult(
        hists=hist_total,
        hits=hits,
        n_windows_per_col=hist_total.sum(axis=0),
        scoring_time=dt,
    )


# ASCII complement LUT (A<->T, C<->G, case-preserving; everything else —
# N included — maps to itself)
_COMP_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in (("A", "T"), ("C", "G"), ("a", "t"), ("c", "g")):
    _COMP_LUT[ord(_a)], _COMP_LUT[ord(_b)] = ord(_b), ord(_a)


def _score_windows_host(
    seq_bytes: np.ndarray, score_matrix: np.ndarray, min_score: int
) -> np.ndarray:
    """Exact integer re-scoring of ``(H, k)`` ASCII windows on host (report
    rows; N-containing windows score ``min_score``, reference
    ``score_sequences.py:376-378``)."""
    codes = _SEQ_LUT[seq_bytes]
    has_n = _N_LUT[seq_bytes].any(axis=1)
    k = seq_bytes.shape[1]
    sc = score_matrix[codes, np.arange(k, dtype=np.int64)[None, :]].sum(
        axis=1, dtype=np.int64
    )
    return np.where(has_n, np.int64(min_score), sc)


class _DeviceHostMismatch(RuntimeError):
    """Hit scores absent from the device histogram — device and host
    scoring disagree (a precision regression in the device contraction,
    or a hardware fault).  Always fatal: the report would be wrong."""


def _scan_and_assemble(
    batches, motifs, region_runs_list, by_key, pwm_kernel, min_scores,
    cutoffs, col_meta, lookups, k, hist_size, threshold, no_qvalue,
    qval_t, recomb, verbose,
):
    """One scan pass + per-motif report assembly (the tail of
    :func:`compute_results_runs`)."""
    res = scan_batches(
        batches, pwm_kernel, min_scores, cutoffs, k, hist_size,
        collect_hits=True, progress=True,
    )
    # deterministic report order regardless of extraction threading
    res.hits.sort()
    # multi-host: the integer score histogram is the ONLY cross-host data
    # the exact statistics need — one collective sum makes BH q-values
    # exactly global on every host (SURVEY.md §5.8); hit rows stay local
    # and merge at report assembly below
    import jax

    n_proc = jax.process_count()
    if n_proc > 1:
        from grafimo_tpu.parallel.cluster import allreduce_hist

        res.hists = allreduce_hist(res.hists)
        res.n_windows_per_col = res.hists.sum(axis=0)
    # scanned-work counters, reference format (score_sequences.py:202-203,
    # counting one row per strand like the reference's TSV rows); one line
    # per width bucket — every motif in the bucket scans the same windows
    n_seqs = int(_motif_hist(res.hists, col_meta, 0).sum())
    if n_proc == 1 or jax.process_index() == 0:
        print(f"Scanned sequences:\t{n_seqs}")
        print(f"Scanned nucleotides:\t{n_seqs * k}")
    if verbose:
        n_win = int(res.n_windows_per_col.max(initial=0))
        print(
            f"run scan: {len(batches)} device batches, "
            f"{n_win} windows/strand, {len(res.hits)} raw hits "
            f"({res.scoring_time:.2f}s)"
        )
        print(_format_wire_stats(batch_wire_stats(batches, k)))

    # group hits by source run and reconstruct each run's hits in ONE
    # vectorised batch — dense-hit scans (testmode-style threshold ~ 1)
    # reconstruct millions of windows and a per-hit python loop would
    # dominate wall time.  res.hits is sorted, so insertion order over
    # sources + in-list order reproduce the exact global hit order.
    by_source: Dict[Tuple[str, Tuple[int, int]], List[Tuple[int, int]]] = {}
    for (source, g_off, col) in res.hits:
        by_source.setdefault(source, []).append((g_off, col))
    per_motif = [
        {
            "seqnames": [], "starts": [], "stops": [], "strands": [],
            "scores": [], "seqs": [], "freqs": [], "refs": [],
            # global hit key (source, offset, col): multi-host merge
            # reorders gathered rows by it to reproduce the exact
            # single-process row order
            "keys": [],
        }
        for _ in motifs
    ]
    for source, lst in by_source.items():
        rr = by_key[source[0]]
        run = rr.get_run(source[1])
        offs = np.array([o for o, _ in lst], dtype=np.int64)
        cols = np.array([c for _, c in lst], dtype=np.int64)
        begins, ends, seq_bytes, is_ref, freqs = reconstruct_hits_batch(
            rr.graph, run, offs, k
        )
        scores = np.zeros(len(lst), dtype=np.int64)
        seqs_out: List[Optional[str]] = [None] * len(lst)
        for col in np.unique(cols).tolist():
            sel = np.nonzero(cols == col)[0]
            cmi, strand = col_meta[col]
            sb = seq_bytes[sel]
            if strand == "-":
                sb = _COMP_LUT[sb][:, ::-1]
            scores[sel] = _score_windows_host(
                sb, motifs[cmi].score_matrix, motifs[cmi].min_score
            )
            for j, i in enumerate(sel.tolist()):
                seqs_out[i] = sb[j].tobytes().decode("ascii")
        for i, (g_off, col) in enumerate(lst):
            cmi, strand = col_meta[col]
            rows = per_motif[cmi]
            rows["keys"].append((source, g_off, col))
            if strand == "+":
                start, stop = int(begins[i]), int(ends[i])
            else:
                start, stop = int(ends[i]), int(begins[i])
            rows["seqnames"].append(rr.key)
            rows["starts"].append(start)
            rows["stops"].append(stop)
            rows["strands"].append(strand)
            rows["scores"].append(int(scores[i]))
            rows["seqs"].append(seqs_out[i])
            rows["freqs"].append(int(freqs[i]))
            rows["refs"].append("ref" if is_ref[i] else "non.ref")

    if n_proc > 1:
        # gather every host's rows and restore the global sorted-hit
        # order, so the merged report is bit-identical to a
        # single-process run (round-robin region shards interleave)
        from grafimo_tpu.parallel.cluster import allgather_object

        gathered = allgather_object(per_motif)
        merged = []
        for mi in range(len(motifs)):
            cols = {c: [] for c in per_motif[mi]}
            for part in gathered:
                for c, vals in part[mi].items():
                    cols[c].extend(vals)
            order = sorted(range(len(cols["keys"])), key=cols["keys"].__getitem__)
            merged.append(
                {c: [vals[i] for i in order] for c, vals in cols.items()}
            )
        per_motif = merged

    out: Dict[str, ResultTable] = {}
    for mi, motif in enumerate(motifs):
        hist_m = _motif_hist(res.hists, col_meta, mi)
        qmap = (
            None
            if no_qvalue
            else qvalues_from_histogram(hist_m, lookups[mi].pvalues)
        )
        rows = per_motif[mi]
        scores_int = np.array(rows["scores"], dtype=np.int64)
        pvalues = (
            lookups[mi].pvalues(scores_int)
            if len(scores_int)
            else np.zeros(0)
        )
        qvalues = None
        if qmap is not None:
            missing = [int(s) for s in scores_int if int(s) not in qmap]
            if missing:
                # every hit's score must occupy its histogram bin; a miss
                # means device and host scores disagree (e.g. a precision
                # regression in the scoring contraction)
                raise _DeviceHostMismatch(
                    "device/host score mismatch: hit scores "
                    f"{sorted(set(missing))[:5]} absent from the device "
                    "histogram"
                )
            qvalues = np.array(
                [qmap[int(s)] for s in scores_int], dtype=np.float64
            )
        table = build_results_df(
            motif,
            rows["seqnames"], rows["starts"], rows["stops"], rows["strands"],
            scores_int, pvalues, rows["seqs"], rows["freqs"], rows["refs"],
            qvalues=qvalues,
        )
        out[motif.motif_id] = apply_report_filters(
            table, threshold, qval_t, recomb
        )
    return out


def compute_results_runs(
    motifs: List[Motif],
    region_runs_list: List[RegionRuns],
    threshold: float = 1e-4,
    no_qvalue: bool = False,
    qval_t: bool = False,
    no_reverse: bool = False,
    recomb: bool = False,
    verbose: bool = False,
    cores: int = 0,
    cache_path: Optional[str] = None,
) -> Dict[str, ResultTable]:
    """Scan once, report per motif.  All motifs must share one width."""
    k = motifs[0].width
    if not all(mt.width == k for mt in motifs):
        raise ValueError(
            "compute_results_runs scans one width per call: got widths "
            f"{sorted({mt.width for mt in motifs})} — bucket motifs by "
            "width first (findmotif does, workflows.py)"
        )
    hist_size = RANGE * k + 1
    # PWM columns: per motif forward (+ reverse-complement unless
    # no_reverse); column -> (motif index, strand)
    mats, col_meta = [], []
    for mi, mt in enumerate(motifs):
        mats.append(mt.score_matrix)
        col_meta.append((mi, "+"))
        if not no_reverse:
            mats.append(reverse_complement_pwm(mt.score_matrix))
            col_meta.append((mi, "-"))
    pwm_kernel = pwms_to_conv_kernel(mats)
    min_scores = np.array(
        [motifs[mi].min_score for mi, _ in col_meta], dtype=np.int32
    )
    lookups = [PvalueLookup(mt.pval_table) for mt in motifs]

    import os

    if cache_path and os.path.isfile(cache_path):
        batches, _keys = load_batches(cache_path)
        if verbose:
            print(f"loaded scan checkpoint {cache_path}")
        # fallback single-window runs (-2 refs) are only reconstructible
        # from eagerly-built python payloads; rebuild for those regions
        fb_keys = {
            c.source[0]
            for b in batches
            for c in b.chunks
            if c.source[1][0] == -2
        }
        for rr in region_runs_list:
            if rr.key in fb_keys and not rr._run_cache:
                for run in region_runs(rr.graph, rr.start, rr.stop, k):
                    rr._run_cache[run.ref] = run
    else:
        # checkpoints persist full row payloads, so residency is disabled
        # when a cache dir is in play
        batches = batch_runs(
            region_runs_list, k, threads=cores,
            resident=cache_path is None,
        )
        if cache_path:
            save_batches(
                cache_path, batches, [rr.key for rr in region_runs_list]
            )
            if verbose:
                print(f"wrote scan checkpoint {cache_path}")
    by_key = {rr.key: rr for rr in region_runs_list}

    # One pass serves both -t modes.  BH q-values dominate p-values
    # (q_(i) = min_{j>=i} p_(j)·n/j and every term >= p_(i), so q >= p
    # always): scanning with the p < t score cutoff collects a superset
    # of the q < t hits, the exact q-values come from the SAME pass's
    # histogram, and apply_report_filters drops the excess — no hist-only
    # pre-pass re-uploading every batch (reference derives q after
    # scoring too, score_sequences.py:401-430).
    cutoffs = np.array(
        [lookups[mi].score_cutoff(threshold) for mi, _ in col_meta],
        dtype=np.int32,
    )

    return _scan_and_assemble(
        batches, motifs, region_runs_list, by_key, pwm_kernel,
        min_scores, cutoffs, col_meta, lookups, k, hist_size,
        threshold, no_qvalue, qval_t, recomb, verbose,
    )


def _motif_hist(hists: np.ndarray, col_meta, mi: int) -> np.ndarray:
    """Sum the histogram columns belonging to one motif (both strands)."""
    cols = [ci for ci, (m, _) in enumerate(col_meta) if m == mi]
    return hists[:, cols].sum(axis=1)
