"""Host-side extraction scaling: threads vs throughput.

Times the two native host stages that feed the chip, at 1/2/4/8 threads
on a chromosome-scale input, so the host budget for one chip is a
measured number:

* the C++ batch pipeline (run construction + chunking + bit packing +
  patch descriptors; ``native/graphite.cpp`` via ``runscan.batch_runs``);
* the C++ VCF scanner (mmap + BGZF inflate + GT->bitset parse;
  ``native/vcfio.cpp``).

CPU-only (no process opens the accelerator):

    timeout 1200 python tools/bench_host_scaling.py [Mbp]
"""

import json
import os
import struct
import sys
import tempfile
import time
import zlib

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from grafimo_tpu.graph.sitegraph import build_graph  # noqa: E402
from grafimo_tpu.io.vcf import VcfRecord  # noqa: E402
from grafimo_tpu.runscan import batch_runs, build_region_runs  # noqa: E402

THREADS = (1, 2, 4, 8)
K = 19


def _bgzf(data: bytes, blk: int = 60000) -> bytes:
    """Minimal BGZF container (64KB-class blocks, as bgzip writes)."""
    out = []
    for i in range(0, len(data), blk):
        chunk = data[i : i + blk]
        comp = zlib.compressobj(6, zlib.DEFLATED, -15)
        payload = comp.compress(chunk) + comp.flush()
        bsize = len(payload) + 25 + 1
        out.append(
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<HHH", 6, 0x4342, 2)
            + struct.pack("<H", bsize - 1)
            + payload
            + struct.pack("<II", zlib.crc32(chunk), len(chunk))
        )
    out.append(  # EOF marker block
        bytes.fromhex(
            "1f8b08040000000000ff0600424302001b0003000000000000000000"
        )
    )
    return b"".join(out)


def main() -> None:
    mbp = float(sys.argv[1]) if len(sys.argv) > 1 else 4.0
    L = int(mbp * 1_000_000)
    H = 5096
    rng = np.random.default_rng(0)
    print(
        f"host cores: {os.cpu_count()}; chromosome {mbp} Mbp, "
        f"1 variant/30bp, {H} haplotypes, k={K}",
        file=sys.stderr,
    )
    t0 = time.perf_counter()
    codes = rng.integers(0, 4, L).astype(np.uint8)
    seq = codes.tobytes().translate(bytes.maketrans(
        bytes(range(4)), b"ACGT"
    )).decode()
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
    print(
        f"synthesise {len(records)} variants: "
        f"{time.perf_counter() - t0:.1f}s",
        file=sys.stderr,
    )
    t0 = time.perf_counter()
    graph = build_graph("c", seq, records)
    t_build = time.perf_counter() - t0
    print(f"graph build: {t_build:.1f}s", file=sys.stderr)

    # --- C++ batch pipeline sweep --------------------------------------
    batcher = {}
    rows_total = None
    for t in THREADS:
        reps = []
        for _ in range(3):
            rr = build_region_runs(graph, "c", [(0, L)], K)
            t0 = time.perf_counter()
            batches = batch_runs(rr, K, threads=t)
            reps.append(time.perf_counter() - t0)
        rows_total = sum(
            (b.gstart.shape[0] if b.gstart is not None
             else b.packed.shape[0])
            for b in batches
        )
        best = min(reps)
        batcher[t] = best
        print(
            f"batcher {t} threads: {best:.3f}s  "
            f"({mbp / best:.1f} Mbp/s, {rows_total / best / 1e6:.2f} M "
            f"rows/s)",
            file=sys.stderr,
        )

    # --- C++ VCF scanner sweep ------------------------------------------
    from grafimo_tpu.native import vcf_scan_native

    Hv = 2000
    n_rec = min(len(records), 30000)
    lines = [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(f"s{i}" for i in range(Hv // 2)),
    ]
    gts = rng.integers(0, 2, (n_rec, Hv)).astype(np.int8)
    pair_lut = np.array(["0|0", "1|0", "0|1", "1|1"])
    pair_codes = gts[:, 0::2] * 1 + gts[:, 1::2] * 2  # (n_rec, Hv/2)
    pair_strs = pair_lut[pair_codes]
    for i, r in enumerate(records[:n_rec]):
        samp = "\t".join(pair_strs[i].tolist())
        lines.append(
            f"c\t{r.pos}\t.\t{r.ref}\t{r.alts[0]}\t.\tPASS\t.\tGT\t{samp}"
        )
    data = ("\n".join(lines) + "\n").encode()
    vcf_path = os.path.join(
        tempfile.gettempdir(), "bench_host_scaling.vcf.gz")
    with open(vcf_path, "wb") as fh:
        fh.write(_bgzf(data))
    vcf = {}
    for t in THREADS:
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = vcf_scan_native(vcf_path, "c", n_threads=t)
            reps.append(time.perf_counter() - t0)
        best = min(reps)
        vcf[t] = best
        print(
            f"vcf scan {t} threads: {best:.3f}s  "
            f"({n_rec / best / 1e3:.1f} k records/s, "
            f"{len(data) / best / 1e6:.0f} MB/s decompressed)",
            file=sys.stderr,
        )
    os.remove(vcf_path)

    print(json.dumps({
        "host_cores": os.cpu_count(),
        "mbp": mbp,
        "n_variants": len(records),
        "graph_build_s": round(t_build, 2),
        "batcher_s_by_threads": {str(t): round(v, 3) for t, v in
                                 batcher.items()},
        "batcher_mbp_per_s_by_threads": {
            str(t): round(mbp / v, 1) for t, v in batcher.items()
        },
        "batcher_rows": int(rows_total),
        "vcf_scan_s_by_threads": {str(t): round(v, 3) for t, v in
                                  vcf.items()},
        "vcf_krec_per_s_by_threads": {
            str(t): round(n_rec / v / 1e3, 1) for t, v in vcf.items()
        },
    }))


if __name__ == "__main__":
    main()
