"""Synthetic pangenome-scale demo: 10 Mbp chromosome, 333k variants,
5096 haplotypes, 10 motifs of three widths, whole-chromosome scan.
Run from the repo root: python -u examples/demo_pangenome_scan.py
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time, numpy as np
from grafimo_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
from grafimo_tpu.graph.sitegraph import build_graph
from grafimo_tpu.io.vcf import VcfRecord
from grafimo_tpu.models.motif import Motif
from grafimo_tpu.models.parse import _prepare_counts_motif
from grafimo_tpu.models.background import load_bg
from grafimo_tpu.models.process import process_motif
from grafimo_tpu.runscan import build_region_runs, compute_results_runs
from grafimo_tpu.utils.constants import UNIF

rng = np.random.default_rng(0)
L = 10_000_000
t0=time.time()
seq = "".join(rng.choice(list("ACGT"), L))
positions = np.sort(rng.choice(np.arange(1, L-10), L//30, replace=False))
H = 5096
records = []; last = 0
for p in positions:
    p = int(p)
    if p < last: continue
    alt = "ACGT"[(("ACGT".index(seq[p]))+1)%4]
    gt = (rng.integers(0, 7, H) == 0).astype(np.int32)
    records.append(VcfRecord("c", p+1, seq[p], [alt], gt))
    last = p+1
print(f"synthesise {len(records)} variants: {time.time()-t0:.1f}s", flush=True)
t0=time.time(); g = build_graph("c", seq, records); print(f"graph build: {time.time()-t0:.1f}s", flush=True)
bgs = load_bg(UNIF, False)
motifs = []
for i in range(10):
    k = [11, 15, 19][i % 3]
    counts = rng.integers(1, 300, (4, k)).astype(np.float64)
    m = Motif(motif_id=f"M{i:02d}", motif_name=f"M{i:02d}", counts=counts, width=k)
    motifs.append(process_motif(_prepare_counts_motif(m, bgs, 0.1)))
by_width = {}
for m in motifs: by_width.setdefault(m.width, []).append(m)
total_hits = 0
t_all = time.time()
for k, ms in sorted(by_width.items()):
    t0=time.time()
    rr = build_region_runs(g, "c", [(0, L)], k)
    tables = compute_results_runs(ms, rr, threshold=1e-5, recomb=False, verbose=True)
    nh = sum(len(t) for t in tables.values())
    total_hits += nh
    print(f"width {k} x {len(ms)} motifs: {time.time()-t0:.1f}s hits={nh}", flush=True)
print(f"TOTAL scan wall: {time.time()-t_all:.1f}s, hits={total_hits}", flush=True)
