"""JASPAR-scale device throughput: one resident pass with ~100 PWMs
(200 motif columns incl. reverse complements) — validates the
MAX_BASES_PER_DISPATCH / (m//4) device-memory scaling at m~200 and records
window-strand-motif/s (BASELINE.json config 5).  Run alone, under
timeout."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from grafimo_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from grafimo_tpu.models.background import load_bg
    from grafimo_tpu.models.motif import Motif
    from grafimo_tpu.models.parse import _prepare_counts_motif
    from grafimo_tpu.models.process import process_motif
    from grafimo_tpu.models.pvalue import PvalueLookup
    from grafimo_tpu.ops.score_jax import reverse_complement_pwm
    from grafimo_tpu.ops.score_runs import (
        pwms_to_conv_kernel,
        scan_runs_resident_topk,
    )
    from grafimo_tpu.runscan import MAX_BASES_PER_DISPATCH
    from grafimo_tpu.utils.constants import UNIF

    rng = np.random.default_rng(0)
    k = 19
    n_motifs = 100
    t0 = time.time()
    bgs = load_bg(UNIF, False)
    motifs = []
    for i in range(n_motifs):
        counts = rng.integers(1, 300, (4, k)).astype(np.float64)
        motifs.append(
            process_motif(
                _prepare_counts_motif(
                    Motif(
                        motif_id=f"J{i:03d}", motif_name=f"J{i:03d}",
                        counts=counts, width=k,
                    ),
                    bgs, 0.1,
                )
            )
        )
    print(f"process {n_motifs} motifs: {time.time() - t0:.1f}s", flush=True)
    mats, mins, cuts = [], [], []
    for mt in motifs:
        lk = PvalueLookup(mt.pval_table)
        c = lk.score_cutoff(1e-4)
        for mat in (mt.score_matrix, reverse_complement_pwm(mt.score_matrix)):
            mats.append(mat)
            mins.append(mt.min_score)
            cuts.append(c)
    kernel = pwms_to_conv_kernel(mats)
    m = kernel.shape[-1]
    hist_size = 1000 * k + 1
    # production HBM scaling: rows per dispatch shrinks with m
    R = 2048
    budget = MAX_BASES_PER_DISPATCH // max(1, m // 4)
    B = max(1, budget // R)
    noff = R - k + 1
    print(f"m={m} columns -> B={B} rows x R={R} per dispatch", flush=True)

    genome_codes = rng.integers(0, 4, 16_000_000).astype(np.uint8)
    quads = genome_codes.reshape(-1, 4)
    genome4 = jax.device_put(
        (
            quads[:, 0] | (quads[:, 1] << 2)
            | (quads[:, 2] << 4) | (quads[:, 3] << 6)
        ).astype(np.uint8)
    )
    gstart = jax.device_put(
        rng.integers(0, len(genome_codes) - R, B).astype(np.int32)
    )
    pwm_dev = jax.device_put(kernel)
    mins_d = jax.device_put(np.asarray(mins, np.int32))
    cuts_d = jax.device_put(np.asarray(cuts, np.int32))
    h = jnp.zeros((hist_size, m), jnp.int32)
    t0 = time.time()
    h, hb, nh, tv = scan_runs_resident_topk(
        h, genome4, None, gstart, None, pwm_dev, mins_d, cuts_d,
        R, k, hist_size, 8192,
    )
    np.asarray(h).sum()
    print(f"compile+warm: {time.time() - t0:.1f}s", flush=True)
    iters = 8
    t0 = time.perf_counter()
    for _ in range(iters):
        h, hb, nh, tv = scan_runs_resident_topk(
            h, genome4, None, gstart, None, pwm_dev, mins_d, cuts_d,
            R, k, hist_size, 8192,
        )
    cs = int(np.asarray(h).sum())
    dt = (time.perf_counter() - t0) / iters
    elems = B * noff * m
    print(
        f"JASPAR-scale dispatch: {dt * 1e3:.1f} ms/iter, "
        f"{elems / dt / 1e9:.3f} G window-strand-motif/s "
        f"({B}x{noff} windows x {m} cols, cs={cs})",
        flush=True,
    )


if __name__ == "__main__":
    main()
