"""Single-GPU scan throughput benchmark.

Prints the card's name and power limit, then ONE JSON line:
``{"metric", "value", "unit", "vs_baseline", ..., "device"}``.  Exits
non-zero, with no number, when JAX finds no GPU.

    python bench.py

Measures the production scoring path (the run-compressed engine behind
``findmotif``): run batches stream host->device each iteration in the
engine's measured category mix on 1KGP-like input — device-resident
backbone descriptors, patch-descriptor substitution rows, span-spliced
indel rows and packed fallback rows (window shares 16/71/12/1,
``tools/bench_indel_wire.py``) — and the device expands and scores
EVERY stride-1 window on both strands (conv over the one-hot sequence
with forward + reverse-complement PWM columns), builds the exact
integer score histogram, applies the integer p-value cutoff, and the
packed hit bits + histogram are fetched back to the host.  A "window" is one strand-scored candidate window — the
unit matching one row of the reference's extraction TSVs (its
``scanned sequences`` counter, ``score_sequences.py:202``).

Baseline: the reference (GRAFIMO, PLOS Comp Bio 2021 numbers shipped
in-repo, see BASELINE.md) needs 942.3 s at 16 threads for the CTCF x
3000-ENCODE-regions x 1KGP-pangenome scan — order 5e3 scanned windows/s
per host.  ``vs_baseline`` divides by that 5e3 figure.
"""

import json
import sys
import time

import numpy as np


def _device_main() -> None:
    """The device benchmark (the only process that opens the card)."""
    import jax

    from grafimo_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {dev.platform!r}")

    from grafimo_tpu.models.parse import load_motifs
    from grafimo_tpu.ops.score_jax import reverse_complement_pwm
    from grafimo_tpu.ops.score_runs import (
        pack_bits,
        pack_run_seqs,
        pwms_to_conv_kernel,
    )
    from grafimo_tpu.utils.constants import UNIF

    motif = load_motifs(
        "tests/data/input/MA0139.1.meme", UNIF, 0.1, False
    )[0]
    k = motif.width
    hist_size = 1000 * k + 1
    kernel = pwms_to_conv_kernel(
        [motif.score_matrix, reverse_complement_pwm(motif.score_matrix)]
    )
    mins = np.array([motif.min_score] * 2, dtype=np.int32)
    # integer cutoff equivalent to the default p < 1e-4 threshold
    from grafimo_tpu.models.pvalue import PvalueLookup

    cutoff = PvalueLookup(motif.pval_table).score_cutoff(1e-4)
    cuts = np.array([cutoff] * 2, dtype=np.int32)

    from grafimo_tpu.runscan import (
        PATCH_SLOTS,
        DeviceBatch,
        RunChunk,
        scan_batches,
    )

    B, R = 2048, 2048  # runs per batch x run length
    noff = R - k + 1
    # Batch mix = the engine's measured window shares on 1KGP-like input
    # (tools/bench_indel_wire.py, 12% indels, 5096 haplotypes:
    # backbone 16% / patched 71% / spliced 12% / packed 1.3% of
    # windows).
    MIX = (
        ["backbone"] * 4 + ["patched"] * 16 + ["spliced"] * 3 + ["packed"]
    )
    iters = len(MIX)
    rng = np.random.default_rng(0)

    # HBM-resident synthetic chromosome (uploaded once, like a real scan)
    class _GenomeShim:
        """Duck-typed graph for runscan._resident_genome (needs .seq)."""

    genome_codes = rng.integers(0, 4, 64_000_000).astype(np.uint8)
    shim = _GenomeShim()
    shim.seq = (
        np.frombuffer(b"ACGT", np.uint8)[genome_codes].tobytes().decode()
    )

    def make_batches(seed):
        r2 = np.random.default_rng(seed)
        out = []
        for i, kind in enumerate(MIX):
            chunks = [RunChunk(("bench", (-1, 0)), 0) for _ in range(B)]
            common = dict(
                R=R, packed=None, nbits=None,
                vbits=pack_bits(np.ones((B, noff), bool)),
                chunks=chunks, graph=shim,
            )
            gstart = r2.integers(8, len(shim.seq) - R - 64, B).astype(
                np.int32
            )
            if kind == "backbone":
                out.append(DeviceBatch(gstart=gstart, **common))
            elif kind == "patched":
                # substitution combination rows: ~3 patches/row
                # (pos*4+base descriptors, rest of the slots empty)
                pat = np.full((B, PATCH_SLOTS), -1, dtype=np.int16)
                for s in range(3):
                    pat[:, s] = (
                        r2.integers(0, R, B) * 4 + r2.integers(0, 4, B)
                    ).astype(np.int16)
                out.append(
                    DeviceBatch(gstart=gstart, patches=pat, **common)
                )
            elif kind == "spliced":
                # single-indel combination rows: one live (bound, shift)
                # splice entry + one inserted-base patch
                splice = np.full((B, 4), 0x7FFF, dtype=np.int16)
                splice[:, 0] = r2.integers(k, R - k, B).astype(np.int16)
                splice[:, 1] = r2.integers(-8, 9, B).astype(np.int16)
                pat = np.full((B, PATCH_SLOTS), -1, dtype=np.int16)
                pat[:, 0] = (
                    splice[:, 0].astype(np.int64) * 4
                    + r2.integers(0, 4, B)
                ).astype(np.int16)
                out.append(
                    DeviceBatch(
                        gstart=gstart, splice=splice, patches=pat,
                        **common,
                    )
                )
            else:  # packed (multi-indel chunks / short-bucket fallback)
                codes = r2.integers(0, 4, (B, R)).astype(np.uint8)
                nmask = np.zeros((B, R), bool)
                nmask[r2.integers(0, B, 32), r2.integers(0, R, 32)] = 1
                out.append(
                    DeviceBatch(
                        R=R, packed=pack_run_seqs(codes),
                        nbits=pack_bits(nmask),
                        vbits=pack_bits(np.ones((B, noff), bool)),
                        chunks=chunks,
                    )
                )
        return out

    # warmup pass: compiles every variant, uploads the resident genome
    scan_batches(
        make_batches(1), kernel, mins, cuts, k, hist_size,
        collect_hits=True,
    )
    # timed pass streams FRESH host batches (JAX reuses device buffers
    # for repeated ndarrays — only the resident genome may be reused,
    # that reuse being the whole point)
    res = scan_batches(
        make_batches(2), kernel, mins, cuts, k, hist_size,
        collect_hits=True,
    )
    dt = res.scoring_time

    n_windows = B * noff * 2 * iters  # both strands
    windows_per_s = n_windows / dt

    # device-resident throughput: the production kernel with every input
    # already in device memory (the device-bound figure, free of the
    # host->device link)
    import jax.numpy as jnp

    from grafimo_tpu.ops.score_runs import scan_runs_resident_topk

    # the streaming scan above cached the device-resident genome on the
    # shim graph (runscan._resident_genome upload) — reuse that buffer
    g4_dev = shim._genome_dev_cache[1][0]
    gs_dev = jax.device_put(
        rng.integers(0, len(genome_codes) - R, B).astype(np.int32)
    )
    mins_dev = jax.device_put(mins)
    cuts_dev = jax.device_put(cuts)
    pwm_dev = jax.device_put(kernel)
    res_iters = 12
    hist_acc = jnp.zeros((hist_size, 2), jnp.int32)
    h, hb, nh, tv = scan_runs_resident_topk(
        hist_acc, g4_dev, None, gs_dev, None, pwm_dev, mins_dev,
        cuts_dev, R, k, hist_size, 8192,
    )
    jax.block_until_ready(h)  # warm
    t0 = time.perf_counter()
    for _ in range(res_iters):
        h, hb, nh, tv = scan_runs_resident_topk(
            h, g4_dev, None, gs_dev, None, pwm_dev, mins_dev, cuts_dev,
            R, k, hist_size, 8192,
        )
    jax.block_until_ready(h)
    dt_res = time.perf_counter() - t0
    res_checksum = int(np.asarray(h).sum())
    resident_ws = B * noff * 2 * res_iters / dt_res

    baseline = 5e3  # reference windows/s/host at 16 threads (BASELINE.md)
    print(
        json.dumps(
            {
                "metric": "windows_scored_per_s_per_chip",
                "value": round(windows_per_s, 1),
                "unit": "windows/s",
                "vs_baseline": round(windows_per_s / baseline, 1),
                "device_resident_windows_per_s": round(resident_ws, 1),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    print(
        f"# device={dev.device_kind} runs/batch={B} R={R} k={k} "
        f"iters={iters} (mix: 4 backbone / 16 patched / 3 spliced "
        f"/ 1 packed, per measured 1KGP shares) time={dt:.3f}s "
        f"hits={len(res.hits)} "
        f"hist_checksum={int(res.hists.sum())} "
        f"resident: {res_iters} iters {dt_res:.3f}s "
        f"checksum={res_checksum}",
        file=sys.stderr,
    )


def main() -> int:
    """Print the card, then run the benchmark in a child process: this
    process never initialises JAX, so only the child opens the card."""
    import os
    import subprocess

    if os.environ.get("GRAFIMO_BENCH_INNER") == "1":
        _device_main()
        return 0
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        sys.stderr.write(f"bench: no GPU ({e})\n")
        return 1
    print(card, flush=True)
    env = dict(os.environ, GRAFIMO_BENCH_INNER="1")
    return subprocess.run(
        [sys.executable, "-u", os.path.abspath(__file__)], env=env
    ).returncode


if __name__ == "__main__":
    sys.exit(main())
