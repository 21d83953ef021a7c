"""Multi-chip scan pipeline: data-parallel windows x motif-parallel PWMs.

The reference's only parallelism was single-host ``multiprocessing`` over
TSV chunks with Manager-dict merges (``score_sequences.py:115-157``).  The
layout here (SURVEY.md §2.18, §5.8):

* window batches are sharded over the mesh ``data`` axis (every window is
  independent — the scan is embarrassingly data-parallel);
* the PWM block is sharded over the ``motif`` axis (model parallelism over
  independent motifs; with one motif the axis is 1);
* per-shard integer score histograms are ``psum``-reduced over ``data`` —
  the ONLY cross-chip communication, a few hundred KB per motif — giving
  every chip the exact global score distribution, from which exact p-value
  cutoffs and exact global BH q-values follow without gathering any
  per-window data;
* hits are compacted host-side from the sharded score output.

The same step function serves 1 device, 1 host, or N hosts; only
the mesh changes.
"""

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from grafimo_tpu.ops.score_jax import score_hist_core
from grafimo_tpu.utils.constants import PAD_CODE


def make_mesh(
    n_data: Optional[int] = None, n_motif: int = 1, devices=None
) -> Mesh:
    """Build a ``(data, motif)`` mesh over the available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = devices.size // n_motif
    devices = devices[: n_data * n_motif].reshape(n_data, n_motif)
    return Mesh(devices, axis_names=("data", "motif"))


def sharded_scan_step(mesh: Mesh, hist_size: int):
    """Build the jitted multi-chip scan step for a given mesh.

    Returns ``step(codes, pwm_flat, min_scores, cutoffs) -> (scores, hist,
    hit_counts)`` where

    * ``codes (B, k)`` is sharded ``P('data', None)``;
    * ``pwm_flat (4k, M)`` and ``min_scores``/``cutoffs (M,)`` are sharded
      over ``motif`` (replicated when the motif axis is 1);
    * ``scores (B, M)`` comes back sharded ``P('data', 'motif')``;
    * ``hist (hist_size, M)`` is the ``data``-psum'd exact global histogram
      (sharded over ``motif`` only);
    * ``hit_counts (M,)`` are global per-motif counts of ``score >=
      cutoff`` (integer-exact device-side thresholding; the cutoff encodes
      ``p-value < t``, see ``models/pvalue.PvalueLookup.score_cutoff``).
    """

    def _step(codes, pwm_flat, min_scores, cutoffs):
        # the exact core shared with ops/score_jax.score_and_histogram —
        # one source of truth for the scoring math
        scores, hist = score_hist_core(codes, pwm_flat, min_scores, hist_size)
        hist = jax.lax.psum(hist, "data")
        hits = jnp.sum(
            ((scores >= cutoffs[None, :]) & (scores >= 0)).astype(jnp.int32),
            axis=0,
        )
        hits = jax.lax.psum(hits, "data")
        return scores, hist, hits

    step = jax.jit(
        jax.shard_map(
            _step,
            mesh=mesh,
            in_specs=(
                P("data", None),
                P(None, "motif"),
                P("motif"),
                P("motif"),
            ),
            out_specs=(P("data", "motif"), P(None, "motif"), P("motif")),
        )
    )

    def run(
        codes: np.ndarray,
        pwm_flat: np.ndarray,
        min_scores: np.ndarray,
        cutoffs: Optional[np.ndarray] = None,
    ):
        if cutoffs is None:
            cutoffs = np.zeros(pwm_flat.shape[1], dtype=np.int32)
        codes_sh = jax.device_put(
            codes, NamedSharding(mesh, P("data", None))
        )
        return step(
            codes_sh,
            jnp.asarray(pwm_flat),
            jnp.asarray(min_scores),
            jnp.asarray(cutoffs, dtype=jnp.int32),
        )

    return run


def sharded_run_scan(mesh: Mesh, k: int, hist_size: int):
    """Multi-chip version of the production run scan
    (``ops/score_runs.scan_runs_device``): run rows shard over ``data``,
    PWM columns over ``motif``, histograms psum over ``data``.

    Returns ``run(packed, nbits, vbits, pwm_kernel, min_scores, cutoffs)
    -> (hist, hitbits, hit_counts)`` with

    * ``packed (B, R/4) uint8`` sharded ``P('data', None)`` (pad ``B`` to
      the data-axis size with all-valid=False rows);
    * ``hist (hist_size, M)`` the exact global histogram;
    * ``hitbits (B, ceil(Noff/8), M)`` sharded over ``data``;
    * ``hit_counts (M,)`` global.
    """
    from grafimo_tpu.ops.score_runs import _scan_core

    def _step(packed, nbits, vbits, pwm_kernel, min_scores, cutoffs):
        hist, hitbits = _scan_core(
            packed, nbits, vbits, pwm_kernel, min_scores, cutoffs, k,
            hist_size,
        )
        hist = jax.lax.psum(hist, "data")
        counts = jnp.sum(
            jax.lax.population_count(hitbits.astype(jnp.uint32)),
            axis=(0, 1),
        ).astype(jnp.int32)
        counts = jax.lax.psum(counts, "data")
        return hist, hitbits, counts

    step = jax.jit(
        jax.shard_map(
            _step,
            mesh=mesh,
            in_specs=(
                P("data", None),
                P("data", None),
                P("data", None),
                P(None, None, "motif"),
                P("motif"),
                P("motif"),
            ),
            out_specs=(
                P(None, "motif"),
                P("data", None, "motif"),
                P("motif"),
            ),
        )
    )

    def run(packed, nbits, vbits, pwm_kernel, min_scores, cutoffs):
        sh = NamedSharding(mesh, P("data", None))
        return step(
            jax.device_put(packed, sh),
            jax.device_put(nbits, sh),
            jax.device_put(vbits, sh),
            jnp.asarray(pwm_kernel),
            jnp.asarray(min_scores, dtype=jnp.int32),
            jnp.asarray(cutoffs, dtype=jnp.int32),
        )

    return run


def sharded_resident_scan(
    mesh: Mesh, r: int, k: int, hist_size: int, with_n: bool = False,
):
    """Multi-chip device-resident backbone scan
    (``ops/score_runs.scan_runs_resident_topk``'s expansion inside a
    ``shard_map``): the packed chromosome is REPLICATED on every chip
    (uploaded once, tiny vs HBM), run descriptors shard over ``data``,
    PWM columns over ``motif``, histograms psum over ``data``.

    Returns ``run(genome4, [ngenome,] gstart, vbits, pwm_kernel,
    min_scores, cutoffs) -> (hist, hitbits, hit_counts)``; the genome
    planes are int32 words (``ops/score_runs.bytes_to_words``).  Pad
    ``gstart``
    to the data-axis size with 0s and pad ``vbits`` with all-zero rows —
    padding windows are invalid and drop from histograms and counts.
    """
    from grafimo_tpu.ops.score_runs import (
        _expand_resident,
        _expand_resident_bits,
        _score_codes,
    )

    def _finish(hist, hitbits):
        hist = jax.lax.psum(hist, "data")
        counts = jnp.sum(
            jax.lax.population_count(hitbits.astype(jnp.uint32)),
            axis=(0, 1),
        ).astype(jnp.int32)
        counts = jax.lax.psum(counts, "data")
        return hist, hitbits, counts

    if with_n:
        def _step(genome4, ngenome, gstart, vbits, pwm_kernel,
                  min_scores, cutoffs):
            codes = _expand_resident(genome4, gstart, r)
            n_ind = _expand_resident_bits(ngenome, gstart, r)
            hist, hitbits = _score_codes(
                codes, n_ind, vbits, pwm_kernel, min_scores, cutoffs,
                k, hist_size,
            )
            return _finish(hist, hitbits)

        in_specs = (
            P(None), P(None), P("data"), P("data", None),
            P(None, None, "motif"), P("motif"), P("motif"),
        )
    else:
        def _step(genome4, gstart, vbits, pwm_kernel, min_scores,
                  cutoffs):
            codes = _expand_resident(genome4, gstart, r)
            hist, hitbits = _score_codes(
                codes, None, vbits, pwm_kernel, min_scores, cutoffs,
                k, hist_size,
            )
            return _finish(hist, hitbits)

        in_specs = (
            P(None), P("data"), P("data", None),
            P(None, None, "motif"), P("motif"), P("motif"),
        )

    step = jax.jit(
        jax.shard_map(
            _step,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=(
                P(None, "motif"),
                P("data", None, "motif"),
                P("motif"),
            ),
        )
    )

    def run(*args):
        genome_args = args[: 2 if with_n else 1]
        gstart, vbits, pwm_kernel, min_scores, cutoffs = args[
            2 if with_n else 1 :
        ]
        sh_data = NamedSharding(mesh, P("data"))
        sh_rows = NamedSharding(mesh, P("data", None))
        rep = NamedSharding(mesh, P(None))
        put = [jax.device_put(g, rep) for g in genome_args]
        return step(
            *put,
            jax.device_put(np.asarray(gstart, dtype=np.int32), sh_data),
            jax.device_put(vbits, sh_rows),
            jnp.asarray(pwm_kernel),
            jnp.asarray(min_scores, dtype=jnp.int32),
            jnp.asarray(cutoffs, dtype=jnp.int32),
        )

    return run


def pad_batch(codes: np.ndarray, multiple: int, pad_code: int = PAD_CODE):
    """Pad the window batch to a multiple of the data-shard count.  Padding
    rows carry ``PAD_CODE`` and score ``-1``: they are dropped from
    histograms and hit counts on device; strip them by row count on the
    scores output."""
    b = codes.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return codes, b
    pad = np.full((rem, codes.shape[1]), pad_code, dtype=codes.dtype)
    return np.concatenate([codes, pad]), b
