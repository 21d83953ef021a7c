"""Device-resident backbone scanning (ops/score_runs.scan_runs_resident_topk
+ runscan residency partitioning): on-device genome expansion must produce
exactly the same histograms/hits as the packed-upload path."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import frame
from grafimo_tpu.ops.score_runs import (  # noqa: E402
    bytes_to_words,
    pack_bits,
    pack_run_seqs,
    pwms_to_conv_kernel,
    scan_runs_device_topk,
    scan_runs_resident_topk,
)


def _kernel(k, rng):
    mat = rng.integers(0, 1000, (4, k)).astype(np.int64)
    return pwms_to_conv_kernel([mat]), np.array([int(mat.min(0).sum())],
                                                np.int32)


@pytest.mark.parametrize("seed,r,with_n", [(0, 64, False), (1, 128, True),
                                           (2, 256, False)])
def test_resident_matches_packed(seed, r, with_n):
    rng = np.random.default_rng(seed)
    k = 11
    L = 4000
    genome = rng.integers(0, 4, L).astype(np.uint8)
    nmask = np.zeros(L, bool)
    if with_n:
        nmask[rng.integers(0, L, 17)] = True
    pad4 = (-L) % 4
    g_codes = np.concatenate([genome, np.zeros(pad4, np.uint8)])
    genome4 = bytes_to_words(pack_run_seqs(g_codes[None])[0])
    nplane = (
        bytes_to_words(pack_bits(nmask[None])[0]) if with_n else None
    )

    B = 33
    noff = r - k + 1
    gstart = rng.integers(0, L - r, B).astype(np.int32)
    valid = rng.random((B, noff)) < 0.9

    # packed reference: materialise the rows
    rows = np.stack([genome[s : s + r] for s in gstart])
    nrows = np.stack([nmask[s : s + r] for s in gstart])
    kernel, mins = _kernel(k, rng)
    cuts = mins + 5000
    hist_size = 1000 * k + 1
    z = jnp.zeros((hist_size, 1), jnp.int32)
    h1, hb1, nh1, top1 = scan_runs_device_topk(
        z, pack_run_seqs(rows), pack_bits(nrows), pack_bits(valid),
        kernel, mins, cuts, k, hist_size, 64,
    )
    z = jnp.zeros((hist_size, 1), jnp.int32)
    h2, hb2, nh2, top2 = scan_runs_resident_topk(
        z, jnp.asarray(genome4),
        jnp.asarray(nplane) if nplane is not None else None,
        jnp.asarray(gstart), pack_bits(valid),
        kernel, mins, cuts, r, k, hist_size, 64,
    )
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_array_equal(np.asarray(hb1), np.asarray(hb2))
    assert int(nh1) == int(nh2)
    np.testing.assert_array_equal(np.asarray(top1), np.asarray(top2))


def test_resident_batching_partition(input_dir):
    """batch_runs(resident=True) must cover exactly the same chunks as
    resident=False, with backbone rows moved to descriptor batches."""
    from grafimo_tpu.graph.sitegraph import build_graph
    from grafimo_tpu.io.fasta import read_fasta
    from grafimo_tpu.io.vcf import iter_vcf_records
    from grafimo_tpu.runscan import batch_runs, build_region_runs

    seqs = read_fasta(str(input_dir / "test.fa"))
    records = list(iter_vcf_records(str(input_dir / "test.vcf.gz"), "x"))
    graph = build_graph("x", seqs["x"], records)
    k = 7
    rrs1 = build_region_runs(graph, "x", [(0, 50), (10, 45)], k)
    plain = batch_runs(rrs1, k, resident=False)
    rrs2 = build_region_runs(graph, "x", [(0, 50), (10, 45)], k)
    res = batch_runs(rrs2, k, resident=True)

    def chunk_set(batches):
        return sorted(
            (c.source, c.chunk_off) for b in batches for c in b.chunks
        )

    assert chunk_set(plain) == chunk_set(res)
    assert any(b.gstart is not None for b in res)
    for b in res:
        if b.gstart is None:
            continue
        if b.patches is not None:
            # substitution-only cluster combinations ride as patch
            # descriptors (cluster refs, not backbone)
            assert all(c.source[1][0] >= 0 for c in b.chunks)
            continue
        # every plain-resident chunk is a backbone slice whose genome
        # offset reproduces the packed content
        for gs, c in zip(b.gstart.tolist(), b.chunks):
            assert c.source[1][0] == -1
            region = c.source[0].split(":")[1]
            lo = max(0, int(region.split("-")[0]))
            assert gs == lo + c.chunk_off


@pytest.mark.parametrize("single_device", [False, True])
def test_resident_scan_end_to_end(input_dir, monkeypatch, single_device):
    """Full compute_results_runs with residency on vs off: identical
    reports — under both the suite's 8-device shard_map dispatch and
    the single-device path (which alone reaches the strided kernel)."""
    if single_device:
        monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")
    from grafimo_tpu.graph.sitegraph import build_graph
    from grafimo_tpu.io.fasta import read_fasta
    from grafimo_tpu.io.vcf import iter_vcf_records
    from grafimo_tpu.models.parse import load_motifs
    from grafimo_tpu.runscan import batch_runs, compute_results_runs
    from grafimo_tpu.runscan import build_region_runs
    from grafimo_tpu.utils.constants import UNIF
    import grafimo_tpu.runscan as rs

    seqs = read_fasta(str(input_dir / "test.fa"))
    records = list(iter_vcf_records(str(input_dir / "test.vcf.gz"), "x"))
    graph = build_graph("x", seqs["x"], records)
    motifs = load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1, False)

    def run(resident):
        orig = rs.batch_runs
        rs.batch_runs = lambda *a, **kw: orig(
            *a, **{**kw, "resident": resident}
        )
        try:
            rrs = build_region_runs(graph, "x", [(0, 50)], motifs[0].width)
            return compute_results_runs(motifs, rrs, threshold=1.0)
        finally:
            rs.batch_runs = orig

    df_res = run(True)["MA0139.1"]
    df_plain = run(False)["MA0139.1"]
    import pandas as pd

    pd.testing.assert_frame_equal(frame(df_res), frame(df_plain))


def test_genome_device_cache_across_scan_calls(input_dir):
    """The device-resident genome must cross the link once per process:
    a second scan_batches call over the same chromosome (per-width passes,
    the --qvalueT pre-pass) reuses the cached device buffers instead of
    re-uploading."""
    from grafimo_tpu.graph.sitegraph import build_graph
    from grafimo_tpu.io.fasta import read_fasta
    from grafimo_tpu.io.vcf import iter_vcf_records
    from grafimo_tpu.models.parse import load_motifs
    from grafimo_tpu.models.pvalue import PvalueLookup
    from grafimo_tpu.ops.score_jax import reverse_complement_pwm
    from grafimo_tpu.ops.score_runs import pwms_to_conv_kernel
    from grafimo_tpu.runscan import batch_runs, build_region_runs
    from grafimo_tpu.runscan import scan_batches
    from grafimo_tpu.utils.constants import UNIF

    seqs = read_fasta(str(input_dir / "test.fa"))
    records = list(iter_vcf_records(str(input_dir / "test.vcf.gz"), "x"))
    graph = build_graph("x", seqs["x"], records)
    motif = load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1,
                        False)[0]
    k = motif.width
    kernel = pwms_to_conv_kernel(
        [motif.score_matrix, reverse_complement_pwm(motif.score_matrix)]
    )
    mins = np.array([motif.min_score] * 2, np.int32)
    cuts = np.array(
        [PvalueLookup(motif.pval_table).score_cutoff(1e-4)] * 2, np.int32
    )
    hist_size = 1000 * k + 1

    def scan():
        rrs = build_region_runs(graph, "x", [(0, 80)], k)
        batches = batch_runs(rrs, k, resident=True)
        assert any(b.gstart is not None for b in batches)
        return scan_batches(batches, kernel, mins, cuts, k, hist_size)

    res1 = scan()
    cached = getattr(graph, "_genome_dev_cache", None)
    assert cached is not None
    buf1 = cached[1][0]
    res2 = scan()
    # second call reused the cached device buffer (no new device_put:
    # the cache entry still holds the identical buffer object)
    assert graph._genome_dev_cache[1][0] is buf1
    np.testing.assert_array_equal(res1.hists, res2.hists)
    assert sorted(res1.hits) == sorted(res2.hits)


def test_strided_kernel_matches_gather():
    """The gather-free strided expansion (uniform gstart steps) is
    bit-identical to the per-row gather kernel, N plane included."""
    from grafimo_tpu.ops.score_runs import (
        scan_runs_resident_strided_topk,
    )

    rng = np.random.default_rng(31)
    k, r, b = 11, 128, 17
    stride = r - k + 1
    L = -(-(stride * b + r + 200) // 8) * 8
    genome = rng.integers(0, 4, L).astype(np.uint8)
    nmask = np.zeros(L, bool)
    nmask[rng.integers(0, L, 25)] = True
    margin = np.zeros(r // 4 + 8, np.uint8)
    gw = bytes_to_words(
        np.concatenate([pack_run_seqs(genome[None])[0], margin])
    )
    nw = bytes_to_words(
        np.concatenate([pack_bits(nmask[None])[0], margin])
    )
    for lo in (173, 0, 16):  # odd offset exercises the funnel shift
        gstart = (lo + stride * np.arange(b)).astype(np.int32)
        noff = r - k + 1
        valid = rng.random((b, noff)) < 0.9
        kernel, mins = _kernel(k, rng)
        cuts = mins + 4000
        hs = 1000 * k + 1
        z = jnp.zeros((hs, 1), jnp.int32)
        h1, hb1, nh1, t1 = scan_runs_resident_topk(
            z, gw, nw, jnp.asarray(gstart), pack_bits(valid),
            kernel, mins, cuts, r, k, hs, 64,
        )
        z = jnp.zeros((hs, 1), jnp.int32)
        h2, hb2, nh2, t2 = scan_runs_resident_strided_topk(
            z, gw, nw, jnp.int32(lo), pack_bits(valid),
            kernel, mins, cuts, b, stride, r, k, hs, 64,
        )
        np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
        np.testing.assert_array_equal(np.asarray(hb1), np.asarray(hb2))
        np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))


@pytest.mark.parametrize("compressed", [False, True])
def test_onehot_kernel_matches_strided(compressed):
    """The resident one-hot fast path (device-decoded (L, 4) bf16 genome,
    slice + conv, no per-dispatch decode) is bit-identical to the strided
    word kernel — N plane, validity bits and hist compression included."""
    from grafimo_tpu.ops.score_runs import (
        nplane_genome,
        onehot_genome,
        scan_runs_resident_onehot_topk,
        scan_runs_resident_strided_topk,
    )

    rng = np.random.default_rng(57)
    k, r, b = 11, 128, 17
    stride = r - k + 1
    L = -(-(stride * b + r + 200) // 8) * 8
    genome = rng.integers(0, 4, L).astype(np.uint8)
    nmask = np.zeros(L, bool)
    nmask[rng.integers(0, L, 25)] = True
    margin = np.zeros(r // 4 + 8, np.uint8)
    gw = bytes_to_words(
        np.concatenate([pack_run_seqs(genome[None])[0], margin])
    )
    nw = bytes_to_words(
        np.concatenate([pack_bits(nmask[None])[0], margin])
    )
    goh = onehot_genome(gw)
    gn8 = nplane_genome(nw)
    assert goh.shape == (gw.shape[0] * 16, 4)
    for lo in (173, 0, 16):
        noff = r - k + 1
        valid = rng.random((b, noff)) < 0.9
        kernel, mins = _kernel(k, rng)
        cuts = mins + 4000
        if compressed:
            bases = kernel.min(axis=1).sum(axis=0).astype(np.int32)
            tops = kernel.max(axis=1).sum(axis=0).astype(np.int64)
            hs = int((tops - bases).max()) + 2
            hb = jnp.asarray(bases)
        else:
            hs = 1000 * k + 1
            hb = None
        z = jnp.zeros((hs, 1), jnp.int32)
        h1, hb1, nh1, t1 = scan_runs_resident_strided_topk(
            z, gw, nw, jnp.int32(lo), pack_bits(valid),
            kernel, mins, cuts, b, stride, r, k, hs, 64, hist_bases=hb,
        )
        z = jnp.zeros((hs, 1), jnp.int32)
        h2, hb2, nh2, t2 = scan_runs_resident_onehot_topk(
            z, goh, gn8, jnp.int32(lo), pack_bits(valid),
            kernel, mins, cuts, b, stride, r, k, hs, 64, hist_bases=hb,
        )
        np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
        np.testing.assert_array_equal(np.asarray(hb1), np.asarray(hb2))
        np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))


@pytest.mark.parametrize("max_bases", [1 << 24, 8192])
def test_strided_tail_geometry_end_to_end(input_dir, monkeypatch,
                                          max_bases):
    """Whole-chromosome tail geometry: the backbone's remainder chunk can
    re-land in the TOP bucket (chunk_len > BUCKETS[-2]), keeping the row
    starts stride-uniform while the strided span decode
    (ops/score_runs._expand_strided) reads up to ~2R codes past the
    chromosome end.  With the old R+32-code plane margin,
    jax.lax.dynamic_slice either rejected the span outright (single
    slice: slice_sizes > operand shape) or silently CLAMPED its start on
    a later slice — shifting every row of that slice and dropping tail
    hits (caught round 4 on the 50 Mbp chromosome scan).  Both slicings
    must match the packed-upload oracle exactly."""
    from grafimo_tpu.graph.sitegraph import build_graph
    from grafimo_tpu.models.parse import load_motifs
    from grafimo_tpu.runscan import BUCKETS, build_region_runs
    from grafimo_tpu.runscan import compute_results_runs
    from grafimo_tpu.utils.constants import UNIF
    import grafimo_tpu.runscan as rs

    motifs = load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1,
                         False)
    k = motifs[0].width
    R = BUCKETS[-1]
    stride = R - k + 1
    # 5 full strides + a remainder whose chunk re-lands in the top
    # bucket (chunk_len > BUCKETS[-2]) => 6 stride-uniform backbone rows
    rem = BUCKETS[-2] + 52 - (k - 1)
    L = 5 * stride + rem + k - 1
    rng = np.random.default_rng(7)
    seq = rng.integers(0, 4, L).astype(np.uint8)
    seq_str = seq.tobytes().translate(
        bytes.maketrans(bytes(range(4)), b"ACGT")
    ).decode()
    graph = build_graph("c", seq_str, [])

    monkeypatch.setattr(rs, "MAX_BASES_PER_DISPATCH", max_bases)
    monkeypatch.setattr(rs, "MAX_BASES_PER_DISPATCH_CPU", max_bases)
    # the strided kernel only dispatches on the single-device path; the
    # suite's 8-device CPU mesh would otherwise route through shard_map
    # gather kernels and never exercise this geometry
    monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")

    def run(resident):
        orig = rs.batch_runs
        rs.batch_runs = lambda *a, **kw: orig(
            *a, **{**kw, "resident": resident}
        )
        try:
            rrs = build_region_runs(graph, "c", [(0, L)], k)
            return compute_results_runs(
                motifs, rrs, threshold=1e-2
            )["MA0139.1"]
        finally:
            rs.batch_runs = orig

    import pandas as pd

    pd.testing.assert_frame_equal(frame(run(True)), frame(run(False)))
