"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import jax
import numpy as np
import pytest

from grafimo_tpu.models.parse import load_motifs
from grafimo_tpu.ops.score_jax import (
    hist_size_for_width,
    pwms_to_flat,
    reverse_complement_pwm,
    score_and_histogram,
)
from grafimo_tpu.parallel.pipeline import make_mesh, pad_batch, sharded_scan_step
from grafimo_tpu.utils.constants import UNIF


@pytest.fixture(scope="module")
def ctcf(input_dir):
    return load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1, False)[0]


def test_sharded_matches_single_device(ctcf):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (1024, 19)).astype(np.uint8)
    pwm = pwms_to_flat([ctcf.score_matrix, reverse_complement_pwm(ctcf.score_matrix)])
    mins = np.array([ctcf.min_score, ctcf.min_score], dtype=np.int32)
    hs = hist_size_for_width(19)

    ref_scores, ref_hist = score_and_histogram(codes, pwm, mins, hs)
    mesh = make_mesh(n_data=4, n_motif=2)
    run = sharded_scan_step(mesh, hs)
    cutoffs = np.array([1000, 1000], dtype=np.int32)
    scores, hist, hits = run(codes, pwm, mins, cutoffs)
    np.testing.assert_array_equal(np.asarray(scores), np.asarray(ref_scores))
    np.testing.assert_array_equal(np.asarray(hist), np.asarray(ref_hist))
    expect_hits = (np.asarray(ref_scores) >= 1000).sum(axis=0)
    np.testing.assert_array_equal(np.asarray(hits), expect_hits)


def test_padding_excluded_from_histogram(ctcf):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, (1001, 19)).astype(np.uint8)  # not % 8
    pwm = pwms_to_flat([ctcf.score_matrix])
    mins = np.array([ctcf.min_score], dtype=np.int32)
    hs = hist_size_for_width(19)
    padded, n_valid = pad_batch(codes, 8)
    assert padded.shape[0] == 1008 and n_valid == 1001
    mesh = make_mesh(n_data=8, n_motif=1)
    run = sharded_scan_step(mesh, hs)
    scores, hist, hits = run(padded, pwm, mins, np.array([0], np.int32))
    assert int(np.asarray(hist).sum()) == 1001
    assert int(np.asarray(hits)[0]) == 1001  # pads score -1, excluded
    # unpadded scores match the plain path
    ref_scores, _ = score_and_histogram(codes, pwm, mins, hs)
    np.testing.assert_array_equal(
        np.asarray(scores)[:1001, 0], np.asarray(ref_scores)[:, 0]
    )


def test_rc_pwm_equals_scoring_revcomp(ctcf):
    from grafimo_tpu.ops.encode import revcomp_codes, seqs_to_codes
    from grafimo_tpu.ops.score_jax import score_batch

    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, (256, 19)).astype(np.uint8)
    pwm_f = pwms_to_flat([ctcf.score_matrix])
    pwm_rc = pwms_to_flat([reverse_complement_pwm(ctcf.score_matrix)])
    mins = np.array([ctcf.min_score], dtype=np.int32)
    s_rc_pwm = np.asarray(score_batch(codes, pwm_rc, mins))
    s_direct = np.asarray(score_batch(revcomp_codes(codes), pwm_f, mins))
    np.testing.assert_array_equal(s_rc_pwm, s_direct)


def test_mesh_uses_all_devices():
    assert len(jax.devices()) == 8
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_resident_matches_single_device(ctcf):
    """Resident multi-chip step == single-device resident scan."""
    import jax.numpy as jnp

    from grafimo_tpu.ops.score_runs import (
        bytes_to_words,
        pack_bits,
        pack_run_seqs,
        pwms_to_conv_kernel,
        scan_runs_resident_topk,
    )
    from grafimo_tpu.parallel.pipeline import sharded_resident_scan

    rng = np.random.default_rng(3)
    k = ctcf.width
    R = 64
    noff = R - k + 1
    B = 64
    L = 4096
    genome = rng.integers(0, 4, L).astype(np.uint8)
    genome4 = bytes_to_words(pack_run_seqs(genome[None, :])[0])
    gstart = rng.integers(0, L - R, B).astype(np.int32)
    valid = rng.random((B, noff)) < 0.8
    vbits = pack_bits(valid)
    kernel = pwms_to_conv_kernel(
        [ctcf.score_matrix, reverse_complement_pwm(ctcf.score_matrix)]
    )
    mins = np.array([ctcf.min_score] * 2, np.int32)
    cuts = mins + 4000
    hs = hist_size_for_width(k)

    z = jnp.zeros((hs, 2), jnp.int32)
    ref_hist, ref_hb, ref_nh, _ = scan_runs_resident_topk(
        z, jnp.asarray(genome4), None, jnp.asarray(gstart), vbits,
        kernel, mins, cuts, R, k, hs, 64,
    )
    mesh = make_mesh(n_data=4, n_motif=2)
    run = sharded_resident_scan(mesh, R, k, hs)
    hist, hitbits, counts = run(genome4, gstart, vbits, kernel, mins, cuts)
    np.testing.assert_array_equal(np.asarray(hist), np.asarray(ref_hist))
    np.testing.assert_array_equal(np.asarray(hitbits), np.asarray(ref_hb))
    assert int(np.asarray(counts).sum()) == int(ref_nh)


def test_scan_batches_mesh_identity(monkeypatch):
    """The GSPMD-sharded production scan (8 virtual devices) must be
    bit-identical to the forced single-device path — sharding changes
    layout, never values."""
    import numpy as np

    from grafimo_tpu.models.parse import load_motifs
    from grafimo_tpu.models.pvalue import PvalueLookup
    from grafimo_tpu.ops.score_jax import reverse_complement_pwm
    from grafimo_tpu.ops.score_runs import (
        pack_bits,
        pack_run_seqs,
        pwms_to_conv_kernel,
    )
    from grafimo_tpu.runscan import DeviceBatch, RunChunk, scan_batches
    from grafimo_tpu.utils.constants import UNIF
    from tests.conftest import DATA

    motif = load_motifs(
        str(DATA / "input" / "MA0139.1.meme"), UNIF, 0.1, False
    )[0]
    k = motif.width
    hs = 1000 * k + 1
    kern = pwms_to_conv_kernel(
        [motif.score_matrix, reverse_complement_pwm(motif.score_matrix)]
    )
    mins = np.array([motif.min_score] * 2, np.int32)
    cut = PvalueLookup(motif.pval_table).score_cutoff(1e-3)
    cuts = np.array([cut] * 2, np.int32)
    rng = np.random.default_rng(7)
    B, R = 37, 64  # deliberately NOT a multiple of the 8-device mesh
    noff = R - k + 1
    codes = rng.integers(0, 4, (B, R)).astype(np.uint8)
    nmask = np.zeros((B, R), bool)
    nmask[3, 10] = True
    valid = rng.random((B, noff)) < 0.9
    chunks = [RunChunk(("t", (-1, 0)), 0) for _ in range(B)]
    batch = DeviceBatch(
        R=R, packed=pack_run_seqs(codes), nbits=pack_bits(nmask),
        vbits=pack_bits(valid), chunks=chunks,
    )
    res_mesh = scan_batches([batch], kern, mins, cuts, k, hs)
    monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")
    res_one = scan_batches([batch], kern, mins, cuts, k, hs)
    assert (res_mesh.hists == res_one.hists).all()
    assert sorted(res_mesh.hits) == sorted(res_one.hits)
    assert res_mesh.n_windows_per_col.tolist() == [
        int(valid.sum())
    ] * 2


def test_scan_batches_shardmap_all_kinds_identity(ctcf, monkeypatch):
    """shard_map dispatch with histogram compression forced: backbone / patched / spliced / packed batches all produce
    bit-identical histograms and hit lists to the single-device path."""
    from grafimo_tpu.models.pvalue import PvalueLookup
    from grafimo_tpu.ops.score_runs import pack_bits, pack_run_seqs
    from grafimo_tpu.runscan import (
        PATCH_SLOTS,
        DeviceBatch,
        RunChunk,
        scan_batches,
    )
    from grafimo_tpu.ops.score_runs import pwms_to_conv_kernel

    k = ctcf.width
    hs = 1000 * k + 1
    kern = pwms_to_conv_kernel(
        [ctcf.score_matrix, reverse_complement_pwm(ctcf.score_matrix)]
    )
    mins = np.array([ctcf.min_score] * 2, np.int32)
    cut = PvalueLookup(ctcf.pval_table).score_cutoff(1e-2)
    cuts = np.array([cut] * 2, np.int32)
    B, R = 21, 64  # not a multiple of the 8-device mesh
    noff = R - k + 1
    rng = np.random.default_rng(11)

    class Shim:
        pass

    shim = Shim()
    shim.seq = "".join(
        "ACGT"[c] for c in rng.integers(0, 4, 4096)
    )

    def make_batches():
        r2 = np.random.default_rng(5)
        out = []
        for kind in ("backbone", "patched", "spliced", "packed"):
            chunks = [RunChunk(("t", (-1, 0)), 0) for _ in range(B)]
            common = dict(
                R=R, packed=None, nbits=None,
                vbits=pack_bits(r2.random((B, noff)) < 0.9),
                chunks=chunks, graph=shim,
            )
            gstart = r2.integers(8, 4096 - R - 64, B).astype(np.int32)
            if kind == "backbone":
                out.append(DeviceBatch(gstart=gstart, **common))
            elif kind == "patched":
                pat = np.full((B, PATCH_SLOTS), -1, np.int16)
                pat[:, 0] = (
                    r2.integers(0, R, B) * 4 + r2.integers(0, 4, B)
                ).astype(np.int16)
                out.append(
                    DeviceBatch(gstart=gstart, patches=pat, **common)
                )
            elif kind == "spliced":
                splice = np.full((B, 4), 0x7FFF, np.int16)
                splice[:, 0] = r2.integers(k, R - k, B).astype(np.int16)
                splice[:, 1] = r2.integers(-6, 7, B).astype(np.int16)
                pat = np.full((B, PATCH_SLOTS), -1, np.int16)
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
            else:
                codes = r2.integers(0, 4, (B, R)).astype(np.uint8)
                nmask = np.zeros((B, R), bool)
                nmask[2, 5] = True
                out.append(
                    DeviceBatch(
                        R=R, packed=pack_run_seqs(codes),
                        nbits=pack_bits(nmask),
                        vbits=pack_bits(np.ones((B, noff), bool)),
                        chunks=chunks,
                    )
                )
        return out

    monkeypatch.setenv("GRAFIMO_HIST_COMPRESS", "force")
    res_mesh = scan_batches(make_batches(), kern, mins, cuts, k, hs)
    # clear the resident-genome device cache (sharding layout differs)
    del shim._genome_dev_cache
    monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")
    monkeypatch.delenv("GRAFIMO_HIST_COMPRESS")
    res_one = scan_batches(make_batches(), kern, mins, cuts, k, hs)
    assert (res_mesh.hists == res_one.hists).all()
    assert sorted(res_mesh.hits) == sorted(res_one.hits)
    assert len(res_mesh.hits) > 0

def test_scan_batches_shardmap_strided_identity(ctcf, monkeypatch):
    """Whole-region backbone slices (uniformly strided rows) route
    through the shard_map-wrapped SPAN kernel on a multi-device host —
    the gap where mesh hosts silently fell back to the per-row gather
    kernel — and stay bit-identical to the
    forced single-device strided path.  A row count that does NOT
    divide the mesh must still scan correctly via the gather
    fallback."""
    from grafimo_tpu.models.pvalue import PvalueLookup
    from grafimo_tpu.ops.score_runs import pack_bits, pwms_to_conv_kernel
    import grafimo_tpu.runscan as runscan
    from grafimo_tpu.runscan import DeviceBatch, RunChunk, scan_batches

    k = ctcf.width
    hs = 1000 * k + 1
    kern = pwms_to_conv_kernel(
        [ctcf.score_matrix, reverse_complement_pwm(ctcf.score_matrix)]
    )
    mins = np.array([ctcf.min_score] * 2, np.int32)
    cut = PvalueLookup(ctcf.pval_table).score_cutoff(1e-2)
    cuts = np.array([cut] * 2, np.int32)
    R = 64
    stride = R - k + 1  # uniformly strided rows: the span-kernel shape
    rng = np.random.default_rng(23)

    class Shim:
        pass

    shim = Shim()
    shim.seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 4096))

    def make_batches():
        r2 = np.random.default_rng(9)
        out = []
        # B=16 divides the 8-device mesh -> strided shard kernel;
        # B=21 does not -> gather fallback under the mesh
        for B, masked in ((16, True), (16, False), (21, False)):
            noff = stride
            gstart = (7 + stride * np.arange(B)).astype(np.int32)
            valid = (
                r2.random((B, noff)) < 0.9
                if masked
                else np.ones((B, noff), bool)
            )
            out.append(
                DeviceBatch(
                    R=R, packed=None, nbits=None, gstart=gstart,
                    vbits=pack_bits(valid),
                    chunks=[
                        RunChunk(("t", (-1, 0)), i * stride)
                        for i in range(B)
                    ],
                    graph=shim,
                )
            )
        return out

    routed = []
    real = runscan._shard_kernels_for

    def spy(mesh):
        kernels = dict(real(mesh))
        orig = kernels["strided"]

        def counted(*a, **kw):
            routed.append(1)
            return orig(*a, **kw)

        kernels["strided"] = counted
        return kernels

    monkeypatch.setattr(runscan, "_shard_kernels_for", spy)
    res_mesh = scan_batches(make_batches(), kern, mins, cuts, k, hs)
    # the two divisible batches hit the span kernel; the 21-row batch
    # must NOT (it cannot shard without pad rows)
    assert len(routed) == 2
    del shim._genome_dev_cache
    monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")
    res_one = scan_batches(make_batches(), kern, mins, cuts, k, hs)
    assert (res_mesh.hists == res_one.hists).all()
    assert sorted(res_mesh.hits) == sorted(res_one.hits)
    assert len(res_mesh.hits) > 0
