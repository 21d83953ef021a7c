"""Error/interrupt discipline (reference ``grafimo.py:29``,
``utils.py:54-80``, ``motif_ops.py:304-338``):

* EVERY uncaught exception prints one red line and exits 1 unless
  ``--debug`` (the reference installs a global ``sys.excepthook``);
* SIGINT prints a notice and exits 2;
* the motif fork pool restores the SIGINT handler and never orphans
  children;
* scan checkpoints are written atomically (write-then-rename).
"""

import os
import signal

import numpy as np
import pytest

import grafimo_tpu.workflows as workflows
from grafimo_tpu.cli import main


def _find_args(input_dir, tmp_path, graph_dir):
    bed = tmp_path / "regions.bed"
    bed.write_text("chr1\t0\t20\n")
    return [
        "findmotif",
        "-d", str(graph_dir),
        "-b", str(bed),
        "-m", str(input_dir / "MA0139.1.jaspar"),
    ]


def test_unexpected_exception_prints_one_red_line(monkeypatch, capsys):
    def boom(workflow):
        raise RuntimeError("numpy blew up somewhere deep")

    monkeypatch.setattr(workflows, "findmotif", boom)
    monkeypatch.setattr(workflows, "buildvg", boom)
    rc = main(["findmotif", "-g", "g.gvt.npz", "-b", "b.bed", "-m", "m.meme"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "ERROR: numpy blew up somewhere deep" in err
    assert "\033[31m" in err  # red, single line — no raw traceback
    assert "Traceback" not in err


def test_unexpected_exception_debug_reraises(monkeypatch):
    def boom(workflow):
        raise RuntimeError("boom")

    monkeypatch.setattr(workflows, "findmotif", boom)
    with pytest.raises(RuntimeError, match="boom"):
        main([
            "findmotif", "-g", "g", "-b", "b", "-m", "m", "--debug",
        ])


def test_sigint_exits_2(monkeypatch, capsys):
    def interrupted(workflow):
        raise KeyboardInterrupt

    monkeypatch.setattr(workflows, "findmotif", interrupted)
    rc = main(["findmotif", "-g", "g", "-b", "b", "-m", "m"])
    assert rc == 2
    assert "Caught SIGINT" in capsys.readouterr().err


def test_xg_artifact_gets_conversion_command(input_dir, tmp_path, capsys):
    """Pointing -d at vg's own .xg index fails with the exact one-time
    conversion command instead of a bare 'unable to locate' (the
    reference consumed .xg through the vg binary,
    extract_regions.py:180)."""
    graph_dir = tmp_path / "graphs"
    graph_dir.mkdir()
    (graph_dir / "1.xg").write_bytes(b"\x00vgxg")
    rc = main(_find_args(input_dir, tmp_path, graph_dir))
    assert rc == 1
    err = capsys.readouterr().err
    assert "vg view -g" in err and "1.xg" in err and ".gfa" in err


def test_xg_direct_graph_argument(input_dir, tmp_path, capsys):
    xg = tmp_path / "chrx.xg"
    xg.write_bytes(b"\x00vgxg")
    bed = tmp_path / "regions.bed"
    bed.write_text("chrx\t0\t20\n")
    rc = main([
        "findmotif", "-g", str(xg), "-b", str(bed),
        "-m", str(input_dir / "MA0139.1.jaspar"),
    ])
    assert rc == 1
    assert "vg view -g" in capsys.readouterr().err


def test_save_batches_atomic(tmp_path, monkeypatch):
    """A failed/interrupted checkpoint write never clobbers the previous
    checkpoint and leaves no temp file behind."""
    from grafimo_tpu.runscan import DeviceBatch, RunChunk, save_batches

    batch = DeviceBatch(
        R=8,
        packed=np.zeros((2, 2), np.uint8),
        nbits=np.zeros((2, 1), np.uint8),
        vbits=np.zeros((2, 1), np.uint8),
        chunks=[RunChunk(("r:0-8", (0, 8)), 0)],
    )
    path = tmp_path / "scan_abc.npz"
    save_batches(str(path), [batch], ["r:0-8"])
    good = path.read_bytes()

    def failing_savez(fh, **arrays):
        fh.write(b"partial garbage")
        raise KeyboardInterrupt

    monkeypatch.setattr(np, "savez_compressed", failing_savez)
    with pytest.raises(KeyboardInterrupt):
        save_batches(str(path), [batch], ["r:0-8"])
    assert path.read_bytes() == good  # old checkpoint intact
    assert list(tmp_path.glob("*.tmp")) == []  # no debris


def test_motif_pool_restores_sigint_handler(monkeypatch):
    """The fork pool runs with SIGINT ignored in the children (reference
    motif_ops.py:304-308) and restores the parent handler."""
    import grafimo_tpu.models.parse as parse

    monkeypatch.setattr(parse, "process_motif", lambda m: m)
    before = signal.getsignal(signal.SIGINT)
    out = parse.process_motifs(list(range(64)))
    assert out == list(range(64))
    assert signal.getsignal(signal.SIGINT) is before


@pytest.mark.parametrize("env_set", [True, False])
def test_persistent_compile_cache_env_gate(monkeypatch, tmp_path, env_set):
    """The compile cache follows ``JAX_COMPILATION_CACHE_DIR`` when it is
    set (JAX reads it; no other directory is set in code) and otherwise
    lives at the fixed ``<checkout>/.jax_cache``."""
    import jax

    import grafimo_tpu.utils.compile_cache as cc

    updates = []
    monkeypatch.setattr(
        jax.config, "update", lambda *a: updates.append(a)
    )
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cc.enable_compile_cache() == str(tmp_path)
        assert updates == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ".jax_cache",
        )
        assert cc.enable_compile_cache() == want
        assert updates == [("jax_compilation_cache_dir", want)]
