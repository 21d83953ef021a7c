"""Report writer naming/layout conventions (reference
``res_writer.py:108-151``) and sniffer negative cases."""

import os

import pytest

from grafimo_tpu.report.results import ResultTable
from grafimo_tpu.report.writer import write_results
from grafimo_tpu.utils.constants import DEFAULT_OUTDIR
from grafimo_tpu.utils.sniff import (
    is_jaspar,
    is_meme,
    is_pfm,
    is_transfac,
    sniff_motif_format,
)


def _df():
    return ResultTable(
        {
            "motif_id": ["M1"], "motif_alt_id": ["M1"],
            "sequence_name": ["1:0-50"], "start": [10], "stop": [29],
            "strand": ["+"], "score": [5.0], "p-value": [1e-5],
            "q-value": [1e-3], "matched_sequence": ["A" * 19],
            "haplotype_frequency": [3], "reference": ["ref"],
        }
    )


def test_default_outdir_gets_pid_and_motif(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = write_results(_df(), "M1", 1, DEFAULT_OUTDIR)
    assert out == f"grafimo_out_{os.getpid()}_M1"
    assert os.path.isfile(os.path.join(out, "grafimo_out.tsv"))
    assert os.path.isfile(os.path.join(out, "grafimo_out.html"))
    assert os.path.isfile(os.path.join(out, "grafimo_out.gff"))


def test_multi_motif_files_prefixed(tmp_path):
    out = write_results(_df(), "M1", 3, str(tmp_path / "o"))
    assert os.path.isfile(os.path.join(out, "grafimo_out_M1.tsv"))


def test_empty_results_rejected(tmp_path):
    with pytest.raises(ValueError):
        write_results(_df().take([]), "M1", 1, str(tmp_path / "e"))


def test_sniffer_negatives(tmp_path):
    notjaspar = tmp_path / "x.jaspar"
    notjaspar.write_text("not a motif at all\n")
    assert not is_jaspar(str(notjaspar))
    plain = tmp_path / "x.txt"
    plain.write_text("MEME-like but not really\n")
    assert not is_meme(str(plain))
    assert not is_transfac(str(plain))
    # numeric-only lines still count as PFM candidates
    pfmish = tmp_path / "y.txt"
    pfmish.write_text("1 2 3\n4 5 6\n")
    assert is_pfm(str(pfmish))
    meme = tmp_path / "z.txt"
    meme.write_text("MEME version 4\n")
    assert is_meme(str(meme))
    assert sniff_motif_format(str(meme)) == "meme"
    with pytest.raises(ValueError):
        sniff_motif_format(str(notjaspar))


def test_empty_motif_file_raises(tmp_path):
    empty = tmp_path / "empty.meme"
    empty.write_text("")
    with pytest.raises(EOFError):
        is_meme(str(empty))
