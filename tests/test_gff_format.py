"""GFF3 writer format parity: exact line layout of the reference's
``writeGFF3`` (``res_writer.py:213-305``)."""

import numpy as np

from grafimo_tpu.report.results import ResultTable
from grafimo_tpu.report.writer import write_gff3


def _df():
    return ResultTable(
        {
            "motif_id": ["MA0139.1", "MA0139.1"],
            "motif_alt_id": ["CTCF", "CTCF"],
            "sequence_name": ["22:100-400", "22:100-400"],
            "start": [120, 230],
            "stop": [139, 211],
            "strand": ["+", "-"],
            "score": [12.3456, -3.21],
            "p-value": [1.5e-6, 2.5e-4],
            "q-value": [3.2e-3, 0.54],
            "matched_sequence": ["ACGTACGTACGTACGTACG", "TTTTACGTACGTACGTACG"],
            "haplotype_frequency": [5096, 2],
            "reference": ["ref", "non.ref"],
        }
    )


def test_gff3_exact_lines(tmp_path):
    prefix = str(tmp_path / "grafimo_out")
    write_gff3(prefix, _df(), no_qvalue=False)
    lines = (tmp_path / "grafimo_out.gff").read_text().split("\n")
    assert lines[0] == "##gff-version 3"
    # forward row: start/stop as-is; reference attribute layout
    # (att4 is "pvalue==<v>" and att5 "sequence==<s>=;" — the reference
    # joins with "=" including the extra separators, res_writer.py:288-289)
    expected_attrs = (
        "Name=MA0139.1_22:100-400+:ref;Alias=CTCF;"
        "ID=MA0139.1=-=CTCF=-=22:100-400;"
        f"pvalue==1.5e-06;qvalue=3.2e-03;"
        "sequence==ACGTACGTACGTACGTACG=;"
    )
    assert lines[1] == "\t".join(
        ["22", "grafimo", "nucleotide_motif", "120", "139", "12.3",
         "+", ".", expected_attrs]
    )
    # reverse row keeps forward-strand coordinates (start/stop swapped)
    fields = lines[2].split("\t")
    assert fields[3] == "211" and fields[4] == "230" and fields[6] == "-"


def test_gff3_no_qvalue(tmp_path):
    prefix = str(tmp_path / "noq")
    df = ResultTable(
        {n: c for n, c in _df().columns.items() if n != "q-value"}
    )
    write_gff3(prefix, df, no_qvalue=True)
    text = (tmp_path / "noq.gff").read_text()
    assert "qvalue" not in text
    assert "pvalue==1.5e-06" in text


def test_gff3_scientific_format_matches_numpy(tmp_path):
    # the reference uses np.format_float_scientific(..., exp_digits=2)
    assert np.format_float_scientific(1.5e-6, exp_digits=2) == "1.5e-06"
    assert np.format_float_scientific(0.54, exp_digits=2) == "5.4e-01"
