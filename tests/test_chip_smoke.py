"""The parts of ``chip_smoke.py`` that need no card: the device check,
the last line's format, the report comparator and the numpy reference
the kernels are held to."""

import json
import pathlib
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
import chip_smoke  # noqa: E402


def test_device_check_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.check_device(jax.devices())
    assert "GPU" in str(exc.value)
    with pytest.raises(SystemExit):
        chip_smoke.check_device([])


def test_result_line_format():
    class Card:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Card()] * 4)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4,
        },
    }


def test_compare_reports_equal(tmp_path):
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "r.tsv").write_bytes(b"\tx\n0\t1\n")
    chip_smoke.compare_reports(str(tmp_path / "a"), str(tmp_path / "b"),
                               ["r.tsv"])


@pytest.mark.parametrize(
    "other, line",
    [(b"\tx\n0\t2\n", 1), (b"\tx\n0\t1\n1\t1\n", 2), (b"\tx\n", 1)],
)
def test_compare_reports_names_first_difference(tmp_path, other, line):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "a" / "r.tsv").write_bytes(b"\tx\n0\t1\n")
    (tmp_path / "b" / "r.tsv").write_bytes(other)
    with pytest.raises(AssertionError, match=f"r.tsv differs .* line {line}"):
        chip_smoke.compare_reports(
            str(tmp_path / "a"), str(tmp_path / "b"), ["r.tsv"]
        )


def test_reference_scan_matches_window_loop():
    """The numpy reference against a plain per-window loop."""
    rng = np.random.default_rng(2)
    b, r, k, m = 5, 40, 7, 3
    codes = rng.integers(0, 4, (b, r)).astype(np.uint8)
    nmask = rng.random((b, r)) < 0.03
    valid = rng.random((b, r - k + 1)) < 0.9
    kernel = rng.integers(0, 1000, (k, 4, m)).astype(np.float32)
    mins = np.array([5, 6, 7], np.int32)
    cuts = np.array([3000, 3500, 4000], np.int32)
    hs = 1000 * k + 1
    hist, hits = chip_smoke.reference_scan(
        codes, nmask, valid, kernel, mins, cuts, k, hs
    )
    want_hist = np.zeros((hs, m), np.int64)
    want_hits = set()
    for i in range(b):
        for o in range(r - k + 1):
            if not valid[i, o]:
                continue
            for c in range(m):
                s = int(sum(kernel[j, codes[i, o + j], c] for j in range(k)))
                if nmask[i, o:o + k].any():
                    s = int(mins[c])
                want_hist[s, c] += 1
                if s >= cuts[c]:
                    want_hits.add((i, o, c))
    np.testing.assert_array_equal(hist, want_hist)
    assert hits == want_hits
