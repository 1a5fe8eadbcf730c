"""bench.py runs its sections in one process and keeps every section's fate."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402


def test_failing_section_emits_error_record(capsys):
    def broken():
        raise RuntimeError("device lost")

    recs = bench._run_section("aligner", broken)
    assert [r["metric"] for r in recs] == ["aligner_error"]
    assert "device lost" in recs[0]["detail"]["error"]
    assert '"metric": "aligner_error"' in capsys.readouterr().out


def test_section_records_are_returned_in_order():
    def two_lines():
        bench.emit({"metric": "a", "value": 1, "unit": None, "vs_baseline": None})
        bench.emit({"metric": "b", "value": 2, "unit": None, "vs_baseline": None})

    assert [r["metric"] for r in bench._run_section("x", two_lines)] == ["a", "b"]


def test_sections_run_in_process():
    src = Path(bench.__file__).read_text()
    assert "import subprocess" not in src and "--section" not in src
    assert set(bench.SECTIONS) == {"aligner", "sim_batch", "aeons_batch", "scale", "conformance"}
