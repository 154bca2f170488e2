"""Contract of bench.py's parent process (no device needed).

The result is the LAST parseable line of stdout: every emit() must be a
complete, parseable line; phase results/failures must degrade the
extras, never the parseability; the headline `value` is the per-chunk
convention; a failed phase makes the run exit non-zero; and the peak
table knows the H100 and refuses any other device.

bench.py imports only stdlib at module level, so these tests are safe
on any platform (no jax, no device).
"""
import importlib.util
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["bench"] = mod
    spec.loader.exec_module(mod)
    return mod


def test_headline_value_is_per_chunk_bunny_rate(bench):
    bunny = {"steps_per_sec": 1470.0, "steps_per_sec_steady_probe": 5100.0,
             "max_rel_err": 2.1e-5}
    d = json.loads(bench.assemble_line(bunny, {"train_steps_per_sec": 43.5}))
    assert d["metric"] == "bunny_multigrid_train_steps_per_sec"
    assert d["unit"] == "steps/s"
    # Continuity: value is the per-chunk number, NOT the chained probe.
    assert d["value"] == 1470.0
    assert d["vs_baseline"] == round(1470.0 / (2000.0 / 85.0), 2)
    # The probe is present but clearly labeled as a separate convention.
    assert (d["extra"]["bunny_steps_per_sec_steady_chained_probe"]
            == 5100.0)
    assert "convention" in d["extra"]


def test_missing_phases_degrade_to_labeled_errors(bench):
    d = json.loads(bench.assemble_line(None, None))
    assert d["value"] == 0.0
    assert "error" in d["extra"]
    assert d["extra"]["cloud_300k"] == {"error": "no result"}
    # Still a fully parseable driver line even with zero evidence.
    assert d["metric"] == "bunny_multigrid_train_steps_per_sec"


def test_xl_phase_is_optional_extra(bench):
    bunny = {"steps_per_sec": 1500.0}
    xl = {"n": 1_000_000, "train_steps_per_sec": 9.7, "step_mfu": 0.2}
    with_xl = json.loads(bench.assemble_line(bunny, None, xl=xl))
    without = json.loads(bench.assemble_line(bunny, None, xl=None))
    skipped = json.loads(
        bench.assemble_line(bunny, None, xl={"skipped": "no .cache_1m"}))
    assert with_xl["extra"]["cloud_1m_training"]["step_mfu"] == 0.2
    assert "cloud_1m_training" not in without["extra"]
    assert skipped["extra"]["cloud_1m_training"] == {
        "skipped": "no .cache_1m"}
    # The optional phase never changes the headline.
    assert with_xl["value"] == without["value"] == 1500.0


def test_emit_prints_one_parseable_line_per_call(bench, tmp_path, capsys,
                                                 monkeypatch):
    """emit() reads whatever phase files exist and always prints a full
    JSON line — the provisional-then-overwrite pattern the driver's
    last-parseable-line parser relies on."""
    monkeypatch.setattr(bench, "OUT_DIR", str(tmp_path))
    bench.emit(note="provisional: before optional 1M phase")
    bench.write_json(str(tmp_path / "bunny.json"),
                     {"steps_per_sec": 1400.0})
    bench.write_json(str(tmp_path / "xl.json"), {"train_steps_per_sec": 9.0})
    bench.emit()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    parsed = [json.loads(ln) for ln in lines]  # every line parseable
    assert len(parsed) == 2
    assert parsed[0]["value"] == 0.0
    assert parsed[0]["extra"]["note"].startswith("provisional")
    # Last parseable line wins: enriched result replaces the provisional.
    assert parsed[-1]["value"] == 1400.0
    assert parsed[-1]["extra"]["cloud_1m_training"][
        "train_steps_per_sec"] == 9.0


def test_write_json_is_atomic_and_readable_back(bench, tmp_path):
    p = str(tmp_path / "phase.json")
    bench.write_json(p, {"a": 1})
    assert bench.read_json(p) == {"a": 1}
    assert bench.read_json(str(tmp_path / "missing.json")) is None


class _FakeDevice:
    def __init__(self, kind):
        self.device_kind = kind


def test_peak_table_knows_h100(bench):
    peaks = bench.peaks_for(_FakeDevice("NVIDIA H100 80GB HBM3"))
    assert peaks["bf16_flops"] == 989e12
    assert peaks["tf32_flops"] == 495e12
    assert peaks["f32_flops"] == 67e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB",
                                  "cpu", ""])
def test_peak_table_refuses_unknown_device(bench, kind):
    with pytest.raises(KeyError, match="device_kind"):
        bench.peaks_for(_FakeDevice(kind))


def test_failed_phase_fails_the_run(bench, tmp_path, capsys, monkeypatch):
    """One failed phase: every phase still runs once, the result line is
    still printed, and run_all() reports failure (main exits 1)."""
    monkeypatch.setattr(bench, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(bench, "card_line", lambda: "fake card, 700.00 W")
    ran = []

    def fake_run_phase(name, budget_s, deadline):
        ran.append(name)
        return name != "large"

    monkeypatch.setattr(bench, "run_phase", fake_run_phase)
    assert bench.run_all() is False
    assert ran == ["bunny", "large", "xl"]
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert "large" in last["extra"]["note"]

    monkeypatch.setattr(bench, "run_phase", lambda *a: True)
    assert bench.run_all() is True
    monkeypatch.setattr(bench.sys, "argv", ["bench.py"])
    monkeypatch.setattr(bench, "run_phase", lambda *a: False)
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code == 1
