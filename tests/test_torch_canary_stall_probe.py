"""``scripts/canary_stall_probe.py`` runs only on a card; on the CPU it
refuses, and its arms take turns so that neither runs only first."""

import importlib.util
import pathlib

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "canary_stall_probe", REPO / "scripts" / "canary_stall_probe.py")
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)


def test_arms_run_in_turns():
    assert probe.ORDER == ("pageable", "pinned", "pinned", "pageable")
    assert set(probe.ORDER) == set(probe.ARMS)


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["canary_stall_probe.py"])
    assert probe.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
