"""``chip_smoke.py``'s instrument for predict_features arm (e), the
canary: ``CanaryWatch`` records every ``ForwardGraph`` call's stages and,
when its watchdog fires, prints them with the host's memory and whether
the event after each call's replay has completed.  It runs on the card;
here a stand-in graph (no CUDA) whose host copy stalls holds what it
prints and that it leaves the engine and the module as it found them."""

import importlib.util
import json
import pathlib
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.serving import cuda_graphs as cg
from deeplearning4j_tpu_torch.serving import engine as em

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke_watch", REPO / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


class _Event:
    def __init__(self, done):
        self.done = done

    def record(self, stream=None):
        pass

    def query(self):
        return self.done

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


class _Replayable:
    def replay(self):
        torch.cuda.CUDAGraph.replay(self)


class _Version:
    tag = "gpt2:v2"


def _graph(done):
    """A ``ForwardGraph`` of bucket 2 without a card: its replay does
    nothing, its output is [2, 7] ones (copied out through its host
    buffer), its end event reports ``done``."""
    g = object.__new__(cg.ForwardGraph)
    g.input, g.output = torch.zeros(2, 5), torch.ones(2, 7)
    g._events, g.stream = (_Event(True), _Event(done)), None
    g.graph, g.replays, g.launches = _Replayable(), 0, {}
    g.host, g.copied = torch.empty(2, 7), _Event(True)
    return g


class _Engine:
    def __init__(self, g):
        self.g = g

    def _run_forward(self, v, idx, xs, rows=None):
        return self.g(xs, rows)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", lambda self: None)
    monkeypatch.setattr(cs, "PF_CANARY_WATCH_S", 0.3)


@pytest.mark.parametrize("done", [True, False], ids=["card_done", "card_busy"])
def test_watchdog_prints_the_stalled_call_and_its_event(no_card, monkeypatch, capsys, done):
    eng = _Engine(_graph(done))
    rows_to_host, host_copy, release = cg.rows_to_host, cg.host_copy, em._ModelVersion.release
    with cs.CanaryWatch(eng) as watch:
        copy = cg.rows_to_host

        def stalled(y, rows, *a):       # the host copy outlasts the watchdog
            out = copy(y, rows, *a)
            time.sleep(1.6)
            return out
        monkeypatch.setattr(cg, "rows_to_host", stalled)
        out, finite = eng._run_forward(_Version(), 1, np.zeros((2, 5), np.float32), 2)
        monkeypatch.setattr(cg, "rows_to_host", copy)
    assert watch.fired and finite and out.shape == (2, 7) and (out == 1).all()
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["at"] for x in lines] == ["start", "0.3 s"]
    assert lines[0]["calls_in_flight"] == []
    for x in lines:
        assert x["arm"] == "e_watchdog" and "MemAvailable_kB" in x["host"]
        assert "VmRSS_kB" in x["host"] and "cuda_mem_get_info" in x
    states = {t["thread"]: t for t in lines[1]["threads"]}
    assert states["MainThread"]["state"] in "RSD" and states["MainThread"]["cpu_ticks"] >= 0
    assert lines[1]["switch_interval_s"] > 0
    assert lines[1]["frames"]["MainThread"][0] == "test_torch_canary_watch.py"
    assert lines[1]["releases"] == []
    (call,) = lines[1]["calls_in_flight"]
    assert call["bucket"] == 2 and call["replica"] == 1 and call["version"] == "gpt2:v2"
    assert call["host_copy_bytes"] == 2 * 7 * 4 and call["host_copy_pinned"]
    assert set(call["stage_age_s"]) == {"input_copy", "replay_enqueued", "finite_read",
                                        "host_copy"}
    assert call["replay_event"] == ("completed" if done else "not completed")
    # every patch is taken back
    assert cg.rows_to_host is rows_to_host and cg.host_copy is host_copy
    assert "_run_forward" not in vars(eng)
    assert em._ModelVersion.release is release


def test_watchdog_stays_quiet_when_the_arm_ends_in_time(no_card, capsys):
    eng = _Engine(_graph(True))
    with cs.CanaryWatch(eng) as watch:
        eng._run_forward(_Version(), 0, np.zeros((2, 5), np.float32), 1)
    time.sleep(0.5)
    assert not watch.fired
    assert [json.loads(x)["at"] for x in capsys.readouterr().out.splitlines()] == ["start"]


def test_a_question_the_card_does_not_answer_reads_blocked():
    assert cs.ask_card(lambda: time.sleep(1.0), timeout=0.05) == "query blocked"
    assert cs.ask_card(lambda: 3) == 3
    assert cs.ask_card(lambda: 1 / 0).startswith("error: ZeroDivisionError")
