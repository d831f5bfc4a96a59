"""The CLI's ``flywheel`` in both packages on the CPU with the same flags:
per generation the same outcome, version, ``rolled_back_to`` and
``parent_version``, the same final stats and alias, and the same
generation rejected at the same ``--max-divergence`` ceiling.  Eval scores
are not compared: the threefry and Philox init streams differ."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGS = ["flywheel", "--generations", "5", "--chaos", "nan,regression,host_kill,crash",
        "--hosts", "2"]
#: the reference rejects generation 3's canary at this ceiling (its
#: prediction divergence 0.1644 > 0.1) and promotes it at 0.2
MAX_DIVERGENCE = "0.1"

#: both packages' CLIs run with the canary's p99 verdict pinned off: it
#: compares wall-clock forward times over a 4-batch window (factor 3, a
#: 1 ms floor), so on a loaded host (the test suite's other workers) a
#: pause of a few ms rejects a healthy generation in either package, and
#: the story would be the host's.  Every other verdict (error rate,
#: divergence, window, the chaos kinds) decides as it does for users.
PIN_P99 = """
import functools
from {pkg}.serving.engine import Engine

_run_canary = Engine.run_canary


@functools.wraps(_run_canary)
def run_canary(self, *args, **kwargs):
    kwargs["p99_factor"] = float("inf")
    return _run_canary(self, *args, **kwargs)


Engine.run_canary = run_canary
"""


def _parse(text):
    lines = [json.loads(l) for l in text.splitlines() if l.startswith("{")]
    gens = [g for g in lines if "gen" in g]
    return {"gens": [{k: g.get(k) for k in ("gen", "outcome", "version", "rolled_back_to",
                                            "parent_version")} for g in gens],
            "reasons": [(g.get("reason") or "").split(":")[0] for g in gens],
            "reason_text": [g.get("reason") for g in gens],
            "final": next(l for l in lines if "stats" in l)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both arms in both packages, one run at a time, the canary's p99
    verdict pinned off in both (``PIN_P99``); the port's runs take one
    torch thread.  The reference's CLI runs as a process of its own on one
    CPU device, as users run it, with single-threaded XLA."""
    import torch

    from deeplearning4j_tpu_torch.cli import main
    from deeplearning4j_tpu_torch.serving.engine import Engine

    ref_main = (PIN_P99.format(pkg="deeplearning4j_tpu")
                + "import sys\nfrom deeplearning4j_tpu.cli import main\nsys.exit(main())\n")

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")
    out = {}
    for arm, more in (("chaos", []), ("divergence", ["--max-divergence", MAX_DIVERGENCE])):
        p = subprocess.run(
            [sys.executable, "-c", ref_main, *ARGS, *more, "--workdir",
             str(tmp_path_factory.mktemp(f"ref_{arm}"))], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, timeout=300)
        out["ref", arm] = {"rc": p.returncode, **_parse(p.stdout)}
        wd = str(tmp_path_factory.mktemp(f"port_{arm}"))
        buf = io.StringIO()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        run_canary = Engine.run_canary
        try:
            exec(PIN_P99.format(pkg="deeplearning4j_tpu_torch"), {})
            with contextlib.redirect_stdout(buf):
                rc = main(ARGS + more + ["--device", "cpu", "--workdir", wd])
        finally:
            Engine.run_canary = run_canary
            torch.set_num_threads(threads)
        out["port", arm] = {"rc": rc, **_parse(buf.getvalue())}
    return out


@pytest.mark.parametrize("arm", ["chaos", "divergence"])
def test_generations_are_the_references(runs, arm):
    ref, port = runs["ref", arm], runs["port", arm]
    assert ref["rc"] == port["rc"] == 0
    assert port["gens"] == ref["gens"]
    assert port["reasons"] == ref["reasons"]


@pytest.mark.parametrize("arm", ["chaos", "divergence"])
def test_final_stats_are_the_references(runs, arm):
    ref, port = runs["ref", arm]["final"], runs["port", arm]["final"]
    assert port["alias"] == ref["alias"]
    for k in ("name", "alias", "generations_done", "promoted", "rolled_back", "resumes",
              "current"):
        assert port["stats"][k] == ref["stats"][k], k
    assert port["traffic_dropped"] >= 0


def test_the_chaos_run_is_the_issue_story(runs):
    gens = runs["port", "chaos"]["gens"]
    why = {pkg: runs[pkg, "chaos"]["reason_text"] for pkg in ("port", "ref")}
    assert [g["outcome"] for g in gens] == ["PROMOTED", "ROLLED_BACK", "PROMOTED",
                                            "ROLLED_BACK", "PROMOTED"], why
    assert gens[3]["rolled_back_to"] == 3 and gens[4]["parent_version"] == 3
    st = runs["port", "chaos"]["final"]
    assert (st["stats"]["promoted"], st["stats"]["rolled_back"], st["stats"]["resumes"],
            st["alias"]) == (3, 2, 1, 5)


def test_the_divergence_ceiling_rejects_generation_three(runs):
    for pkg in ("ref", "port"):
        g3 = runs[pkg, "divergence"]["gens"][2]
        assert g3["outcome"] == "ROLLED_BACK" and g3["rolled_back_to"] == 1
        assert runs[pkg, "divergence"]["reasons"][2] == "canary rejected"


def test_unknown_chaos_kind_is_refused_like_the_reference(capsys):
    from deeplearning4j_tpu.cli import main as jmain
    from deeplearning4j_tpu_torch.cli import main as tmain

    assert tmain(["flywheel", "--chaos", "meteor", "--device", "cpu"]) == 2
    port_err = capsys.readouterr().err
    assert jmain(["flywheel", "--chaos", "meteor"]) == 2
    assert port_err == capsys.readouterr().err
