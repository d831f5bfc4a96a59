"""graftcheck for the port (``deeplearning4j_tpu_torch/analysis``) on the
CPU: the tier-1 gate over the port's package, the reference's verdicts
on the reference's fixtures, the port's purity boundary (CUDA-graph
capture blocks, ``.apply`` of autograd Functions, callables passed into
a capture) on the port and on its own fixtures
(tests/fixtures/torch_analysis/), span parity with the reference both
ways, and the ``check`` subcommand.

The port is analyzed once for the module (``port``, ~11 s); the entry
point tests reuse that result through ``main()`` in-process.
"""

import json
import os
import re
import runpy
import sys

import pytest

from deeplearning4j_tpu import analysis as ref_analysis
from deeplearning4j_tpu.analysis import RULES as REF_RULES
from deeplearning4j_tpu.analysis import run_analysis as ref_run
from deeplearning4j_tpu.analysis.callgraph import CallGraph as RefGraph
from deeplearning4j_tpu.analysis.callgraph import load_package as ref_load
from deeplearning4j_tpu.analysis.contracts import collect_span_emissions as ref_spans
from deeplearning4j_tpu_torch import analysis
from deeplearning4j_tpu_torch.analysis import RULES, run_analysis, update_baseline
from deeplearning4j_tpu_torch.analysis.contracts import (collect_span_emissions,
                                                         parse_taxonomy)
from deeplearning4j_tpu_torch.analysis.determinism import DETERMINISTIC_ROOTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_analysis")
TAXONOMY_FIXTURE = os.path.join(REF_FIXTURES, "taxonomy_fixture.md")
PKG = "deeplearning4j_tpu_torch/"

#: the traced set measured over the port when the boundary was added; a
#: smaller one means a seed or an edge stopped resolving
TRACED_AT_LEAST = 154

#: the five training spans the port first lacked
TRAIN_SPANS = {"train/step", "train/h2d", "train/dispatch", "train/device_sync",
               "train/update"}


@pytest.fixture(scope="module")
def port():
    return run_analysis()


@pytest.fixture(scope="module")
def ref_emitted():
    graph = RefGraph.build(ref_load(REPO, "deeplearning4j_tpu"))
    return {n for _, _, names in ref_spans(graph) for n in names}


def _emitted(graph):
    out = []
    for mod, node, names in collect_span_emissions(graph):
        assert names is not None, f"non-literal span name at {mod.relpath}:{node.lineno}"
        out.extend(names)
    return out


def _key(findings):
    return sorted((f.rule, f.line, f.col, f.symbol, f.severity, f.message) for f in findings)


def _fixtures(folder):
    return sorted(f for f in os.listdir(folder) if f.endswith(".py"))


# -- the gate: the port is clean ---------------------------------------------------


def test_port_has_zero_unsuppressed_findings(port):
    assert port.findings == [], (
        "graftcheck found unsuppressed findings in the port — fix them or "
        "suppress with a justified pragma:\n" + "\n".join(f.format() for f in port.findings))
    assert port.n_files > 100


def test_every_suppression_carries_a_justification(port):
    for f, how in port.suppressed:
        assert how.startswith("pragma@"), how
        assert "(" in how and how.split("(", 1)[1].strip(")").strip(), \
            f"suppression without justification: {how}"
    rules = {f.rule for f, _ in port.suppressed}
    assert {"GC101", "GC102", "GC103", "GC201", "GC403"} <= rules
    assert len(port.suppressed) >= 20


def test_port_baseline_is_empty_and_its_own():
    bp = analysis.default_baseline_path()
    assert bp == os.path.join(REPO, PKG, "analysis", "baseline.json")
    with open(bp) as f:
        assert json.load(f) == {"version": 1, "entries": []}


def test_rule_catalog_is_the_references():
    assert {r.id: (r.name, r.severity) for r in RULES.values()} == \
        {r.id: (r.name, r.severity) for r in REF_RULES.values()}
    assert len(RULES) == 17


# -- the reference's fixtures: the reference's verdicts ------------------------------


@pytest.mark.parametrize("name", _fixtures(REF_FIXTURES))
def test_reference_fixture_findings_are_the_references(name):
    path = os.path.join(REF_FIXTURES, name)
    mine = run_analysis(paths=[path], baseline_path=None, taxonomy_path=None)
    theirs = ref_run(paths=[path], baseline_path=None, taxonomy_path=None)
    assert _key(mine.findings) == _key(theirs.findings)
    assert sorted(mine.graph.traced) == sorted(theirs.graph.traced)
    if name.endswith("_pos.py") and not name.startswith("gc401"):
        assert mine.findings


@pytest.mark.parametrize("name", ["gc401_pos.py", "gc401_neg.py"])
def test_gc401_fixture_against_the_taxonomy_fixture(name):
    path = os.path.join(REF_FIXTURES, name)
    mine = run_analysis(paths=[path], baseline_path=None, taxonomy_path=TAXONOMY_FIXTURE)
    theirs = ref_run(paths=[path], baseline_path=None, taxonomy_path=TAXONOMY_FIXTURE)
    assert _key(mine.findings) == _key(theirs.findings)
    assert len([f for f in mine.findings if f.rule == "GC401"]) == \
        (2 if name == "gc401_pos.py" else 0)


def _normalized(out: str) -> dict:
    data = json.loads(out)
    for f in data["findings"] + data["suppressed"]:
        f["path"] = os.path.basename(f["path"])
    return data


@pytest.mark.parametrize("name", _fixtures(REF_FIXTURES))
def test_check_json_is_the_reference_mains(name, capsys):
    from deeplearning4j_tpu_torch.cli import main as cli_main

    path = os.path.join(REF_FIXTURES, name)
    rc = cli_main(["check", path, "--format", "json"])
    mine = _normalized(capsys.readouterr().out)
    ref_rc = ref_analysis.main([path, "--format", "json"])
    theirs = _normalized(capsys.readouterr().out)
    assert (rc, mine) == (ref_rc, theirs)


# -- the capture boundary ---------------------------------------------------------


TRACED = [
    "nn/multilayer.py::MultiLayerNetwork._loss_and_grads",
    "nn/multilayer.py::MultiLayerNetwork._apply_updates",
    "nn/graph.py::ComputationGraph._loss_and_grads",
    "nn/train_graph.py::TrainStepsGraph._steps",
    "models/transformer.py::build_decode_program.step_multi",
    "serving/cuda_graphs.py::StepMultiGraph.__init__.run",
    "serving/engine.py::_ModelVersion.fwd",
    "ops/attention.py::FlashAttention.forward",
    "ops/attention.py::FlashAttention.backward",
    "ops/attention.py::flash_forward_cuda",
    "ops/losses.py::_SparseXent.forward",
    "nlp/sequencevectors.py::_sg_hs_step",
    "nlp/sequencevectors.py::_cbow_neg_step",
    "nlp/sequencevectors.py::_sg_chunk",
    "nlp/sequencevectors.py::SequenceVectors._sg_step",
    "nlp/sequencevectors.py::SequenceVectors.infer_vector.run",
]

NOT_TRACED = [
    "nn/multilayer.py::MultiLayerNetwork.fit_batch",
    "nn/multilayer.py::MultiLayerNetwork.fit_batches",
    "nn/train_graph.py::TrainStepsGraph.__init__",
    "serving/cuda_graphs.py::ForwardGraph.__init__",
    "serving/cuda_graphs.py::StepMultiGraph.__init__",
    "nlp/sequencevectors.py::_Replays.__call__",
    "nlp/sequencevectors.py::SequenceVectors.fit_sequences.flush_multi",
    "parallel/collectives.py::all_reduce",
    "parallel/collectives.py::_all_gather",
    "parallel/collectives.py::_staged",
]


@pytest.mark.parametrize("gid", TRACED)
def test_captured_code_is_traced(port, gid):
    g = port.graph
    assert PKG + gid in g.functions, f"function not found: {gid}"
    assert PKG + gid in g.traced, f"not classified traced: {gid}"


@pytest.mark.parametrize("gid", NOT_TRACED)
def test_host_code_around_a_capture_is_not_traced(port, gid):
    g = port.graph
    assert PKG + gid in g.functions, f"function not found: {gid}"
    assert PKG + gid not in g.traced


def test_traced_set_is_substantial(port):
    g = port.graph
    assert len(g.traced) >= TRACED_AT_LEAST
    # the four capture blocks of the port, each a seed
    blocks = sorted((b.module.relpath, b.node.lineno) for b in g.captures)
    assert [p for p, _ in blocks] == [PKG + "nlp/sequencevectors.py",
                                      PKG + "nn/train_graph.py",
                                      PKG + "serving/cuda_graphs.py",
                                      PKG + "serving/cuda_graphs.py"]
    # no gid of the reference's package leaks in ("deeplearning4j_tpu" is a
    # prefix of the port's name)
    assert all(gid.startswith(PKG) for gid in g.functions)


@pytest.mark.parametrize("pattern", DETERMINISTIC_ROOTS)
def test_every_deterministic_root_matches_a_port_function(port, pattern):
    assert port.graph.match([pattern]), pattern


# -- the port's own fixtures ---------------------------------------------------


def _marked_lines(path, rule):
    with open(path) as f:
        return sorted(i for i, line in enumerate(f, start=1) if f"# {rule}:" in line)


@pytest.mark.parametrize("rule", ["GC101", "GC102", "GC103"])
def test_capture_fixture_positive_and_negative(rule, capsys):
    stem = rule.lower()
    pos, neg = os.path.join(FIXTURES, f"{stem}_pos.py"), os.path.join(FIXTURES, f"{stem}_neg.py")
    found = run_analysis(paths=[pos], baseline_path=None, taxonomy_path=None)
    lines = sorted(f.line for f in found.findings if f.rule == rule)
    assert lines and lines == _marked_lines(pos, rule)
    assert run_analysis(paths=[neg], baseline_path=None, taxonomy_path=None).findings == []
    # through the entry point: 1 on the positive, 0 on the negative
    assert analysis.main([pos, "--baseline", "none"]) == 1
    assert analysis.main([neg, "--baseline", "none"]) == 0
    capsys.readouterr()


@pytest.mark.parametrize("rule", ["GC101", "GC102", "GC103"])
def test_the_references_seeds_miss_every_capture_positive(rule):
    """Why the port needs its own seeds: the reference's analyzer, seeding
    only from JAX transforms, traces nothing of a capture."""
    pos = os.path.join(FIXTURES, f"{rule.lower()}_pos.py")
    res = ref_run(paths=[pos], baseline_path=None, taxonomy_path=None)
    assert res.graph.traced == {} and res.findings == []


def test_capture_fixture_reaches_every_kind_of_edge():
    """The GC101 positive's findings come from each kind of edge: the
    block's callee, an autograd Function reached by ``.apply``, a function
    passed into a capturing ``__call__`` and a captured lambda."""
    res = run_analysis(paths=[os.path.join(FIXTURES, "gc101_pos.py")],
                       baseline_path=None, taxonomy_path=None)
    symbols = {f.symbol for f in res.findings if f.rule == "GC101"}
    assert symbols == {"Scale.forward", "step", "chunk", "fit"}
    g = res.graph
    assert not any(gid.endswith(("::Captured.__init__", "::Replays.__call__"))
                   for gid in g.traced)
    assert [f.rule for f in res.findings if f.symbol == "Captured.__init__"] == ["GC103"]


# -- span parity with the reference, both ways -----------------------------------


def test_the_port_emits_exactly_the_references_span_names(port, ref_emitted):
    mine = set(_emitted(port.graph))
    assert TRAIN_SPANS <= mine
    assert mine == ref_emitted, (sorted(ref_emitted - mine), sorted(mine - ref_emitted))


def test_every_taxonomy_row_is_emitted_by_the_port(port):
    import fnmatch

    with open(os.path.join(REPO, "docs", "OBSERVABILITY.md")) as f:
        taxonomy = parse_taxonomy(f.read())
    assert taxonomy
    emitted = _emitted(port.graph)
    stale = []
    for doc_name in taxonomy:
        if "*" in doc_name:
            ok = any(fnmatch.fnmatch(e.replace("*", "x"), doc_name) for e in emitted)
        else:
            ok = any(doc_name == e or ("*" in e and fnmatch.fnmatch(doc_name, e))
                     for e in emitted)
        if not ok:
            stale.append(doc_name)
    assert stale == [], f"taxonomy rows the port never emits: {stale}"


# -- suppression machinery (the reference's, in the port's runner) ----------------


def _write(tmp_path, body):
    p = tmp_path / "mod.py"
    p.write_text(body)
    return str(p)


@pytest.mark.parametrize("body, rules, n_suppressed", [
    ("import time\ndef f():\n    # graftcheck: disable=GC201 (wall-anchor: test)\n"
     "    return time.time()\n", [], 1),
    ("import time\ndef f():\n    return time.time()  # graftcheck: disable=GC201\n",
     ["GC002", "GC201"], 0),
    ("def f():\n    pass  # graftcheck: disable=GC999 (no such rule)\n", ["GC001"], 0),
    ("def f():\n    return 1  # graftcheck: disable=GC201 (nothing here)\n", ["GC003"], 0),
], ids=["justified", "unjustified", "unknown-rule", "unused"])
def test_pragma_hygiene(tmp_path, body, rules, n_suppressed):
    res = run_analysis(paths=[_write(tmp_path, body)], baseline_path=None, taxonomy_path=None)
    assert sorted(f.rule for f in res.findings) == rules
    assert len(res.suppressed) == n_suppressed


def test_baseline_update_requires_justification(tmp_path):
    src = _write(tmp_path, "import time\ndef f():\n    return time.time()\n")
    res = run_analysis(paths=[src], baseline_path=None, taxonomy_path=None)
    bp = str(tmp_path / "baseline.json")
    with pytest.raises(ValueError):
        update_baseline(res, bp, "  ")
    assert update_baseline(res, bp, "accepted: fixture") == 1
    assert run_analysis(paths=[src], baseline_path=bp, taxonomy_path=None).findings == []


# -- the surfaces: check, main(), -m --------------------------------------------


def test_cli_check_subcommand_registered():
    from deeplearning4j_tpu_torch.cli import build_parser

    args = build_parser().parse_args(["check", "--format", "json"])
    assert args.cmd == "check" and callable(args.fn)
    assert args.fn.__name__ == "cmd_check"


def test_main_flags_a_positive_fixture_and_refuses_an_unjustified_baseline(capsys):
    pos = os.path.join(REF_FIXTURES, "gc404_pos.py")
    assert analysis.main([pos, "--format", "json"]) == 1
    assert any(f["rule"] == "GC404" for f in json.loads(capsys.readouterr().out)["findings"])
    assert analysis.main([pos, "--baseline-update"]) == 2


@pytest.fixture
def cached_port(port, monkeypatch):
    """``main()`` over the whole port answers from the module's one run."""
    real = analysis.run_analysis

    def run(paths=None, baseline_path="<default>", **kw):
        if paths is None and baseline_path == "<default>" and not kw:
            return port
        return real(paths=paths, baseline_path=baseline_path, **kw)

    monkeypatch.setattr(analysis, "run_analysis", run)
    return port


def test_check_over_the_port_says_zero_findings(cached_port, capsys):
    from deeplearning4j_tpu_torch.cli import main as cli_main

    assert cli_main(["check"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("graftcheck: 0 finding(s)")
    traced = int(re.search(r"(\d+) traced function", last).group(1))
    assert traced >= TRACED_AT_LEAST
    assert cli_main(["check", "--format", "json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert data["ok"] is True and data["summary"]["unsuppressed"] == 0
    assert sorted(data["rules"]) == sorted(RULES)


def test_module_entry_point_runs_the_analyzer(cached_port, capsys, monkeypatch):
    """``python -m deeplearning4j_tpu_torch.analysis``, in-process."""
    monkeypatch.setattr(sys, "argv", ["deeplearning4j_tpu_torch.analysis"])
    with pytest.raises(SystemExit) as done:
        runpy.run_module("deeplearning4j_tpu_torch.analysis", run_name="__main__")
    assert done.value.code == 0
    assert "0 finding(s)" in capsys.readouterr().out
