"""The serve, launch and train flags of the fleet slice in the port's CLI
against the JAX package's: ``serve --models/--tenants/--fleet/
--compile-cache/--warm-bundle/--trace/--decode-role``, ``launch
--compile-cache`` and ``train --compile-cache``.

Bad flag combinations exit with the reference's texts; ``--compile-cache
DIR`` makes DIR the kernels' build directory and exports
``DL4J_TPU_COMPILE_CACHE`` (idempotent), which ``launch``'s workers
inherit; a ``--decode-role prefill`` host answers /generate with 409
``prefill_role`` and drains on SIGTERM (exit 75).
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu.models.transformer import TransformerLM as JLM
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import Dense as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.utils.serializer import save_model as j_save
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.serving import FleetRouter, warmcache
from deeplearning4j_tpu_torch.utils import cuda_build

REPO = str(Path(__file__).resolve().parents[1])


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("zips")
    out = {}
    for name, seed in (("a", 1), ("b", 2)):
        conf = (JConf.builder().seed(seed)
                .layer(JDense(n_out=8, activation="tanh"))
                .layer(JOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(JInputType.feed_forward(5)).build())
        net = JNet(conf)
        net.init()
        out[name] = str(d / f"{name}.zip")
        j_save(net, out[name])
    out["lm"] = str(d / "lm.zip")
    j_save(JLM(vocab_size=32, n_layers=1, d_model=16, n_heads=2, max_len=32), out["lm"])
    tenants = d / "tenants.json"
    tenants.write_text(json.dumps({"tenants": [{"tenant": "gold", "weight": 2.0},
                                               {"tenant": "free", "quota_qps": 100}]}))
    out["tenants"] = str(tenants)
    (d / "bad.json").write_text("{not json")
    out["bad"] = str(d / "bad.json")
    return out


@pytest.fixture
def fresh_cache(monkeypatch):
    """Undo what enable_compile_cache does to the process."""
    monkeypatch.delenv(warmcache.ENV_VAR, raising=False)
    build_dir = cuda_build.BUILD_DIR
    yield
    warmcache._enabled_dir = None
    cuda_build.BUILD_DIR = build_dir
    os.environ.pop(warmcache.ENV_VAR, None)


def _exit_text(main, argv):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return str(e.value)


def test_fleet_flag_builds_a_router():
    args = cli.build_parser().parse_args(
        ["serve", "--fleet", "127.0.0.1:9001,127.0.0.1:9002", "--max-retries", "2"])
    assert args.fn.__name__ == "cmd_serve" and args.model is None
    assert args.fleet == "127.0.0.1:9001,127.0.0.1:9002" and args.max_retries == 2
    ref = jcli.build_parser().parse_args(
        ["serve", "--fleet", "127.0.0.1:9001,127.0.0.1:9002", "--max-retries", "2"])
    assert ref.fleet == args.fleet


@pytest.mark.parametrize("argv", [
    ["serve"],
    ["serve", "--fleet", "127.0.0.1:1", "--smoke", "2"],
    ["serve", "--fleet", "127.0.0.1:1", "--tenants", "{tenants}"],
    ["serve", "--models", "{a},{a}"],
    ["serve", "--models", "x="],
    ["serve", "--model", "{a}", "--tenants", "{bad}"],
    ["serve", "--model", "{lm}", "--models", "b={b}"],
    ["serve", "--model", "{lm}", "--smoke", "2"],
], ids=["nothing", "fleet_smoke", "fleet_tenants", "dup_models", "empty_model",
        "bad_tenants", "lm_models", "lm_smoke"])
def test_bad_combinations_exit_with_the_references_text(zips, fresh_cache, argv):
    argv = [a.format(**zips) for a in argv]
    want = _exit_text(jcli.main, argv)
    got = _exit_text(cli.main, argv + ["--device", "cpu"])
    assert got == want


def test_models_and_tenants_smoke(zips, capsys, fresh_cache):
    rc = cli.main(["serve", "--models", f"a={zips['a']},b={zips['b']}", "--tenants",
                   zips["tenants"], "--smoke", "6", "--max-batch", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "models placed: {'a': 'a:v1', 'b': 'b:v1'}" in out
    assert "tenants: ['free', 'gold']" in out
    snap = json.loads(out.strip().splitlines()[-1])
    assert snap["counters"]["requests"] == 6 and snap["models"] == {"a": "a:v1", "b": "b:v1"}
    assert set(snap["tenants"]) == {"free", "gold"}


def test_warm_bundle_and_trace_flags(zips, tmp_path, capsys, fresh_cache):
    from deeplearning4j_tpu_torch.serving import Engine, ModelRegistry

    reg = ModelRegistry(device="cpu")
    reg.set_alias("a", "prod", reg.load("a", zips["a"]))
    eng = Engine.from_registry(reg, "a", max_batch=4, device="cpu").load()
    bundle = eng.save_warmup_bundle(str(tmp_path / "a.warm"))
    eng.shutdown()
    trace = str(tmp_path / "serve.trace.json")
    rc = cli.main(["serve", "--model", zips["a"], "--warm-bundle", bundle, "--trace", trace,
                   "--smoke", "3", "--max-batch", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    snap = json.loads([l for l in out.splitlines() if l.startswith("{")][-1])
    assert snap["counters"]["bundle_hits"] == 3 and snap["counters"]["bundle_misses"] == 0
    names = {e["name"] for e in json.loads(Path(trace).read_text())["traceEvents"]}
    assert {"serve/warmup", "serve/request", "serve/batch"} <= names


def test_compile_cache_sets_the_build_dir_and_is_idempotent(tmp_path, monkeypatch,
                                                             fresh_cache):
    assert warmcache.enable_compile_cache() is None          # nothing configured
    monkeypatch.setenv(warmcache.ENV_VAR, str(tmp_path / "env_d"))
    d = warmcache.enable_compile_cache(str(tmp_path / "arg_d"))   # the argument wins
    assert d == str(tmp_path / "arg_d") and os.path.isdir(d)
    assert os.environ[warmcache.ENV_VAR] == d and cuda_build.BUILD_DIR == Path(d)
    assert warmcache.enable_compile_cache(d) == d
    assert cuda_build._target("det_attention").parent == Path(d)
    warmcache._enabled_dir = None
    monkeypatch.setenv(warmcache.ENV_VAR, str(tmp_path / "env_d"))
    assert warmcache.enable_compile_cache() == str(tmp_path / "env_d")


def test_a_subprocess_inherits_the_cache_and_skips_nvcc(tmp_path):
    """A library already in the cache is loaded as is: a fresh process
    pointed at the directory finds every target built and runs no nvcc
    (here a stand-in file; loading it is the card's business)."""
    cache = tmp_path / "cache"
    cache.mkdir()
    code = ("from deeplearning4j_tpu_torch.utils import cuda_build as c\n"
            "import sys\n"
            "names = c.sources()\n"
            "for n in names: c._target(n).write_bytes(b'built')\n"
            "out = c.build(names)\n"
            "print(c.BUILD_DIR, len(out), c.compiled)\n")
    env = dict(os.environ, PYTHONPATH=REPO, DL4J_TPU_COMPILE_CACHE=str(cache),
               PATH="/nonexistent")
    p = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    build_dir, n, compiled = p.stdout.split(maxsplit=2)
    assert build_dir == str(cache) and int(n) == len(cuda_build.sources())
    assert compiled.strip() == "[]"


def test_train_compile_cache_prints_the_directory(tmp_path, capsys, fresh_cache):
    conf = (JConf.builder().seed(1)
            .layer(JDense(n_out=8, activation="tanh"))
            .layer(JOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(4)).build())
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(conf.to_dict()))
    d = str(tmp_path / "cc")
    rc = cli.main(["train", "--config", str(path), "--data", "iris", "--epochs", "1",
                   "--compile-cache", d, "--device", "cpu"])
    assert rc == 0 and f"compile cache: {d}" in capsys.readouterr().out
    assert os.environ[warmcache.ENV_VAR] == d and cuda_build.BUILD_DIR == Path(d)


def test_launch_compile_cache_reaches_the_workers(tmp_path):
    conf = (JConf.builder().seed(1)
            .layer(JDense(n_out=8, activation="tanh"))
            .layer(JOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(4)).build())
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(conf.to_dict()))
    d, run = str(tmp_path / "cc"), tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop(warmcache.ENV_VAR, None)
    p = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "launch", "--nprocs", "2",
         "--run-dir", str(run), "--deadline", "100", "--compile-cache", d, "--",
         "train", "--config", str(path), "--data", "iris", "--epochs", "1",
         "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=150)
    assert p.returncode == 0, (p.stdout + p.stderr)[-3000:]
    assert f"launch: compile cache {d}" in p.stdout
    logs = [f.read_text() for f in (run / "logs").glob("*")]
    assert len([t for t in logs if f"compile cache: {d}" in t]) == 2


def test_launch_env_carries_the_cache(tmp_path, fresh_cache):
    from deeplearning4j_tpu_torch.parallel.launcher import PodLauncher

    d = warmcache.enable_compile_cache(str(tmp_path / "cc"))
    launcher = PodLauncher([sys.executable, "-c", "pass"], num_workers=2,
                           run_dir=str(tmp_path / "run"), serve=True)

    class _H:
        process_id = 1
        incarnation = 0

    assert launcher._env_for(_H())[warmcache.ENV_VAR] == d
    assert len(launcher.serve_endpoints()) == 2


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=30)


def test_prefill_role_host_answers_409_and_drains(zips, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve", "--model", zips["lm"],
         "--decode-role", "prefill", "--port", "0", "--device", "cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    try:
        deadline = time.monotonic() + 120
        port = None
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"listening on http://[\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
            assert time.monotonic() < deadline, "".join(lines)
        assert port is not None, "".join(lines)
        assert any("role=prefill" in l for l in lines)
        base = f"http://127.0.0.1:{port}"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/generate", {"prompt_ids": [1, 2, 3], "max_tokens": 4})
        assert ei.value.code == 409
        assert json.loads(ei.value.read())["error_class"] == "prefill_role"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/predict", {"inputs": [[0.0]]})
        assert ei.value.code == 503
        health = json.loads(urllib.request.urlopen(base + "/healthz", timeout=30).read())
        assert health["ready"] is True
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        lines.append(out)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 75, "".join(lines)
    assert "draining" in "".join(lines)


def test_fleet_router_fronts_two_hosts_over_http(zips):
    from deeplearning4j_tpu_torch.serving import Engine, HttpHost, ModelRegistry
    from deeplearning4j_tpu_torch.ui import UIServer

    servers, engines = [], []
    for name in ("a", "a"):
        reg = ModelRegistry(device="cpu")
        reg.set_alias(name, "prod", reg.load(name, zips[name]))
        eng = Engine.from_registry(reg, name, max_batch=4, slo_ms=10_000, device="cpu").load()
        engines.append(eng)
        servers.append(UIServer(port=0).attach_engine(eng).start())
    router = FleetRouter(start_watchdog=False)
    for i, s in enumerate(servers):
        router.add_host(f"h{i}", engine=HttpHost(f"127.0.0.1:{s.port}", timeout_s=10.0))
    try:
        x = np.random.default_rng(0).normal(size=(2, 5)).astype(np.float32)
        for _ in range(4):
            np.testing.assert_allclose(router.output(x, slo_ms=10_000),
                                       engines[0].output(x), rtol=1e-6)
        hosts = router.metrics_snapshot()["hosts"]
        assert set(hosts) == {"h0", "h1"}
        assert router.metrics.snapshot()["counters"]["delivered"] == 4
    finally:
        router.shutdown()
        for s, e in zip(servers, engines):
            s.stop()
            e.shutdown()
