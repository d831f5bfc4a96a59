"""The port's CLI ``train``, ``evaluate`` and ``summary`` against the JAX
package's on the CPU (``--device cpu``), on the embedded Iris data and on
a seeded ``.npz``.

The port's ``train`` draws its initial weights from torch's generator, so
its trained weights are its own; what is held to the reference is the
rest: the zip it writes loads in the reference with the same outputs
(1e-6), and the reference's ``evaluate`` and ``summary`` print, on that
zip, exactly the text the port's print.
"""

import json

import numpy as np
import pytest

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.updaters import Nesterovs as JNesterovs
from deeplearning4j_tpu.utils.serializer import load_model as j_load
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.utils.serializer import load_model


def _conf(tmp_path, n_in, n_out, seed=1):
    conf = (JBuilder.builder().seed(seed).updater(JNesterovs(lr=0.05, momentum=0.9))
            .layer(jff.Dense(n_out=16, activation="relu"))
            .layer(jff.OutputLayer(n_out=n_out, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(n_in)).build())
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(conf.to_dict()))
    return str(path)


def _npz(tmp_path, n=96, n_in=10, classes=4, seed=3):
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, classes, n)
    xs = rng.normal(size=(n, n_in)).astype(np.float32) + 2.0 * np.eye(classes, n_in)[ys]
    path = tmp_path / "data.npz"
    np.savez(path, x=xs, y=ys)
    return str(path), xs


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, out


@pytest.mark.parametrize("data", ["iris", "npz"])
def test_train_evaluate_summary_match_the_reference(tmp_path, capsys, data):
    if data == "iris":
        from deeplearning4j_tpu_torch.datasets.fetchers import load_iris
        spec, xs = "iris", load_iris()[0]
        conf = _conf(tmp_path, 4, 3)
    else:
        spec, xs = _npz(tmp_path)
        conf = _conf(tmp_path, 10, 4)
    out_zip = str(tmp_path / "m.zip")
    rc, out = _run(cli.main, ["train", "--config", conf, "--data", spec, "--epochs", "3",
                              "--batch-size", "32", "--seed", "7", "--output", out_zip,
                              "--device", "cpu"], capsys)
    assert rc == 0 and f"saved: {out_zip}" in out and "trained 3 epoch(s)" in out
    final = float(out.split("final loss ")[1].split()[0])
    net = load_model(out_zip, device="cpu")
    assert net.iteration == 3 * -(-len(xs) // 32) and net.epoch == 3
    # the loss fell from the freshly initialized network's
    fresh = cli._build_model(cli.build_parser().parse_args(
        ["train", "--config", conf, "--data", spec, "--device", "cpu"]))
    x, y = cli._load_data(spec, num_classes=cli._num_classes_of(fresh))
    from deeplearning4j_tpu_torch.datasets import DataSet
    assert final < fresh.score(DataSet(x, y))
    # the reference loads the port's zip and computes the same outputs
    jnet = j_load(out_zip)
    np.testing.assert_allclose(np.asarray(jnet.output(xs)), net.output(xs).numpy(),
                               rtol=0, atol=1e-6)
    for argv in (["evaluate", "--model", out_zip, "--data", spec],
                 ["summary", "--model", out_zip, "--batch-size", "16"]):
        rc, port_out = _run(cli.main, argv + ["--device", "cpu"], capsys)
        jrc, ref_out = _run(jcli.main, argv, capsys)
        assert rc == jrc == 0 and port_out == ref_out


def test_train_with_the_nan_guard_and_a_zoo_model(tmp_path, capsys):
    spec, _ = _npz(tmp_path)
    rc, out = _run(cli.main, ["train", "--config", _conf(tmp_path, 10, 4), "--data", spec,
                              "--nan-guard", "2", "--device", "cpu"], capsys)
    assert rc == 0 and "nan guard armed (budget 2)" in out
    # the CLI's data are float32 (the reference's rule): token ids as x,
    # one-hot next tokens as y
    ids = np.random.default_rng(4).integers(0, 16, (8, 9))
    np.savez(tmp_path / "lm.npz", x=ids[:, :-1], y=np.eye(16)[ids[:, 1:]])
    rc, out = _run(cli.main, ["train", "--zoo", "transformerlm", "--zoo-args",
                              json.dumps(dict(vocab_size=16, n_layers=1, d_model=16,
                                              n_heads=2, max_len=8)),
                              "--data", str(tmp_path / "lm.npz"), "--batch-size", "4",
                              "--device", "cpu"], capsys)
    assert rc == 0 and "2 iterations" in out
    with pytest.raises(SystemExit, match="unknown zoo model 'lenet9'"):
        cli.main(["train", "--zoo", "lenet9", "--data", spec, "--device", "cpu"])
    # the zoo model that raised (queue 1 item 6) before it was ported builds
    rc, out = _run(cli.main, ["summary", "--zoo", "tinyyolo", "--device", "cpu"], capsys)
    assert rc == 0 and "Yolo2OutputLayer" in out and "queue 1 item 6" not in out


#: the flags this slice ports: (extra train arguments; what both CLIs
#: must agree on)
PORTED = {
    "mesh": (["--mesh", "data=1"], "iterations"),
    "elastic_dir": (["--elastic-dir", "{ck}"], "checkpoints"),
    "checkpoint_every": (["--elastic-dir", "{ck}", "--checkpoint-every", "2"], "checkpoints"),
    "chaos": (["--elastic-dir", "{ck}", "--checkpoint-every", "2", "--chaos",
               "device_loss@4,ckpt_truncate@7,nan_grads@9,seed=1"], "recoveries"),
    "step_timeout": (["--elastic-dir", "{ck}", "--step-timeout", "100"], "recoveries"),
    "grace": (["--elastic-dir", "{ck}", "--grace", "5"], "checkpoints"),
    "trace": (["--trace", "{ck}/t.json"], "trace"),
}


def _elastic_line(out):
    return next((l.split(",")[0] for l in out.splitlines() if l.startswith("elastic:")), None)


@pytest.mark.parametrize("name", list(PORTED))
def test_ported_train_flags_agree_with_the_reference(tmp_path, capsys, name):
    """Each flag this slice ports, on both CLIs over the same data and
    configuration: the same iteration count, the same checkpoint files
    (``--elastic-dir``), the same count of recoveries (``--chaos``: a
    device loss, a truncated checkpoint and a poisoned batch, recovered
    in the port as in the reference), a Chrome trace that passes both
    validators (``--trace``)."""
    import os

    from deeplearning4j_tpu.obs.trace import validate_chrome_trace as jvalidate
    from deeplearning4j_tpu_torch.obs.trace import validate_chrome_trace

    spec, _ = _npz(tmp_path)
    conf = _conf(tmp_path, 10, 4)
    extra, what = PORTED[name]
    outs = {}
    for who, main in (("port", cli.main), ("ref", jcli.main)):
        ck = tmp_path / who
        ck.mkdir()
        argv = (["train", "--config", conf, "--data", spec, "--batch-size", "16",
                 "--epochs", "2"] + [a.replace("{ck}", str(ck)) for a in extra])
        rc, out = _run(main, argv + (["--device", "cpu"] if who == "port" else []), capsys)
        assert rc == 0, (who, out)
        outs[who] = (out, sorted(f for f in os.listdir(ck) if f.startswith("checkpoint_")),
                     ck)
    (port, port_ck, pdir), (ref, ref_ck, rdir) = outs["port"], outs["ref"]
    iters = [l.split(", final")[0] for l in port.splitlines() if l.startswith("trained ")]
    if what == "checkpoints":
        assert port_ck == ref_ck and port_ck
    if what == "recoveries":
        assert _elastic_line(port) == _elastic_line(ref)
        # the port replays from the restored step, so it ends at the plan's
        # 12 steps (the reference retries the failed batch and ends short)
        assert port_ck[-1] == "checkpoint_0000000012.zip"
        assert iters == ["trained 2 epoch(s), 12 iterations"]
        return
    assert iters == [l.split(", final")[0] for l in ref.splitlines()
                     if l.startswith("trained ")]
    if what == "trace":
        for d in (pdir, rdir):
            obj = json.loads((d / "t.json").read_text())
            assert validate_chrome_trace(obj) == [] and jvalidate(obj) == []


@pytest.mark.parametrize("spec", [
    "data=4,data=2", "data=0", "data=x", "=4", "data=-1,model=-1", "data=2,schedule=zigzag",
    "data=2,schedule=1f1b,schedule=gpipe", "dcn=2,compress=gzip", "data=2,compress=threshold",
    "dcn=2,compress=threshold,compress=bitmap", "data=-2", "dcn=2,compress=threshold:1e-3"])
def test_mesh_parse_errors_are_the_references(spec):
    with pytest.raises(SystemExit) as port:
        cli._parse_mesh(spec, n_ranks=8)
    with pytest.raises(SystemExit) as ref:
        jcli._parse_mesh(spec)
    assert str(port.value) == str(ref.value)


def test_mesh_parse_values_are_the_references():
    import jax

    n = jax.device_count()
    for spec in ("data=2,model=2", "dcn=2,data=-1,compress=threshold", "data=2,pipe=2,"
                 "schedule=1f1b", "model=2"):
        assert cli._parse_mesh(spec, n_ranks=n) == jcli._parse_mesh(spec)


@pytest.mark.parametrize("spec", ["", "meteor@3", "device_loss", "device_loss@0",
                                  "device_loss@x", "seed=x,device_loss@2", "color=2,hung_step@1",
                                  "seed=3"])
def test_chaos_parse_errors_are_the_references(spec):
    with pytest.raises(SystemExit) as port:
        cli._parse_chaos(spec)
    with pytest.raises(SystemExit) as ref:
        jcli._parse_chaos(spec)
    assert str(port.value) == str(ref.value)
    with pytest.raises(SystemExit) as port:
        cli._parse_chaos_worker([f"x:{spec}", "1"])
    with pytest.raises(SystemExit) as ref:
        jcli._parse_chaos_worker([f"x:{spec}", "1"])
    assert str(port.value) == str(ref.value)


def test_chaos_needs_an_elastic_dir(tmp_path):
    spec, _ = _npz(tmp_path)
    with pytest.raises(SystemExit, match="--chaos needs --elastic-dir"):
        cli.main(["train", "--config", _conf(tmp_path, 10, 4), "--data", spec, "--chaos",
                  "device_loss@2", "--device", "cpu"])


def test_serve_drains_and_exits_75_on_a_preemption_notice(tmp_path):
    """``serve`` answers until a SIGTERM, then drains and exits 75."""
    import os
    import signal
    import subprocess
    import sys
    import time

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork

    with open(_conf(tmp_path, 10, 4)) as f:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(json.load(f)), device="cpu")
    net.init()
    net.save(str(tmp_path / "m.zip"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.Popen([sys.executable, "-m", "deeplearning4j_tpu_torch", "serve", "--model",
                          str(tmp_path / "m.zip"), "--port", "0", "--device", "cpu"],
                         env=dict(os.environ, PYTHONPATH=repo), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            lines.append(p.stdout.readline())
            if "listening on" in lines[-1]:
                break
        assert "listening on" in lines[-1], "".join(lines)
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 75 and "preemption notice — draining" in out


def test_data_errors_are_clean_cli_errors(tmp_path):
    bad = tmp_path / "bad.npz"
    np.savez(bad, features=np.zeros((2, 2)))
    with pytest.raises(SystemExit, match="must contain arrays 'x' and 'y'"):
        cli._load_data(str(bad))
    with pytest.raises(SystemExit, match="out of range"):
        np.savez(tmp_path / "r.npz", x=np.zeros((2, 3)), y=np.array([0, 5]))
        cli._load_data(str(tmp_path / "r.npz"), num_classes=3)
    with pytest.raises(SystemExit, match="--zoo NAME or --config"):
        cli.main(["train", "--data", "iris", "--device", "cpu"])


def test_train_zoo_lenet_then_evaluate_predict_and_summary(tmp_path, capsys):
    """``train --zoo lenet`` (an MLN CNN through the auto-inserted
    CnnToFeedForward) writes a zip that loads in the reference with the
    same outputs (1e-6), and ``evaluate`` / ``summary`` print exactly the
    reference's text on it."""
    rng = np.random.default_rng(6)
    ys = rng.integers(0, 3, 48)
    xs = (rng.normal(size=(48, 12, 12, 1)) + ys[:, None, None, None]).astype(np.float32)
    data = tmp_path / "img.npz"
    np.savez(data, x=xs, y=ys)
    out_zip = str(tmp_path / "lenet.zip")
    kw = json.dumps(dict(height=12, width=12, channels=1, num_classes=3))
    rc, out = _run(cli.main, ["train", "--zoo", "lenet", "--zoo-args", kw, "--data", str(data),
                              "--batch-size", "16", "--epochs", "2", "--output", out_zip,
                              "--device", "cpu"], capsys)
    assert rc == 0 and "6 iterations" in out
    net, jnet = load_model(out_zip, device="cpu"), j_load(out_zip)
    np.testing.assert_allclose(net.output(xs[:8]).numpy(), np.asarray(jnet.output(xs[:8])),
                               rtol=0, atol=1e-6)
    for argv in (["evaluate", "--model", out_zip, "--data", str(data)],
                 ["summary", "--model", out_zip]):
        rc, port_out = _run(cli.main, argv + ["--device", "cpu"], capsys)
        jrc, ref_out = _run(jcli.main, argv, capsys)
        assert rc == jrc == 0 and port_out == ref_out
    np.savez(tmp_path / "in.npz", x=xs[:4])
    rc, _ = _run(cli.main, ["predict", "--model", out_zip, "--input", str(tmp_path / "in.npz"),
                            "--output", str(tmp_path / "pred.npz"), "--device", "cpu"], capsys)
    assert rc == 0
    np.testing.assert_allclose(np.load(tmp_path / "pred.npz")["predictions"],
                               np.asarray(jnet.output(xs[:4])), rtol=0, atol=1e-6)


def test_summary_zoo_resnet50_and_a_graph_checkpoint(tmp_path, capsys):
    """``summary --zoo resnet50`` prints the model line and memory report
    the reference prints for its ResNet-50 (the same configuration, so the
    same counts); a ComputationGraph zip goes through ``evaluate`` and
    ``predict``."""
    from deeplearning4j_tpu.nn.conf.memory import memory_report as jmemory_report
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration as JConf
    from deeplearning4j_tpu_torch.models import ResNet50

    rc, out = _run(cli.main, ["summary", "--zoo", "resnet50", "--device", "cpu"], capsys)
    assert rc == 0
    port = ResNet50(device="cpu")
    jnet = JGraph(JConf.from_dict(port.conf.to_dict()))
    jnet.params = {k: {n: np.zeros(v.shape, np.float32) for n, v in p.items()}
                   for k, p in port.params.items()}
    want = (f"model: ComputationGraph, {jnet.num_params():,} params\n"
            f"{jmemory_report(jnet, minibatch=32)}\n")
    assert out == want
    with pytest.raises(SystemExit, match="--model ZIP or --zoo NAME"):
        cli.main(["summary", "--device", "cpu"])
    # a small conv graph's checkpoint: evaluate prints the reference's text
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphBuilder
    from deeplearning4j_tpu_torch.nn.layers import (BatchNormalization, Convolution2D,
                                                    GlobalPooling, OutputLayer)
    g = ComputationGraph(
        GraphBuilder().add_inputs("in").set_input_types(**{"in": InputType.convolutional(8, 8, 1)})
        .add_layer("c", Convolution2D(n_out=4, kernel=(3, 3), stride=(2, 2),
                                      convolution_mode="same"), "in")
        .add_layer("bn", BatchNormalization(activation="relu"), "c")
        .add_layer("gap", GlobalPooling(pooling="avg"), "bn")
        .add_layer("out", OutputLayer(n_out=3, activation="softmax"), "gap")
        .set_outputs("out").build(), device="cpu")
    g.init()
    path = str(tmp_path / "g.zip")
    g.save(path)
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(6, 8, 8, 1)).astype(np.float32)
    np.savez(tmp_path / "g.npz", x=xs, y=rng.integers(0, 3, 6))
    argv = ["evaluate", "--model", path, "--data", str(tmp_path / "g.npz")]
    rc, port_out = _run(cli.main, argv + ["--device", "cpu"], capsys)
    jrc, ref_out = _run(jcli.main, argv, capsys)
    assert rc == jrc == 0 and port_out == ref_out
    rc, _ = _run(cli.main, ["predict", "--model", path, "--input", str(tmp_path / "g.npz"),
                            "--output", str(tmp_path / "gp.npz"), "--device", "cpu"], capsys)
    assert rc == 0
    np.testing.assert_allclose(np.load(tmp_path / "gp.npz")["predictions"],
                               g.output(xs)[0].numpy(), rtol=0, atol=1e-6)
