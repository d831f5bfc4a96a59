"""The port's announced-preemption path (``deeplearning4j_tpu_torch/parallel/
preemption.py``) on the CPU: a notice signal only sets a flag; the
emergency checkpoint is deflated when the grace left affords it and
stored (ZIP_STORED) when it does not (a fake clock); ``PreemptedError``
carries exit code 75 and is not recoverable; the reference's
``Membership`` reads the port's leaving marker; and an ``ElasticTrainer``
with a handler leaves at the next step boundary with an emergency
checkpoint a resumed run continues from bitwise.  The serve command's
drain on a notice runs in tests/test_torch_cli_train.py.
"""

import os
import signal
import zipfile

import numpy as np
import pytest

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.parallel import (PREEMPTED_EXIT_CODE, CheckpointManager,
                                               ElasticTrainer, FailureDetector, Membership,
                                               PreemptedError, PreemptionHandler)
from deeplearning4j_tpu_torch.parallel.elastic import _HostSnapshot


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _net(seed=3):
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(lr=0.05))
            .layer(Dense(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    return net


def _batches(k=3):
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(96, 4)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 96)]
    return [DataSet(xs[i::k], ys[i::k]) for i in range(k)]


class Plain:
    def __init__(self, net):
        self.net = net

    def fit_batch(self, ds):
        return self.net.fit_batch(ds)


def test_the_signal_only_sets_a_flag(tmp_path):
    h = PreemptionHandler(grace_s=5.0, signals=(signal.SIGUSR1,),
                          membership=Membership(str(tmp_path)), process_id=1).install()
    try:
        assert not h.requested
        os.kill(os.getpid(), signal.SIGUSR1)
        assert h.requested and h.notice_count == 1
        assert not any(p.name.startswith("checkpoint_") for p in tmp_path.iterdir())
        os.kill(os.getpid(), signal.SIGUSR1)              # repeats only count
        assert h.notice_count == 2
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGUSR1) is not h._on_signal


@pytest.mark.parametrize("elapsed,last_save,stored", [
    (1.0, 2.0, False),      # 9 s left >= max(3 x 2, 1): deflate
    (5.0, 2.0, True),       # 5 s left < 6: stored
    (9.5, None, True),      # 0.5 s left < the 1 s floor: stored
    (0.0, None, False),     # no measurement, 10 s left: deflate
])
def test_emergency_codec_follows_the_grace_left(tmp_path, elapsed, last_save, stored):
    clock = FakeClock()
    h = PreemptionHandler(grace_s=10.0, clock=clock)
    h.notice(signal.SIGTERM)
    clock.t += elapsed
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.last_save_seconds = last_save
    net = _net()
    path, used_stored, seconds = h.emergency_checkpoint(ckpt, net, 7)
    assert used_stored is stored and os.path.basename(path) == "checkpoint_0000000007.zip"
    with zipfile.ZipFile(path) as zf:
        want = zipfile.ZIP_STORED if stored else zipfile.ZIP_DEFLATED
        assert {i.compress_type for i in zf.infolist()} == {want}


def test_preempted_error_is_a_planned_leave():
    e = PreemptedError(3, None)
    assert e.exit_code == PREEMPTED_EXIT_CODE == 75 and e.recoverable is False
    assert not FailureDetector().is_recoverable(e)


def test_the_reference_reads_the_port_leaving_marker(tmp_path):
    from deeplearning4j_tpu.parallel.launcher import Membership as JMembership

    m = Membership(str(tmp_path))
    m.beat(0)
    m.beat(1)
    h = PreemptionHandler(grace_s=12.0, membership=m, process_id=1)
    h.notice(signal.SIGTERM)
    j = JMembership(str(tmp_path))
    assert sorted(j.leaving()) == [1] and j.leaving()[1]["grace_s"] == 12.0
    assert j.alive() == [0]


def test_notice_leaves_at_the_boundary_and_resume_is_bitwise(tmp_path):
    plain = _net()
    want = [float(plain.fit_batch(b)) for b in _batches() * 3]
    h = PreemptionHandler(grace_s=30.0)
    net = _net()
    et = ElasticTrainer(Plain(net), str(tmp_path), checkpoint_every=4, preemption=h)
    for b in _batches() * 2:
        et.fit_batch(b)                                   # 6 steps, checkpoint @4
        if et.global_step == 5:
            h.notice(signal.SIGTERM)                      # mid-run notice
            break
    with pytest.raises(PreemptedError) as info:
        et.fit(_batches(), epochs=3, skip_done=True)
    assert info.value.step == 5 and info.value.checkpoint_path.endswith("0000000005.zip")
    resumed = ElasticTrainer(Plain(_net(seed=9)), str(tmp_path), checkpoint_every=4)
    assert resumed.resume() == 5
    got = resumed.fit(_batches(), epochs=3, skip_done=True)
    assert [float(l) for l in got] == want[5:]


def test_snapshot_of_a_net_keeps_bfloat16_bits():
    import torch

    net = _net()
    net.params[0]["W"] = net.params[0]["W"].to(torch.bfloat16)
    snap = _HostSnapshot(net)
    assert snap.params[0]["W"].dtype == torch.bfloat16
    assert torch.equal(snap.params[0]["W"], net.params[0]["W"])
    assert snap.params[0]["W"].data_ptr() != net.params[0]["W"].data_ptr()
