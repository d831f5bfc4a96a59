"""Replica autoscaling: ``deeplearning4j_tpu_torch/serving/autoscale.py``
held against the reference's ``ReplicaAutoscaler`` (the same scripted
clock and load signals give the same decisions), and the predict
engine's actuation: a burst births a replica whose programs are prepared
before it is routable, idle retires it, nothing strands, no request is
served unwarmed.
"""

import time

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.serving import ReplicaAutoscaler as JAutoscaler
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import Engine, ReplicaAutoscaler
from deeplearning4j_tpu_torch.utils.params import params_from_numpy


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


KNOBS = [dict(), dict(min_replicas=1, max_replicas=3, up_load=4.0, down_load=0.5,
                      up_ticks=1, down_ticks=2, cooldown_s=0.0),
         dict(min_replicas=2, max_replicas=6, up_load=2.0, down_load=1.0, up_ticks=3,
              down_ticks=3, cooldown_s=1.5)]


@pytest.mark.parametrize("knobs", KNOBS)
def test_scripted_decisions_are_the_references(knobs):
    jc, tc = _Clock(), _Clock()
    ja, ta = JAutoscaler(clock=jc, **knobs), ReplicaAutoscaler(clock=tc, **knobs)
    rng = np.random.default_rng(len(knobs))
    replicas = max(1, knobs.get("min_replicas", 1))
    for step in range(400):
        q, inflight = int(rng.integers(0, 20)), int(rng.integers(0, 4))
        if rng.random() < 0.4:
            q = 0
        shed = int(rng.random() < 0.05)
        dt = float(rng.uniform(0, 0.8))
        jc.t += dt
        tc.t += dt
        want = ja.observe(q, inflight, replicas, shed_delta=shed)
        got = ta.observe(q, inflight, replicas, shed_delta=shed)
        assert got == want, step
        assert ta.load(q, inflight, replicas) == ja.load(q, inflight, replicas)
        replicas += got
        if step == 250:
            ja.reset()
            ta.reset()


def test_knob_validation_is_the_references():
    for kw in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
               dict(up_load=1.0, down_load=1.5)):
        with pytest.raises(ValueError) as j:
            JAutoscaler(**kw)
        with pytest.raises(ValueError) as t:
            ReplicaAutoscaler(**kw)
        assert str(t.value) == str(j.value)


def test_hysteresis_cooldown_and_bounds():
    c = _Clock()
    a = ReplicaAutoscaler(min_replicas=1, max_replicas=2, up_ticks=2, down_ticks=3,
                          cooldown_s=5.0, clock=c)
    assert a.observe(10, 2, 1) == 0 and a.observe(10, 2, 1) == 1
    assert a.observe(10, 2, 2) == 0           # cooldown, and at the maximum
    c.t += 10
    assert [a.observe(0, 0, 2) for _ in range(3)] == [0, 0, -1]
    c.t += 10
    assert a.observe(0, 0, 1, shed_delta=3) == 0 and a.observe(0, 0, 1, shed_delta=1) == 1


def _mlp():
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.updaters import Sgd
    conf = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(lr=0.05))
            .layer(Dense(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(12)).build())
    jnet = JNet(conf)
    jnet.init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf.to_dict()), device="cpu")
    net.params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jnet.params),
                                   device="cpu")
    net.state = params_from_numpy(jax.tree_util.tree_map(np.asarray, jnet.state),
                                  device="cpu")
    return net


def test_engine_burst_scales_up_idle_scales_down_nothing_unwarmed():
    net = _mlp()
    eng = Engine(net, max_batch=4, replicas=1, slo_ms=60_000, max_queue=100_000,
                 admission="block", max_wait_ms=0.5, device="cpu").load()
    born = []
    real = eng._rewarm_replica

    def watch(idx):
        # a born replica's programs are prepared before it is routable
        routable = idx < len(eng._replicas)
        real(idx)
        born.append((idx, routable, eng._current.cache_size()))
    eng._rewarm_replica = watch
    try:
        per_replica = eng.compile_cache_size()
        assert per_replica == len(eng.batcher.buckets)
        eng.enable_autoscale(min_replicas=1, max_replicas=2, up_load=8.0, down_load=0.5,
                             up_ticks=2, down_ticks=4, cooldown_s=0.3, interval_s=0.03)
        rng = np.random.default_rng(0)
        futs = []
        deadline = time.monotonic() + 30.0
        while eng.metrics.counter_value("scale_ups") < 1 and time.monotonic() < deadline:
            # a queue held between 8 and a few hundred: high load, bounded
            if eng.batcher.qsize() < 300:
                futs += [eng.output_async(rng.normal(size=(1, 12)).astype(np.float32),
                                          slo_ms=600_000) for _ in range(100)]
            else:
                time.sleep(0.005)
        outs = [f.result(timeout=120) for f in futs]
        assert eng.metrics.counter_value("scale_ups") >= 1
        assert born and born[0][0] == 1 and born[0][1] is False
        assert born[0][2] == 2 * per_replica
        assert len(eng._replicas) == 2
        assert eng.compile_cache_size() == 2 * per_replica
        deadline = time.monotonic() + 30.0
        while eng.metrics.counter_value("scale_downs") < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert eng.metrics.counter_value("scale_downs") >= 1
        assert len(eng._replicas) == 1
        assert eng.compile_cache_size() == per_replica
        assert all(f.done() for f in futs)
        assert eng.metrics_snapshot()["counters"]["unwarmed_serves"] == 0
        # a served row is the eager forward's
        x = rng.normal(size=(1, 12)).astype(np.float32)
        np.testing.assert_allclose(eng.output(x), net.output(x).numpy(), rtol=0, atol=1e-6)
        assert len(outs) == len(futs)
    finally:
        eng.shutdown()


def test_autoscale_off_by_default():
    eng = Engine(_mlp(), max_batch=4, slo_ms=60_000, device="cpu").load()
    try:
        assert eng._autoscaler is None
        eng.output(np.zeros((2, 12), np.float32))
        assert eng.metrics.counter_value("scale_ups") == 0
    finally:
        eng.shutdown()
