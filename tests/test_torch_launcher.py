"""The port's pod launcher (``deeplearning4j_tpu_torch/parallel/launcher.py``)
and bounded rendezvous (``parallel/distributed.py``) on the CPU.

Against the JAX package: the same join/leave script drives both
``Membership`` ledgers (one directory each, a fake clock) to the same
epochs and members, either package's ``Membership`` reads the other's
ledger, and ``elect_coordinator`` elects alike.  A dead coordinator
raises ``CoordinatorUnreachableError`` within its timeout.  The
epoch-gated join: ``wait_for_members`` returns only an epoch newer than
the spawn's that lists every process.

Three launcher runs of ``--device cpu`` workers (the CLI's ``launch``),
each bounded to 90 s: replica mode with a ``proc_kill`` relaunched and no
orphan left; an announced preemption whose relaunch spends no restart
budget; and two gloo ranks under ``--bootstrap distributed`` on a
compressed mesh whose killed rank rejoins (the survivor rebuilds the
group at the new epoch and both restore the same checkpoint), its
replayed steps bitwise the first pass.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.parallel import (CoordinatorUnreachableError, Membership,
                                               elect_coordinator, initialize)
from deeplearning4j_tpu_torch.parallel.launcher import _visible_devices, wait_for_members

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


#: (op, arg): beat ids, advance the clock, refresh, leave/clear markers
SCRIPT = [("beat", [0, 1, 2]), ("refresh", None), ("refresh", None),
          ("tick", 6.0), ("beat", [0]), ("refresh", None), ("beat", [1, 3]),
          ("refresh", None), ("leave", 3), ("refresh", None), ("clear", 3),
          ("beat", [0, 1, 3]), ("refresh", None), ("remove", 1), ("refresh", None)]


def _play(cls, directory):
    clock = FakeClock()
    m = cls(directory, heartbeat_timeout=5.0, clock=clock)
    out = []
    for op, arg in SCRIPT:
        if op == "beat":
            for i in arg:
                m.beat(i, pid=100 + i, step=7, addr=None)
        elif op == "tick":
            clock.t += arg
        elif op == "leave":
            m.mark_leaving(arg, grace_s=30.0)
        elif op == "clear":
            m.clear_leaving(arg)
        elif op == "remove":
            m.remove(arg)
        else:
            out.append((m.refresh(), m.members(), m.alive(), sorted(m.leaving())))
    return out


def test_membership_script_gives_the_references_epochs(tmp_path):
    from deeplearning4j_tpu.parallel.launcher import Membership as JMembership

    port = _play(Membership, str(tmp_path / "p"))
    ref = _play(JMembership, str(tmp_path / "j"))
    assert port == ref
    assert [e for e, *_ in port] == [1, 1, 2, 3, 4, 5, 6]


def test_ledgers_read_across_packages(tmp_path):
    from deeplearning4j_tpu.parallel.launcher import Membership as JMembership

    clock = FakeClock()
    p = Membership(str(tmp_path), heartbeat_timeout=5.0, clock=clock)
    p.beat(0, step=3, ckpt_step=2)
    p.beat(2)
    p.refresh()
    p.mark_leaving(2, grace_s=10.0)
    j = JMembership(str(tmp_path), heartbeat_timeout=5.0, clock=clock)
    assert j.epoch == 1 and j.members() == [0, 2]
    assert j.alive() == [0] and sorted(j.leaving()) == [2]
    assert j.last_checkpoint_step() == 2 and j.last_beat(0)["step"] == 3


@pytest.mark.parametrize("alive,addr", [([0, 1, 2], None), ([1, 2], None),
                                        ([2], "10.0.0.7")])
def test_elect_coordinator_matches_the_reference(tmp_path, alive, addr):
    from deeplearning4j_tpu.parallel.launcher import elect_coordinator as jelect

    clock = FakeClock()
    m = Membership(str(tmp_path), heartbeat_timeout=5.0, clock=clock)
    for i in alive:
        m.beat(i, addr=addr)
    ports = [9000, 9001, 9002]
    assert elect_coordinator(m, ports) == jelect(m, ports)
    assert elect_coordinator(m, ports)[0] == min(alive)


def test_elect_raises_when_nobody_is_alive(tmp_path):
    with pytest.raises(CoordinatorUnreachableError, match="no alive member"):
        elect_coordinator(Membership(str(tmp_path)), [9000])


def test_dead_coordinator_raises_within_its_timeout():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.monotonic()
    with pytest.raises(CoordinatorUnreachableError, match="unreachable"):
        initialize(f"127.0.0.1:{port}", num_processes=2, process_id=1, timeout_s=1.5,
                   backend="gloo")
    assert time.monotonic() - t0 < 10.0


def test_join_waits_for_a_newer_epoch_with_every_process(tmp_path):
    clock = FakeClock()
    m = Membership(str(tmp_path), heartbeat_timeout=5.0, clock=clock)
    m.beat(0)
    m.beat(1)
    assert m.refresh() == 1
    with pytest.raises(CoordinatorUnreachableError, match="did not list"):
        wait_for_members(m, 2, after=1, timeout_s=0.2)      # no newer epoch yet
    m.remove(1)
    m.refresh()                                             # epoch 2: [0]
    with pytest.raises(CoordinatorUnreachableError):
        wait_for_members(m, 2, after=1, timeout_s=0.2)      # newer, not complete
    m.beat(1)
    m.refresh()                                             # epoch 3: [0, 1]
    assert wait_for_members(m, 2, after=1, timeout_s=0.2) == 3


def test_surviving_mesh_and_its_errors_are_the_references():
    """``surviving_mesh`` over the ranks of the surviving slices, with the
    reference's error texts (its devices are the port's ranks)."""
    import jax

    from deeplearning4j_tpu.parallel.mesh import surviving_mesh as jsurviving
    from deeplearning4j_tpu_torch.parallel import surviving_mesh

    devs = jax.devices()[:8]
    for alive, n in (([0, 2], 4), ([1], 2), ([0, 1, 2, 3], 4)):
        want = dict(jsurviving(alive, n, devices=devs).shape)
        assert surviving_mesh(alive, n, world_size=8).shape == want
    for alive, n in (([], 4), ([0, 4], 4), ([0], 3)):
        with pytest.raises(ValueError) as ref:
            jsurviving(alive, n, devices=devs)
        with pytest.raises(ValueError, match=str(ref.value).replace("[", r"\[")
                           .replace("]", r"\]").replace("(", r"\(").replace(")", r"\)")):
            surviving_mesh(alive, n, world_size=8)


def test_multiprocess_probe_forms_a_gloo_group():
    from deeplearning4j_tpu_torch.parallel import probe_multiprocess_support

    assert probe_multiprocess_support(timeout_s=60.0) == (True, "")


def test_visible_devices_wrap_around_the_cards():
    assert [_visible_devices(i, 1, 1) for i in range(3)] == ["0", "0", "0"]
    assert [_visible_devices(i, 2, 4) for i in range(3)] == ["0,1", "2,3", "0,1"]


# -- launcher runs ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def conf_path(tmp_path_factory):
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    conf = (NeuralNetConfiguration.builder().seed(3).updater(Sgd(lr=0.1))
            .layer(Dense(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    path = tmp_path_factory.mktemp("conf") / "conf.json"
    path.write_text(json.dumps(conf.to_dict()))
    return str(path)


def _launch(tmp_path, launch_args, train_args, timeout=90):
    report = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = ([sys.executable, "-m", "deeplearning4j_tpu_torch", "launch",
            "--run-dir", str(tmp_path / "run"), "--report", str(report),
            "--deadline", str(timeout - 15), "--heartbeat-timeout", "20"]
           + launch_args + ["--", "train"] + train_args + ["--device", "cpu"])
    p = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True,
                       timeout=timeout)
    out = p.stdout.decode(errors="replace") + p.stderr.decode(errors="replace")
    assert p.returncode == 0, out[-4000:]
    rep = json.loads(report.read_text())
    for h in rep["events"]:
        if h["kind"] == "spawn":
            with pytest.raises(ProcessLookupError):
                os.kill(h["pid"], 0)                       # no orphan left
    return rep, out


def _train(conf_path, ckdir, extra=()):
    return ["--config", conf_path, "--data", "iris", "--batch-size", "50", "--epochs", "4",
            "--elastic-dir", ckdir, "--checkpoint-every", "2", "--print-every", "1000",
            "--losses-out", "losses_{process}_{incarnation}.json"] + list(extra)


def test_replica_mode_relaunches_a_killed_worker(tmp_path, conf_path):
    # worker 0 writes the shared store (worker 1 only reads it), so its
    # kill and resume are step-exact
    rep, _ = _launch(tmp_path, ["--nprocs", "2", "--chaos-worker", "0:proc_kill@5"],
                     _train(conf_path, str(tmp_path / "ck")))
    assert rep["ok"] and rep["completed"] == [0, 1]
    assert rep["restarts"] == 1 and rep["budget_used"] == {"0": 1, "1": 0}
    assert [s for s, _ in json.loads((tmp_path / "losses_0_1.json").read_text())["steps"]] == \
        list(range(5, 13))
    assert rep["epoch"] >= 3 and rep["leaked_killed"] == 0
    assert [e["cause"] for e in rep["leaves"]] == ["crash"]


def test_preemption_relaunch_spends_no_budget(tmp_path, conf_path):
    rep, _ = _launch(tmp_path, ["--nprocs", "1", "--grace", "20", "--chaos-worker",
                                "0:preempt_notice@5"],
                     _train(conf_path, str(tmp_path / "ck")))
    assert rep["ok"] and rep["restarts"] == 0 and rep["planned_leaves"] == 1
    assert [(e["cause"], e["rc"]) for e in rep["leaves"]] == [("preempted", 75)]
    first = json.loads((tmp_path / "losses_0_0.json").read_text())["steps"]
    second = json.loads((tmp_path / "losses_0_1.json").read_text())["steps"]
    # zero steps lost: the relaunch resumes at the preempted step
    assert [s for s, _ in first] == list(range(1, 6))
    assert [s for s, _ in second] == list(range(6, 13))


def test_two_gloo_ranks_rejoin_after_a_kill(tmp_path, conf_path):
    rep, _ = _launch(
        tmp_path, ["--nprocs", "2", "--bootstrap", "distributed", "--chaos-worker",
                   "1:proc_kill@6"],
        _train(conf_path, str(tmp_path / "ck"),
               ["--mesh", "dcn=2,data=1,compress=threshold", "--step-timeout", "30"]))
    assert rep["ok"] and rep["restarts"] == 1 and rep["completed"] == [0, 1]
    w0 = json.loads((tmp_path / "losses_0_0.json").read_text())["steps"]
    w1 = json.loads((tmp_path / "losses_1_1.json").read_text())["steps"]
    steps0 = [s for s, _ in w0]
    # worker 0 ran steps 1-5, lost its peer at 6, restored step 4 and
    # replayed; the relaunched worker 1 resumed at step 4 too
    assert steps0[:5] == [1, 2, 3, 4, 5] and steps0[5:] == list(range(5, 13))
    assert [s for s, _ in w1] == list(range(5, 13))
    first = dict(w0[:5])
    assert w0[5][1] == first[5]                       # the replay is bitwise
    assert dict(w0[5:]) == dict(w1)                   # the ranks agree bitwise
    assert np.isfinite([l for _, l in w0]).all()
