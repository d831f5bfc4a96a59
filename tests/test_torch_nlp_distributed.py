"""The port's ``DistributedWord2Vec`` (``deeplearning4j_tpu_torch/nlp/
distributed.py``) on one rank and on two gloo ranks (this file run as a
script, ``--worker R DIR``) against one-rank ``Word2Vec`` — the port's and
the reference's — at the reference's own gate
(``tests/test_nlp_distributed.py``: rtol 1e-4, atol 1e-5), with the
topic separation gate on two ranks, the ranks' tables bitwise equal, and
the reference's refusals (CBOW, HS, an indivisible batch, a missing axis,
chunked updates).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the fits run thousands of tiny ops, which
    several test workers sharing the cores would otherwise oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(layer_size=16, window=3, min_word_frequency=2, epochs=3,
          batch_size=128, seed=5, learning_rate=0.05, subsampling=0)
SEM_KW = dict(layer_size=32, window=3, min_word_frequency=2, epochs=12,
              batch_size=128, seed=1, learning_rate=0.05, subsampling=0)


def topic_corpus(n=400, seed=0):
    rng = np.random.default_rng(seed)
    topics = [["cat", "dog", "pet", "fur", "paw", "tail", "meow", "bark"],
              ["cpu", "ram", "disk", "code", "byte", "chip", "core", "cache"]]
    return [" ".join(rng.choice(topics[int(rng.integers(0, 2))], size=8))
            for _ in range(n)]


def _worker(rank: int, work: str) -> None:
    import torch

    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.nlp import DistributedWord2Vec
    from deeplearning4j_tpu_torch.parallel import build_mesh, initialize, shutdown

    initialize(init_method="file://" + os.path.join(work, "rendezvous"), num_processes=2,
               process_id=rank, backend="gloo", timeout_s=100)
    mesh = build_mesh({"data": 2})
    parity = DistributedWord2Vec(mesh=mesh, device="cpu", **KW).fit(topic_corpus(100))
    sem = DistributedWord2Vec(mesh=mesh, device="cpu", **SEM_KW).fit(topic_corpus())
    shutdown()
    np.savez(os.path.join(work, f"rank{rank}.npz"), parity=parity.syn0, sem=sem.syn0,
             within=sem.similarity("cat", "dog"), across=sem.similarity("cat", "cpu"),
             gathered=parity._dp_step.last_gathered_bytes)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("dw2v"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                               str(r), work], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    return [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(2)]


@pytest.fixture(scope="module")
def plain():
    from deeplearning4j_tpu.nlp import Word2Vec as JW
    from deeplearning4j_tpu_torch.nlp import Word2Vec

    return (Word2Vec(device="cpu", **KW).fit(topic_corpus(100)).syn0,
            JW(**KW).fit(topic_corpus(100)).syn0)


def test_one_rank_mesh_matches_plain_word2vec(plain):
    from deeplearning4j_tpu_torch.nlp import DistributedWord2Vec
    from deeplearning4j_tpu_torch.parallel import build_mesh

    dist = DistributedWord2Vec(mesh=build_mesh({"data": 1}), device="cpu", **KW)
    dist.fit(topic_corpus(100))
    for want in plain:
        np.testing.assert_allclose(dist.syn0, want, rtol=1e-4, atol=1e-5)


def test_two_ranks_match_plain_word2vec(two_ranks, plain):
    np.testing.assert_array_equal(two_ranks[0]["parity"], two_ranks[1]["parity"])
    for want in plain:
        np.testing.assert_allclose(two_ranks[0]["parity"], want, rtol=1e-4, atol=1e-5)
    # a rank gathers its rows and the other rank's: 2 x 64 pairs x (1+5) targets
    per_rank = 64 * (8 + 4) + 64 * 6 * (8 + 4) + 64 * 16 * 4 + 64 * 6 * 16 * 4
    assert int(two_ranks[0]["gathered"]) == 2 * per_rank


def test_topics_separate_on_two_ranks(two_ranks):
    np.testing.assert_array_equal(two_ranks[0]["sem"], two_ranks[1]["sem"])
    within, across = float(two_ranks[0]["within"]), float(two_ranks[0]["across"])
    assert within > across + 0.2, f"within={within:.3f} across={across:.3f}"


def test_unsupported_modes_rejected():
    from deeplearning4j_tpu_torch.nlp import DistributedWord2Vec
    from deeplearning4j_tpu_torch.parallel import build_mesh

    with pytest.raises(NotImplementedError, match="CBOW"):
        DistributedWord2Vec(cbow=True, device="cpu")
    with pytest.raises(NotImplementedError, match="CBOW"):
        DistributedWord2Vec(hierarchic_softmax=True, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        DistributedWord2Vec(mesh=build_mesh({"data": 8}, world_size=8), batch_size=100,
                            device="cpu")
    with pytest.raises(ValueError, match="axis"):
        DistributedWord2Vec(mesh=build_mesh({"model": 8}, world_size=8), device="cpu")
    dist = DistributedWord2Vec(mesh=build_mesh({"data": 1}), device="cpu")
    with pytest.raises(NotImplementedError, match="chunks>1"):
        dist._sg_step(None, None, None, None, None, None, 0.1, chunks=4)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3])
