#!/usr/bin/env python3
"""Does the reference test's ParagraphVectors recipe separate the topics
at more documents?  Both packages, on the CPU.

    python3 scripts/torch_pv_recipe_scale.py [--docs 120,500,2000,20000]
        [--modes dm,dbow] [--packages reference,port] [--epochs 20]

The recipe is ``tests/test_nlp_vectors.py``'s: the two-topic documents of
20 words (``topic_docs``, numpy seed 0), ``layer_size=24, window=3,
epochs=20, batch_size=128, seed=1, learning_rate=0.05``.  Each fit prints
one JSON line: the documents' mean within-topic and across-topic cosine
and the test's gate, within > across + 0.15.  ``reference`` runs
``deeplearning4j_tpu`` on JAX's CPU backend, ``port`` runs
``deeplearning4j_tpu_torch`` with ``device="cpu"``; the CPU tests hold the
two packages' fits to each other, so they should read alike.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANIMALS = ["cat", "dog", "pet", "fur", "paw", "tail", "meow", "bark"]
TECH = ["cpu", "ram", "disk", "code", "byte", "chip", "core", "cache"]


def topic_docs(n: int):
    """``tests/test_nlp_vectors.py``'s ``topic_docs`` at ``n`` documents."""
    rng = np.random.default_rng(0)
    docs, topics = [], []
    for _ in range(n):
        t = int(rng.integers(0, 2))
        docs.append(" ".join(rng.choice(ANIMALS if t == 0 else TECH, size=20)))
        topics.append(t)
    return docs, np.asarray(topics)


def pv_class(package: str):
    sys.path.insert(0, REPO)
    if package == "reference":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from deeplearning4j_tpu.nlp import ParagraphVectors
        return ParagraphVectors, {}
    import torch
    torch.set_num_threads(1)      # chunk steps of 16 rows: threads only add overhead
    from deeplearning4j_tpu_torch.nlp import ParagraphVectors
    return ParagraphVectors, {"device": "cpu"}


def within_across(vecs: np.ndarray, topics: np.ndarray):
    """Mean cosine of distinct same-topic pairs and of cross-topic pairs,
    from per-topic sums of the unit vectors (no [N, N] matrix)."""
    u = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-9)
    sums = np.stack([u[topics == g].sum(0) for g in (0, 1)]).astype(np.float64)
    counts = np.asarray([(topics == g).sum() for g in (0, 1)], np.float64)
    within = (np.sum(sums * sums) - counts.sum()) / np.sum(counts * (counts - 1))
    total = sums.sum(0)
    across = (total @ total - np.sum(sums * sums)) / (counts.sum() ** 2 - np.sum(counts ** 2))
    return float(within), float(across)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", default="120,500,2000,20000")
    ap.add_argument("--modes", default="dm,dbow")
    ap.add_argument("--packages", default="reference,port")
    ap.add_argument("--epochs", type=int, default=20)
    args = ap.parse_args()
    for package in args.packages.split(","):
        cls, kw = pv_class(package)
        for mode in args.modes.split(","):
            for n in map(int, args.docs.split(",")):
                docs, topics = topic_docs(n)
                labels = [f"DOC_{i}" for i in range(n)]
                t0 = time.perf_counter()
                pv = cls(dm=mode == "dm", layer_size=24, window=3, epochs=args.epochs,
                         batch_size=128, seed=1, learning_rate=0.05, **kw)
                pv.fit(docs, labels)
                seconds = time.perf_counter() - t0
                vecs = np.stack([pv.doc_vector(lb) for lb in labels])
                within, across = within_across(vecs, topics)
                print(json.dumps({"package": package, "mode": mode, "documents": n,
                                  "epochs": args.epochs, "cpu_seconds": seconds,
                                  "within": within, "across": across,
                                  "separates": within > across + 0.15,
                                  "finite": bool(np.isfinite(vecs).all())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
