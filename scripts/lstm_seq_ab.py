#!/usr/bin/env python3
"""The LSTM layer's forward of two checkouts, timed on one GPU in turns.

    python3 scripts/lstm_seq_ab.py OTHER_DIR [--rounds 2]

OTHER_DIR holds another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists.  Each round starts one worker process per tree, the
other tree first, then this one, then this one, then the other (A B B A
for two rounds), so drift on the card touches both alike.  A worker
imports its own tree's ``chip_smoke.py`` and port, builds its kernels,
and times with that tree's ``device_ms`` (device time per call, the
host's enqueue hidden) and ``cuda_ms`` (one call alone, with events):

  layer_fwd    ``nn.layers.recurrent._scan_lstm`` of a standard
               ``LSTM(256)`` on the char-RNN's second layer's input, a dense
               [64, 50, 256] f32 chunk (x @ W, then the step loop: one K5a
               launch where the tree has ``lstm_seq_fwd_cuda``, else per
               step h @ RW, two adds and the per-cell K5a)
  projection   x @ W alone, the part both trees share
  stream_step  the same layer on one step at batch 1 with a carry, as
               ``rnn_time_step`` runs it

under ``torch.no_grad``, weights from a numpy seed.  Prints one JSON line
per worker, with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB, T, N = 64, 50, 256


def worker(tree: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.nn.layers import recurrent

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(cs.SEED + 80)
    f = lambda shape, sd: torch.from_numpy(sd * rng.standard_normal(shape, dtype=np.float32))
    params = {"W": f((N, 4 * N), N ** -0.5), "RW": f((N, 4 * N), N ** -0.5),
              "b": f((4 * N,), 0.1)}
    params = {k: v.to("cuda") for k, v in params.items()}
    x = torch.tanh(f((MB, T, N), 1.0)).to("cuda")
    h0, c0 = (f((MB, N), 0.5).to("cuda") for _ in range(2))
    cfg = recurrent.LSTM(n_in=N, n_out=N)
    layer = lambda: recurrent._scan_lstm(cfg, params, x, None, h0, c0)
    step = lambda: recurrent._scan_lstm(cfg, params, x[:1, :1], None, h0[:1], c0[:1])
    proj = lambda: x @ params["W"]
    tag = "this" if os.path.samefile(tree, REPO) else "other"
    out = {"tree": tag, "card": cs.card_line(), "shape": [MB, T, N]}
    with torch.no_grad():
        for name, fn in (("layer_fwd", layer), ("projection", proj), ("stream_step", step)):
            # two calls: the per-step path's ~200 launches a call, queued
            # behind the sleep, stay under the card's queue of pending launches
            out[name] = {"ms": cs.device_ms(fn, iters=2), "cuda_ms": cs.cuda_ms(fn, 10)}
        out["layer_fwd"]["hs_checksum"] = float(layer()[0].double().sum())
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lstm_seq_ab: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    order = [t for r in range(args.rounds)
             for t in ((other, REPO) if r % 2 == 0 else (REPO, other))]
    for tree in order:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree],
                            timeout=600).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
