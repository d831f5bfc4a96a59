#!/usr/bin/env python3
"""K6 (threshold encode) and K5b (LSTM cell backward) of two checkouts,
timed on one GPU in turns.

    python3 scripts/encode_lstm_ab.py OTHER_DIR [--rounds 2]

OTHER_DIR holds another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists.  Each round starts one worker process per tree, the
other tree first, then this one, then this one, then the other (A B B A
for two rounds), so drift on the card touches both alike.  A worker
imports its own tree's ``chip_smoke.py`` and port, builds its kernels,
and times with that tree's ``device_ms`` (device time per call, the
host's enqueue hidden):

  lstm_cell_bwd  K5b at the char-RNN's [64, 256], f32 and bf16
                 (``chip_smoke.lstm_case``, which also times the library's
                 ``_thnn_fused_lstm_cell_backward``)
  encode_bucket  K6 on one 4 MiB bucket, 2% hot (``chip_smoke.encode_case``)
  encode_step    K6 over the compressed phase's 156 buckets (4 MiB buckets
                 over the TransformerLM's 163,131,264 parameters, a 2%-hot
                 gradient drawn on the card from a seed): one launch where
                 the tree has ``threshold_encode_buckets_cuda``, else one
                 launch a bucket

Prints one JSON line per worker and measurement, with the card's name and
power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def this_smoke():
    """This tree's ``chip_smoke.py`` as a module: the compressed phase's
    bucket layout (``DP_BUCKET_SIZES``) and gradient (``step_gradient``),
    which an older tree may lack, come from it for both trees."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("this_chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import compression as comp

    tag = "this" if os.path.samefile(tree, REPO) else "other"
    out = {"tree": tag, "card": cs.card_line()}
    with contextlib.redirect_stdout(io.StringIO()):    # the cases print their records
        lstm = {dt: cs.lstm_case(cs.RNN_B, cs.RNN_HIDDEN, getattr(torch, dt))["lstm_cell_bwd"]
                for dt in ("float32", "bfloat16")}
        bucket = cs.encode_case(1 << 20, "hot")
    out["lstm_cell_bwd"] = {dt: {k: r[k] for k in ("ms", "library_ms", "max_abs_err")}
                            for dt, r in lstm.items()}
    out["encode_bucket"] = {k: bucket[k] for k in ("ms", "launch_ms", "bitwise")}

    this = this_smoke()
    sizes, t = this.DP_BUCKET_SIZES, this.COMPRESS_T
    g = this.step_gradient(sizes, t)
    ks = [comp.default_k_max(m) for m in sizes]
    if hasattr(comp, "threshold_encode_buckets_cuda"):
        step = lambda: comp.threshold_encode_buckets_cuda(g, sizes, ks, t)
        launches, iters = 1, 5
    else:        # 156 launches a call: one call per timing keeps the enqueue under the sleep
        parts = g.split(sizes)
        step = lambda: [comp.threshold_encode_cuda(p, k, t) for p, k in zip(parts, ks)]
        launches, iters = len(sizes), 1
    out["encode_step"] = {"ms": cs.device_ms(step, iters=iters), "launches": launches,
                          "events_ms": cs.cuda_ms(step, 10)}
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("encode_lstm_ab: no CUDA device", file=sys.stderr)
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
