#!/usr/bin/env python3
"""Where a StatsListener record's time goes on the card (one GPU).

    python3 scripts/torch_stats_breakdown.py [--top N]

Lays out GPT-2-small's parameters (``chip_smoke.build_model``: 163M f32
in ~150 leaves) and their deltas from a perturbed copy as the listener
does, then times ``ui.stats.flat_stats`` over both with and without
histograms: wall ms (median of 5, synced), and one ``torch.profiler``
trace each (``chip_smoke.device_profile``: device-busy ms, idle share,
kernel count, device ms by class and the top kernels).  Prints one JSON
line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_stats_breakdown: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from deeplearning4j_tpu_torch.ui import stats

    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    net = chip_smoke.build_model()
    leaves = [v for p in net.params for v in p.values()]
    pids = [str(i) for i in range(len(leaves))]
    current = stats._Flat(pids, leaves)
    last = stats._Flat(pids, [v + 1e-3 * torch.randn_like(v) for v in leaves])
    _, dparts = current.deltas(last)
    parts = current.parts() + dparts
    n = sum(len(s) for _, s in parts)
    elements = sum(x.numel() for x, _ in parts)
    for hist in (True, False):
        stats.flat_stats(parts, 20, hist)          # warm-up
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            stats.flat_stats(parts, 20, hist)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        prof = chip_smoke.device_profile(lambda: stats.flat_stats(parts, 20, hist),
                                         top=args.top)
        print(json.dumps({"histograms": hist, "leaves": n, "elements": elements,
                          "wall_ms": walls, "median_wall_ms": sorted(walls)[2], **prof}),
              flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
