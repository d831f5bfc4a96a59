"""What the ranks' agreement on a preemption notice costs on two gloo
ranks sharing one card.

Two parts, each printed as JSON lines:

1. In-process A/B.  Two ranks train the zoo LeNet at the shape of
   ``train --zoo lenet --data mnist --batch-size 256 --mesh
   dcn=2,data=1,compress=threshold`` (a global [256, 28, 28, 1] batch,
   128 rows a rank) under ``ElasticTrainer`` with a ``PreemptionHandler``
   and no checkpoint in the timed window, ``sync_every=4`` as ``train
   --checkpoint-every 4`` sets it.  Arm ``default``: the ranks agree on a
   notice every ``sync_every`` steps; arm ``every_step``: before every
   step (one MAX all-reduce a step, the earlier behaviour).  ``--pairs``
   pairs, the first arm alternating (A B, B A, ...), ``--steps`` timed
   steps each after a warm-up; ms a step on each rank.
2. ``--trees DIR [DIR ...]``: the chaos-off ``launch`` of
   ``chip_smoke.py``'s arm (c) run from each tree, ``--pairs`` times, the
   order alternating; the launch report's wall seconds.  Use it to
   compare two checkouts (unpack one with ``git archive``).

    python3 scripts/notice_agreement_ab.py [--steps 300] [--pairs 5] [--trees OLD NEW]

Needs a CUDA card; prints the card's name and power limit first.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TRAIN = ["train", "--zoo", "lenet", "--data", "mnist", "--batch-size", "256",
                "--epochs", "3", "--mesh", "dcn=2,data=1,compress=threshold",
                "--checkpoint-every", "4", "--print-every", "1000"]
WARMUP = 20


def alternating(arms, pairs: int):
    """``arms`` ``pairs`` times, forwards then backwards."""
    return [a for i in range(pairs) for a in (arms if i % 2 == 0 else arms[::-1])]


def rank_main(rank: int, work: str, steps: int, pairs: int) -> None:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import ZOO
    from deeplearning4j_tpu_torch.parallel import (ElasticTrainer, ShardedTrainer, build_mesh,
                                                   initialize, shutdown)
    from deeplearning4j_tpu_torch.parallel.preemption import PreemptionHandler

    class AgreeEveryStep(ElasticTrainer):
        def _check_preemption(self):
            sync, self.sync_every = self.sync_every, 1
            try:
                super()._check_preemption()
            finally:
                self.sync_every = sync

    initialize(init_method="file://" + os.path.join(work, "rendezvous"), num_processes=2,
               process_id=rank, backend="gloo", timeout_s=300)
    rng = np.random.default_rng(0)
    ds = DataSet(torch.from_numpy(rng.random((256, 28, 28, 1), dtype=np.float32)).cuda(),
                 torch.from_numpy(np.eye(10, dtype=np.float32)[rng.integers(0, 10, 256)])
                 .cuda())
    times = {}
    for rep, arm in enumerate(alternating(("every_step", "default"), pairs)):
        trainer = ShardedTrainer(ZOO["lenet"](device="cuda"), build_mesh({"dcn": 2, "data": 1}),
                                 grad_compression="threshold")
        cls = AgreeEveryStep if arm == "every_step" else ElasticTrainer
        et = cls(trainer, os.path.join(work, f"ck{rep}"), checkpoint_every=10**9, sync_every=4,
                 preemption=PreemptionHandler(grace_s=60))
        et.fit([ds] * WARMUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = et.fit([ds] * steps)
        float(losses[-1])
        torch.cuda.synchronize()
        times.setdefault(arm, []).append((time.perf_counter() - t0) * 1e3 / steps)
    shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(times, f)


def in_process(steps: int, pairs: int) -> dict:
    with tempfile.TemporaryDirectory() as work:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   work, "--steps", str(steps), "--pairs", str(pairs)])
                 for r in range(2)]
        try:
            for p in procs:
                p.wait(timeout=900)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise SystemExit(f"a rank failed: {[p.returncode for p in procs]}")
        out = {}
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                out[r] = json.load(f)
    return out


def launch_wall(tree: str) -> float:
    with tempfile.TemporaryDirectory() as d:
        cmd = ([sys.executable, "-m", "deeplearning4j_tpu_torch", "launch", "--nprocs", "2",
                "--bootstrap", "distributed", "--run-dir", os.path.join(d, "run"),
                "--report", os.path.join(d, "report.json"), "--deadline", "420",
                "--heartbeat-timeout", "60", "--connect-timeout", "180", "--"]
               + LAUNCH_TRAIN + ["--elastic-dir", os.path.join(d, "ck")])
        p = subprocess.run(cmd, cwd=d, env=dict(os.environ, PYTHONPATH=os.path.abspath(tree)),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=480)
        if p.returncode:
            raise SystemExit(f"launch from {tree} exited {p.returncode}:\n"
                             f"{p.stdout.decode(errors='replace')[-3000:]}")
        with open(os.path.join(d, "report.json")) as f:
            return json.load(f)["wall_seconds"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--trees", nargs="*", default=[])
    ap.add_argument("--rank", nargs=2, metavar=("R", "WORK"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank:
        rank_main(int(args.rank[0]), args.rank[1], args.steps, args.pairs)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
          .stdout.strip(), flush=True)
    ranks = in_process(args.steps, args.pairs)
    print(json.dumps({"part": "in_process", "steps": args.steps, "pairs": args.pairs,
                      "ms_per_step": ranks}), flush=True)
    if args.trees:
        walls = {}
        for tree in alternating(args.trees, args.pairs):
            walls.setdefault(tree, []).append(launch_wall(tree))
        print(json.dumps({"part": "launch_wall_s", "walls": walls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
