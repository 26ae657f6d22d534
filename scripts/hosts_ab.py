#!/usr/bin/env python3
"""One host against two, on one NVIDIA GPU: `chip_smoke.py`'s dp = 2
worlds laid out as one host of two ranks and as two hosts of one rank
each (`parallel.dryrun`'s `hosts=`), in turns (one, two, two, one), over
gloo with both ranks on the one card.

    python3 scripts/hosts_ab.py [--parts serving,train] [--parent DIR]

Serving: the `parallel` phase's world (c), 16 seeded requests through
the dp = 2 batcher on Fish-1.5's seed-0 bf16 weights (frames/s; the
codes of every run must equal the first run's), each run in a process of
its own. --parent DIR adds the world of another commit unpacked there
(one host; e.g. the parent, with `git archive`) before and after the
turns: parent, two, one, one, two, parent. Training: `train_mesh`'s
world (c), 2 full-depth float32 steps with TF32 off, each held to the
unsharded step as the smoke holds it (s/step; the losses and grad norms
of every run must equal the first run's, bit for bit). Prints a line a
run and one JSON summary, beside the card's name and power limit. Exits non-zero where a check
fails.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the tree whose port runs: this one, or --parent's in a serving child
# (spawned ranks inherit the variable and import the same tree)
TREE_ENV = "HOSTS_AB_TREE"
sys.path.insert(0, os.environ.get(TREE_ENV, str(ROOT)))

TURNS = (1, 2, 2, 1)  # hosts of each run


def serving_turn(hosts: int) -> dict:
    """One run of the serving world (c) at `hosts` (the port and
    chip_smoke of the tree on sys.path): frames/s, seconds, launches and a
    digest of every request's codes."""
    import hashlib

    import numpy as np
    import torch

    import chip_smoke as cs
    from fish_speech_tpu_torch.config import DualARConfig, TokenConfig
    from fish_speech_tpu_torch.ops import _cuda_build
    from fish_speech_tpu_torch.ops.sampling import BATCHED_REP_PEN_WINDOW, SamplingArgs
    from fish_speech_tpu_torch.parallel import dryrun

    _cuda_build.load_library()
    cfg = DualARConfig.fish_speech_1_5()
    tok = TokenConfig(im_end_id=100011, pad_id=5, semantic_start_id=100012,
                      semantic_end_id=100012 + cfg.codebook_size - 1)
    batch_c = dict(rows=cs.SERVE_ROWS, horizon=cs.SERVE_HORIZON,
                   sampling=SamplingArgs(**cs.SAMPLING),
                   requests=cs.par_requests(np, cfg, cs.SERVE_ROWS),
                   engine=dict(dynamic_sampling=True, rep_pen_window=BATCHED_REP_PEN_WINDOW,
                               slow_impl="xla", fast_frame_impl="xla"))
    spec = cs.par_spec(cfg, tok, torch.bfloat16, {"batcher": batch_c})
    layout = {"hosts": hosts} if hosts > 1 else {}  # a tree before hosts= runs one host
    t0 = time.perf_counter()
    world = dryrun.serving_dryrun(2, 1, spec, device="cuda", backend="gloo",
                                  timeout_s=cs.PAR_TIMEOUT_S, **layout)
    wall = time.perf_counter() - t0
    cs.check_world(world, f"serving hosts={hosts}")
    if hosts > 1:
        cs.check_placement(world, f"serving hosts={hosts}")
    codes = hashlib.sha256()
    for r in world["batcher"]["requests"]:
        for c in r["chunks"]:
            codes.update(np.ascontiguousarray(c["semantic"]).tobytes())
            codes.update(np.ascontiguousarray(c["tokens"]).tobytes())
    return {"hosts": hosts, "frames_per_s": world["batcher"]["frames_per_s"],
            "seconds": world["batcher"]["seconds"], "wall_s": wall,
            "launches": [r["launches"] for r in world["ranks"]], "codes": codes.hexdigest()}


def main() -> int:
    import argparse
    import subprocess

    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="serving,train")
    ap.add_argument("--parent", default=None, help="another commit's tree, run at one host")
    ap.add_argument("--serving-turn", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.serving_turn is not None:  # a child: one serving run of $HOSTS_AB_TREE
        print(json.dumps(serving_turn(args.serving_turn)), flush=True)
        return 0

    import numpy as np
    import torch

    import chip_smoke as cs
    from fish_speech_tpu_torch.config import DualARConfig, TokenConfig
    from fish_speech_tpu_torch.parallel import dryrun
    from fish_speech_tpu_torch.train import TrainConfig

    if not torch.cuda.is_available():
        print("hosts_ab: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    cfg = DualARConfig.fish_speech_1_5()
    tok = TokenConfig(im_end_id=100011, pad_id=5, semantic_start_id=100012,
                      semantic_end_id=100012 + cfg.codebook_size - 1)
    tc = TrainConfig(learning_rate=cs.TRAIN_LR, warmup_steps=1, total_steps=cs.MESH_STEPS)
    batches = cs.mesh_batches(np, cfg, tok, seed=70, n=cs.MESH_STEPS, b=cs.MESH_B, s=cs.MESH_S)
    train_spec = dict(cfg=cfg, token_cfg=tok, tcfg=tc, dtype=torch.float32, seed=6,
                      runs=[{"batches": batches,
                             "reference": {"tight": cs.TRAIN_PARAM_TIGHT * cs.TRAIN_LR}}])

    out = {"device": smi, "serving": [], "train": []}
    first_codes = first_steps = None
    turns = [(str(ROOT), h) for h in TURNS]
    if args.parent:
        turns = [(args.parent, 1), (str(ROOT), 2), (str(ROOT), 1), (str(ROOT), 1),
                 (str(ROOT), 2), (args.parent, 1)]
    for tree, hosts in turns if "serving" in args.parts else ():
        child = subprocess.run([sys.executable, __file__, "--serving-turn", str(hosts)],
                               capture_output=True, text=True,
                               env=dict(os.environ, **{TREE_ENV: str(Path(tree).resolve())}))
        if child.returncode:
            print(child.stderr[-6000:], file=sys.stderr)
            raise RuntimeError(f"serving {tree} hosts={hosts}: exit {child.returncode}")
        run = json.loads(child.stdout.strip().splitlines()[-1])
        first_codes = first_codes or run["codes"]
        cs.check(run["codes"] == first_codes, f"serving {tree} hosts={hosts}: codes differ from "
                 "the first run's")
        run["tree"] = "parent" if tree == args.parent else "this"
        out["serving"].append(run)
        print(f"serving dp = 2, {run['tree']} tree, as {hosts} host(s): "
              f"{run['frames_per_s']:.1f} frames/s ({run['seconds']:.2f}s), codes equal to the "
              f"first run's; the world in {run['wall_s']:.1f}s; {smi}", flush=True)
    for hosts in TURNS if "train" in args.parts else ():
        t0 = time.perf_counter()
        world = dryrun.train_dryrun(2, 1, train_spec, device="cuda", backend="gloo",
                                    timeout_s=cs.MESH_TIMEOUT_S, hosts=hosts)
        wall = time.perf_counter() - t0
        line = cs.check_mesh_run(f"hosts={hosts}", world)
        steps = [(s["loss"], s["grad_norm"]) for s in world["runs"][0]["steps"]]
        first_steps = first_steps or steps
        cs.check(steps == first_steps, f"train hosts={hosts}: {steps} against the first run's "
                 f"{first_steps}")
        seconds = [s["seconds"] for s in world["runs"][0]["steps"]]
        out["train"].append({"hosts": hosts, "step_s": seconds, "wall_s": wall})
        print(f"train dp = 2 as {hosts} host(s): {' '.join('%.3f' % s for s in seconds)} "
              f"s/step, losses and grad norms bit-equal to the first run's; {line}; the world in "
              f"{wall:.1f}s; {smi}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
