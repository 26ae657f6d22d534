#!/usr/bin/env python3
"""Batch-1 `generate` on requests that end at <|im_end|>, on one NVIDIA GPU.

    python3 scripts/eos_generate_ab.py [--tree DIR] [--modes graph,eager,eager,graph]
                                       [--eos-scale 1.0] [--max-new 512] [--requests 8]

Fish-1.5 at full width on random bf16 weights (seed 0) with the im_end
head column kept (times --eos-scale), so sampled requests stop at EOS as
real ones do; the 40-token prompt of `chip_smoke.py`, temp 0.7 / top_p
0.8 / top_k 256 / rep-pen 1.4, seeds 0..N-1, budget --max-new frames.
Each mode runs the N requests back to back after one untimed request,
then waits for the card: the wall includes the frames a request runs
past its EOS. Prints one JSON line a mode: frames/s over the whole run,
each request's frames, seconds and whether it hit the budget, and a
digest of its codes.

--tree DIR imports the port from DIR instead of this checkout (another
commit unpacked there, e.g. with `git archive`), where `--modes` may
only be `default` if its engine has no `decode_impl`. Set
FISH_TPU_CACHE_DIR to share one kernel build between the trees. Prints
the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--modes", default="graph,eager,eager,graph")
    ap.add_argument("--eos-scale", type=float, default=1.0)
    ap.add_argument("--max-new", type=int, default=512)
    ap.add_argument("--requests", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import numpy as np
    import torch

    from fish_speech_tpu_torch.config import DualARConfig, TokenConfig, WhichLM
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params
    from fish_speech_tpu_torch.ops import _cuda_build
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs
    from fish_speech_tpu_torch.utils.cache import setup_compilation_cache

    if not torch.cuda.is_available():
        print("eos_generate_ab: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    setup_compilation_cache()
    _cuda_build.load_library()
    cfg = DualARConfig.fish_speech_1_5()
    tok = TokenConfig(im_end_id=100011, pad_id=5, semantic_start_id=100012,
                      semantic_end_id=100012 + cfg.codebook_size - 1)
    params = init_dual_ar_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    params["output"][:, tok.im_end_id] *= args.eos_scale
    rng = np.random.default_rng(0)
    prompt = np.concatenate([rng.integers(1000, 90000, size=(1, 40)),
                             np.zeros((cfg.num_codebooks, 40), np.int64)]).astype(np.int32)
    sampling = SamplingArgs(temp=0.7, top_p=0.8, top_k=256, repetition_penalty=1.4)
    has_impl = "decode_impl" in inspect.signature(LMEngine.__init__).parameters
    engines = {}
    for mode in dict.fromkeys(args.modes.split(",")):
        kw = {} if mode == "default" else dict(decode_impl=mode)
        if kw and not has_impl:
            raise SystemExit(f"eos_generate_ab: the engine in {args.tree} has no decode_impl")
        engines[mode] = LMEngine(params, cfg, tok, WhichLM.FISH_1_5, max_frames=args.max_new,
                                 prompt_buckets=(64,), **kw)
    for eng in engines.values():  # warm: kernels built, graphs captured
        eng.generate(prompt, max_new_tokens=args.max_new, sampling=sampling, seed=1000)
    torch.cuda.synchronize()

    for turn, mode in enumerate(args.modes.split(",")):
        eng = engines[mode]
        reqs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for seed in range(args.requests):
            t1 = time.perf_counter()
            res, _ = eng.generate(prompt, max_new_tokens=args.max_new, sampling=sampling,
                                  seed=seed)
            codes = np.concatenate([res.semantic[None], res.tokens]).astype(np.int32)
            reqs.append(dict(frames=int(res.frames), hit_max=bool(res.hit_max),
                             s=time.perf_counter() - t1,
                             codes=hashlib.sha256(codes.tobytes()).hexdigest()[:12]))
        returned = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        frames = sum(r["frames"] for r in reqs)
        print(json.dumps({"tree": args.label, "mode": mode, "turn": turn,
                          "eos_scale": args.eos_scale, "max_new": args.max_new,
                          "frames": frames, "wall_s": wall, "frames_per_s": frames / wall,
                          "drain_s": wall - returned,
                          "ended_at_eos": sum(not r["hit_max"] for r in reqs),
                          "requests": reqs, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
