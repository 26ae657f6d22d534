#!/usr/bin/env python3
"""Time to first audio on one NVIDIA GPU, under the captured decode loop
and eagerly, in turns, stage by stage.

    python3 scripts/ttfa_graph_ab.py

`chip_smoke.py`'s ttfa path (`bench.py --ttfa`'s: Fish-1.5 at full width,
random bf16 weights from a seed, cache 512, bucket 64, the 40-token
prompt; a prefill and its first frame read, one 16-frame `decode_chunk`
issued and read, one streaming Firefly feed) on two engines that differ
only in `decode_impl` ("graph", "eager"): the median ms of each stage
over 12 trials of each, in turns (graph, eager, eager, graph), once
before any `torch.profiler` session in the process and once after one.
Builds the kernel library first. Prints the card's name and power
limit beside the numbers.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STAGES = ("init", "prefill + read", "decode issue", "decode read", "feed")


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from fish_speech_tpu_torch.config import WhichLM
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.ops import _cuda_build
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    if not torch.cuda.is_available():
        print("ttfa_graph_ab: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    _cuda_build.load_library()
    fused, _, _, _, codec, tok, _, params = cs.build_models(torch)
    cfg = fused.cfg
    sampling = SamplingArgs(**cs.SAMPLING)
    prompt = cs.main_prompt(np, cfg)
    engines = {impl: LMEngine(params, cfg, tok, WhichLM.FISH_1_5, cache_len=cs.SERVE_CACHE,
                              max_frames=cs.TTFA_FRAMES, prompt_buckets=(64,),
                              decode_impl=impl)
               for impl in ("graph", "eager")}

    def trial(engine):
        t = [time.perf_counter()]
        state = engine.init_state(0)
        stream = codec.start_stream(max_step_frames=cs.TTFA_FRAMES)
        t.append(time.perf_counter())
        state, first, _, _ = engine._prefill_raw(state, prompt, sampling)
        frames = [first.cpu().numpy()[0]]
        t.append(time.perf_counter())
        state, out, valid, steps = engine.decode_chunk(state, sampling, cs.TTFA_FRAMES)
        t.append(time.perf_counter())
        out, valid, steps = (x.cpu().numpy() for x in (out, valid, steps))
        t.append(time.perf_counter())
        frames += [out[i, 0] for i in range(int(steps)) if valid[i, 0]]
        stream.feed(np.stack(frames, axis=1)[1:])
        t.append(time.perf_counter())
        return np.diff(t) * 1e3

    def run(label):
        got = {k: [] for k in engines}
        for eng in engines.values():  # warm: the graph's loop captured
            trial(eng)
        for _ in range(6):
            for k in ("graph", "eager", "eager", "graph"):
                got[k].append(trial(engines[k]))
        for k, v in got.items():
            m = np.median(np.array(v), axis=0)
            parts = ", ".join(f"{n} {x:.2f}" for n, x in zip(STAGES, m))
            print(f"ttfa {label}, {k}: median ms of {len(v)}: {parts}; total {m.sum():.2f} "
                  f"[{smi}]", flush=True)

    run("before any torch.profiler session")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        trial(engines["graph"])
        torch.cuda.synchronize()
    run("after one torch.profiler session")
    return 0


if __name__ == "__main__":
    sys.exit(main())
