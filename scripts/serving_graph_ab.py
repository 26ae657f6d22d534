#!/usr/bin/env python3
"""The serving paths under the captured decode loop and eagerly, in turns,
on one NVIDIA GPU.

    python3 scripts/serving_graph_ab.py [--tree DIR] [--paths serving,central,server,dual_ar]

`chip_smoke.py`'s serving cells on engines that differ only in
`decode_impl` ("graph" is what "auto" picks on the card; "eager"), each
path in turns graph, eager, eager, graph, in one process:

* serving: 20 requests at once on the 16-row `auto` engine, clients
  vocoding (`chip_smoke.serving_run`): LM frames/s, RTF p50;
* central: the same through the central vocoder (`central_run`): PCM
  frames/s, RTF p50, TTFA p50;
* server: the HTTP burst of `run_server` (20 requests through
  create_batcher(16, 16) behind the app): requests/s, frames/s, client
  RTF p50, TTFA p50;
* DualAR: 8 requests through its pipeline's batcher with Mimi
  (`version_serving`): frames/s, RTF p50; twelve turns, its runs being
  short.

Then serving and central again after one `torch.profiler` session, which
the smoke's serving phases run behind. --paths picks some of the four. --tree DIR runs only serving and
central, twice each, on the default engine of another commit unpacked
there (e.g. the parent, with `git archive`), through that commit's
`chip_smoke.py`; set FISH_TPU_CACHE_DIR to share one kernel build. Fish-1.5 at full width on random
bf16 weights (seed 0), the loud Firefly codec of the smoke's stream
phase. Prints a line a turn and a JSON summary, beside the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

TURNS = ("graph", "eager", "eager", "graph")
DUAL_AR_TURNS = TURNS * 3  # its runs are short (~0.7 s each)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--paths", default="serving,central,server,dual_ar")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree or Path(__file__).resolve().parent.parent).resolve()))
    import numpy as np
    import torch

    import chip_smoke as cs
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.ops import _cuda_build
    from fish_speech_tpu_torch.ops.sampling import BATCHED_REP_PEN_WINDOW, SamplingArgs
    from fish_speech_tpu_torch.pipeline import TTSPipeline
    from fish_speech_tpu_torch.utils.cache import setup_compilation_cache

    if not torch.cuda.is_available():
        print("serving_graph_ab: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = cs.nvidia_smi_line()
    setup_compilation_cache()
    _cuda_build.load_library()
    fused, _, serving, _, codec, tok, codec_cfg, params = cs.build_models(torch)
    loud, loud32, bound16 = cs.run_stream(torch, np, codec, codec_cfg, smi)
    cfg = fused.cfg
    reqs = cs.serving_requests(np, cfg)
    if args.tree:  # another commit's default engine
        engines, turns = {"default": serving["auto"]}, ("default", "default")
    else:
        # the serving engine's twin: sibling() keeps the cache, not the rows
        eager = serving["auto"].sibling(decode_impl="eager", batch_size=cs.SERVE_ROWS,
                                        rep_pen_window=BATCHED_REP_PEN_WINDOW,
                                        dynamic_sampling=True)
        engines, turns = {"graph": serving["auto"], "eager": eager}, TURNS
        g = engines["graph"]
        assert g.graphs is not None and eager.graphs is None
        assert (g.batch_size, g.dynamic_sampling, g.rep_pen_window, g.use_fused_slow,
                g.use_fused_fast) == (eager.batch_size, eager.dynamic_sampling,
                                      eager.rep_pen_window, eager.use_fused_slow,
                                      eager.use_fused_fast)
    sampling = SamplingArgs(**cs.SAMPLING)
    got = {}

    def record(path, mode, **numbers):
        got.setdefault(path, {}).setdefault(mode, []).append(numbers)
        print(f"ab {path} {mode}: " + ", ".join(f"{k} {v:.4f}" for k, v in numbers.items())
              + f" [{smi}]", flush=True)

    paths = args.paths.split(",")

    def fish_paths(suffix=""):
        for mode in turns if "serving" in paths else ():
            _, fps, p50 = cs.serving_run(torch, np, engines[mode], loud, tok, codec_cfg, reqs,
                                         f"ab {mode}")
            record("serving" + suffix, mode, frames_per_s=fps, rtf_p50=p50)
        for mode in turns if "central" in paths else ():
            fps, p50, *ttfa = cs.central_run(torch, np, engines[mode], loud, loud32, tok,
                                             codec_cfg, reqs, bound16, f"ab central {mode}")
            record("central" + suffix, mode, pcm_frames_per_s=fps, rtf_p50=p50,
                   **({"ttfa_p50": ttfa[0]} if ttfa else {}))

    fish_paths()
    if args.tree:
        print(json.dumps({"serving_graph_ab": got, "tree": args.tree, "card": smi}), flush=True)
        return 0
    for mode in TURNS if "server" in paths else ():
        _, m = cs.run_server(torch, np, params, cfg, tok, loud, codec_cfg, bound16, smi,
                             decode_impl=mode)
        record("server", mode, **m)

    if "dual_ar" in paths:
        vcfg, lm, tokenizer, vtok, _ = cs.version_setup("dual_ar")
        vparams = cs.version_params(torch, vcfg, vtok, "cuda")
        mimi, _ = cs.version_mimi(torch, np, smi)
        for mode in DUAL_AR_TURNS:
            engine = LMEngine(vparams, vcfg, vtok, lm, cache_len=cs.SERVE_CACHE,
                              max_frames=cs.VERSION_FRAMES, prompt_buckets=cs.SERVER_BUCKETS,
                              decode_impl=mode)
            pipeline = TTSPipeline(engine, mimi, tokenizer, lm, max_new_tokens=cs.VERSION_FRAMES,
                                   default_sampling=sampling)
            pipeline.reroll_on_runaway = False
            batcher = pipeline.create_batcher(cs.SERVE_ROWS, cs.SERVE_HORIZON)
            batcher.warmup()
            pipeline.warmup_codec(cs.SERVE_HORIZON)
            try:
                fps, p50, _ = cs.version_serving(torch, np, pipeline, batcher, mimi, cs.MIMI_TOL,
                                                 f"ab DualAR {mode}", mimi.cfg.frame_rate)
            finally:
                batcher.shutdown()
            record("dual_ar", mode, frames_per_s=fps, rtf_p50=p50)
        del vparams, mimi

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        engines["graph"].decode_chunk(engines["graph"].init_state(0), sampling,
                                      cs.SERVE_HORIZON)
        torch.cuda.synchronize()
    fish_paths(" after a torch.profiler session")

    means = {path: {mode: {k: float(np.mean([r[k] for r in runs])) for k in runs[0]}
                    for mode, runs in modes.items()}
             for path, modes in got.items()}
    print(json.dumps({"serving_graph_ab": means, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
