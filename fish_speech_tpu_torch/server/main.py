"""Server entry point.

Counterpart of `fish_speech_tpu/server/main.py`, with its flags, and
`--device` (cuda by default; without a card it raises unless `--device
cpu` is given) and `--backend`:

  python -m fish_speech_tpu_torch.server.main --checkpoint <dir> \\
      --fish-version 1.5 --voice-dir ./voices --port 3000 \\
      --continuous-batch 16 --warmup

`main` first joins the world that FISH_TPU_COORDINATOR /
FISH_TPU_NUM_PROCESSES / FISH_TPU_PROCESS_ID describe, with
FISH_TPU_LOCAL_NUM_PROCESSES / FISH_TPU_LOCAL_PROCESS_ID where it spans
hosts (a no-op without them), as JAX's does. `--shard N` shards the LM
over a (dp, tp) mesh of N ranks, `--tp` wide (`parallel/`): with no
coordinator set, this process becomes rank 0 and starts ranks 1..N-1 on
this host, the counterpart of JAX's one process over N local devices;
with one set, a cluster's launcher started every rank with the
variables, on one host or several, and `--shard` must equal the world's
rank count. Global rank 0 serves HTTP; the other ranks follow its engine
calls until it stops. NCCL takes a card a rank; ranks that share a card
take `--backend gloo`.

`--warmup` runs, before serving, what a first request would otherwise
pay for (PyTorch builds no program per shape, so this is cuDNN's and
cuBLAS's first calls and the CUDA kernels' build): the serial engine's
prefill at each prompt bucket a voice's first chunk reaches and at each
voice's conditioning offset (chunk 2+ prefills there), its decode chunk of
16 frames, the codec's shapes (`TTSPipeline.warmup_codec`), and, with a
batcher, the batcher engine's prefills at the same buckets and offsets
and one request through the scheduler and the central vocoder
(`ContinuousBatcher.warmup`, which takes no conditioning lengths).
"""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys
from typing import List, Optional, Tuple

import torch

from fish_speech_tpu_torch.config import (
    DEFAULT_MAX_NEW_TOKENS, DEFAULT_TEMP, DEFAULT_TOP_K, DEFAULT_TOP_P, WhichLM, WhichModel,
    default_rep_pen)
from fish_speech_tpu_torch.device import resolve_device
from fish_speech_tpu_torch.ops.sampling import SamplingArgs
from fish_speech_tpu_torch.pipeline import TTSPipeline
from fish_speech_tpu_torch.server.core import AppState
from fish_speech_tpu_torch.server.voices import load_speaker_prompts
from fish_speech_tpu_torch.text.prompt import FISH_1_5_SYSPROMPT


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="fish_speech_tpu_torch server")
    p.add_argument("--checkpoint", default="", help="a local checkpoint directory")
    p.add_argument("--fish-version", default="1.5", choices=["1.2", "1.4", "1.5", "dual_ar"])
    p.add_argument("--voice-dir", default="voices")
    p.add_argument("--persist-voices", action="store_true",
                   help="write voices registered by /v1/audio/encoding?id=&prompt= into "
                        "--voice-dir (npy + index.json)")
    p.add_argument("--port", type=int, default=3000)
    p.add_argument("--temp", type=float, default=DEFAULT_TEMP)
    p.add_argument("--top-p", type=float, default=DEFAULT_TOP_P)
    p.add_argument("--top-k", type=int, default=DEFAULT_TOP_K)
    p.add_argument("--rep-pen", type=float, default=None)
    p.add_argument("--max-new-tokens", type=int, default=DEFAULT_MAX_NEW_TOKENS)
    p.add_argument("--quantize-int8", action=argparse.BooleanOptionalAction, default=None,
                   help="weight-only int8 LM stacks; unset: the packaged decision file "
                        "(utils/int8_policy.py)")
    p.add_argument("--warmup", action="store_true",
                   help="run the serving shapes once before serving")
    p.add_argument("--continuous-batch", type=int, default=0, metavar="ROWS",
                   help="decode this many concurrent requests through shared batch rows "
                        "(0: one request at a time)")
    p.add_argument("--shard", type=int, default=0, metavar="N_DEVICES",
                   help="shard the LM over a (dp, tp) mesh of this many devices "
                        "(0 = single device, the reference's only mode); combine with "
                        "--tp to set the tensor-parallel width")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width within --shard devices (must divide "
                        "the GQA KV-head count; 2 for the stock Fish models)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="the ranks' collectives (default: nccl with CUDA, gloo on the CPU; "
                        "ranks sharing a card take gloo)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def warmup_shapes(pipeline: TTSPipeline, voices) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(prompt buckets, conditioning offsets) a request's prefills reach:
    the bucket of each voice's first prompt (its conditioning and a short
    text) and of a later chunk, and each voice's conditioning length."""
    from fish_speech_tpu_torch.generate.engine import _bucket_for

    engine = pipeline.engine
    sysprompt = FISH_1_5_SYSPROMPT if pipeline.lm == WhichLM.FISH_1_5 else None
    buckets, lens = set(), {0}
    for voice in [None, *voices.values()]:
        n_cond, encoded = pipeline.prompt_encoder.encode_sequence(
            ["warmup", "warmup"], sysprompt_text=sysprompt, cached_speaker=voice,
            assume_kv_cache=True)
        lens.add(n_cond)
        for prompt in encoded:
            buckets.add(_bucket_for(prompt.shape[-1], engine.prompt_buckets))
    return tuple(sorted(buckets)), tuple(sorted(lens))


def build_state(args: argparse.Namespace, mesh=None) -> Optional[AppState]:
    """The pipeline, voices and batcher the flags ask for, warmed with
    --warmup. mesh: the (dp, tp) mesh the LM is sharded over; every rank
    calls this, and the ranks but rank 0 follow rank 0's engine calls in
    here until it closes its pipeline, then get None."""
    device = resolve_device(args.device)
    model = WhichModel(args.fish_version)
    quantize_int8 = args.quantize_int8
    if quantize_int8 is None:
        from fish_speech_tpu_torch.utils.int8_policy import serving_default_int8

        quantize_int8 = serving_default_int8()
        logging.info("int8 serving default from the decision file: %s",
                     "int8" if quantize_int8 else "bf16")
    lm_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    pipeline = TTSPipeline.load(args.checkpoint, model, lm_dtype=lm_dtype,
                                codec_dtype=torch.float32, max_new_tokens=args.max_new_tokens,
                                quantize_int8=quantize_int8, device=device, mesh=mesh)
    if pipeline is None:
        return None
    pipeline.default_sampling = SamplingArgs(
        temp=args.temp, top_p=args.top_p, top_k=args.top_k,
        repetition_penalty=args.rep_pen if args.rep_pen is not None
        else default_rep_pen(pipeline.lm))
    voices, default_voice = load_speaker_prompts(args.voice_dir, pipeline.prompt_encoder,
                                                 pipeline.engine.cfg.num_codebooks)
    batcher = (pipeline.create_batcher(args.continuous_batch) if args.continuous_batch > 0
               else None)
    if args.warmup:
        buckets, cond_lens = warmup_shapes(pipeline, voices)
        logging.info("warmup: prompt buckets %s at conditioning offsets %s", buckets, cond_lens)
        pipeline.engine.warmup(pipeline.default_sampling, buckets=buckets,
                               conditioning_lens=cond_lens, chunk_horizons=(16,))
        pipeline.warmup_codec()
        if batcher is not None:
            batcher.engine.warmup(pipeline.default_sampling, buckets=buckets,
                                  conditioning_lens=cond_lens)
            batcher.warmup()
    state = AppState(pipeline, voices, default_voice, batcher=batcher)
    if args.persist_voices:
        state.persist_voice_dir = args.voice_dir
    return state


def launch_ranks(n: int, argv: List[str]) -> Tuple[str, List[subprocess.Popen]]:
    """Start ranks 1..n-1 of a world on this host, each this server with
    `argv` and the FISH_TPU_* variables of its rank; returns the
    coordinator's address and the processes."""
    from fish_speech_tpu_torch.parallel import distributed as dist

    return dist.launch_ranks(n, "fish_speech_tpu_torch.server.main", argv)


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from fish_speech_tpu_torch.parallel import distributed as dist

    world = os.environ.get(dist.NUM_PROCESSES_ENV)
    if dist.COORDINATOR_ENV in os.environ and world is not None and int(world) != max(
            args.shard, 1):
        raise ValueError(f"--shard {args.shard} differs from the world's {world} ranks "
                         f"({dist.NUM_PROCESSES_ENV}): every rank a launcher starts serves a "
                         "shard of one mesh over the whole world")
    address, procs = None, []
    if args.shard > 1 and dist.COORDINATOR_ENV not in os.environ:
        address, procs = launch_ranks(args.shard, argv)
    try:
        if address is not None:
            dist.initialize_distributed(address, args.shard, 0, backend=args.backend)
        else:
            dist.initialize_distributed(backend=args.backend)
        # the kernel library under $FISH_TPU_CACHE_DIR, when set: a restart
        # loads it instead of building it
        from fish_speech_tpu_torch.utils.cache import setup_compilation_cache

        setup_compilation_cache()
        mesh = dist.global_mesh(args.tp) if args.shard > 1 else None
        # no card and no --device cpu: raises before loading
        state = build_state(args, mesh)
        if state is None:
            return  # a rank past 0: rank 0 has stopped
        from fish_speech_tpu_torch.server.app import serve

        try:
            serve(state, port=args.port)
        finally:
            state.pipeline.close()
    finally:
        dist.wait_ranks(procs)


if __name__ == "__main__":
    main()
