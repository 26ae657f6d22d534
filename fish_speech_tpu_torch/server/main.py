"""Server entry point, on one card.

Counterpart of `fish_speech_tpu/server/main.py`, with its flags but the
mesh and multi-host ones, and `--device` (cuda by default; without a card
it raises unless `--device cpu` is given):

  python -m fish_speech_tpu_torch.server.main --checkpoint <dir> \\
      --fish-version 1.5 --voice-dir ./voices --port 3000 \\
      --continuous-batch 16 --warmup

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


def build_state(args: argparse.Namespace) -> AppState:
    """The pipeline, voices and batcher the flags ask for, warmed with
    --warmup."""
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
                                quantize_int8=quantize_int8, device=device)
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


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # the kernel library under $FISH_TPU_CACHE_DIR, when set: a restart
    # loads it instead of building it
    from fish_speech_tpu_torch.utils.cache import setup_compilation_cache

    setup_compilation_cache()
    state = build_state(args)  # no card and no --device cpu: raises before loading
    from fish_speech_tpu_torch.server.app import serve

    serve(state, port=args.port)


if __name__ == "__main__":
    main()
