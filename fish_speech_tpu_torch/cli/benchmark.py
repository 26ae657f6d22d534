"""In-process serving benchmark: the server's pipeline, three scenarios.

Counterpart of `fish_speech_tpu/cli/benchmark.py`: one unbatched request,
one batch_size=1 request and one batch_size=4 request, after a warm-up of
each path, with wall time, audio seconds and RTF.

    python -m fish_speech_tpu_torch.cli.benchmark --checkpoint <dir> \\
        --fish-version 1.5 [--text "..."] [--device cuda]

With --random-weights (or no --checkpoint) it runs random weights at the
Fish-1.5 architecture (bf16 LM, seed 0, the <|im_end|> head column zeroed
and the runaway reroll off, so every run decodes exactly
--max-new-tokens frames; float32 codec, seed 1) and a word-hash
tokenizer, which needs no tokenizer.json. The hash is crc32, where JAX
uses Python's salted hash(), so the prompts are the same in every run.
"""

from __future__ import annotations

import argparse
import sys
import time
import types
import zlib

import torch

DEFAULT_TEXT = (
    "Beneath the golden rooftops of a quiet mountain town, the morning "
    "market slowly came to life as vendors arranged baskets of fruit and "
    "fresh bread."
)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


class HashTokenizer:
    """Word-hash tokenizer with the ChatML specials at the ids of the
    random Fish-1.5 pipeline; it has what PromptEncoder calls."""

    SPECIALS = {"<|im_start|>": 100007, "<|im_end|>": 100011, "<|semantic|>": 5,
                "<|voice|>": 100010, "<|semantic:0|>": 100012}

    def token_to_id(self, token):
        return self.SPECIALS.get(token)

    def encode(self, text, add_special_tokens=True):
        ids, i = [], 0
        while i < len(text):
            special = next((sp for sp in self.SPECIALS if text.startswith(sp, i)), None)
            if special is not None:
                ids.append(self.SPECIALS[special])
                i += len(special)
                continue
            j = i
            while j < len(text) and not text.startswith("<|", j):
                j += 1
            ids.extend(1000 + zlib.crc32(w.encode()) % 90000 for w in text[i:j].split())
            i = j
        return types.SimpleNamespace(ids=ids)


def _load_random_pipeline(device="cuda"):
    """The random-weight Fish-1.5 pipeline."""
    from fish_speech_tpu_torch.config import (
        DualARConfig, FireflyConfig, FishVersion, TokenConfig, WhichLM)
    from fish_speech_tpu_torch.device import resolve_device
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec, init_firefly_params
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params
    from fish_speech_tpu_torch.pipeline import TTSPipeline

    device = resolve_device(device)
    cfg = DualARConfig.fish_speech_1_5()
    codec_cfg = FireflyConfig.for_version(FishVersion.V1_5)
    tok = TokenConfig(im_end_id=100011, pad_id=5, semantic_start_id=100012,
                      semantic_end_id=100012 + cfg.codebook_size - 1)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params = init_dual_ar_params(cfg, seed=0, dtype=dtype, device=device)
    params["output"][:, tok.im_end_id] = 0  # untrained weights never stop early
    codec = FireflyCodec(init_firefly_params(codec_cfg, seed=1, dtype=torch.float32,
                                             device=device), codec_cfg, device=device)
    engine = LMEngine(params, cfg, tok, WhichLM.FISH_1_5, cache_len=2048, dtype=dtype,
                      device=device)
    pipe = TTSPipeline(engine, codec, HashTokenizer(), WhichLM.FISH_1_5)
    pipe.reroll_on_runaway = False  # fixed-length generations
    return pipe


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--fish-version", default="1.5")
    ap.add_argument("--text", default=DEFAULT_TEXT)
    ap.add_argument("--random-weights", action="store_true")
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.random_weights or args.checkpoint is None:
        log("loading random-weight Fish-1.5-architecture pipeline")
        pipeline = _load_random_pipeline(args.device)
    else:
        from fish_speech_tpu_torch.config import WhichModel
        from fish_speech_tpu_torch.pipeline import TTSPipeline

        pipeline = TTSPipeline.load(args.checkpoint, WhichModel(args.fish_version),
                                    device=args.device)
    kwargs = dict(max_new_tokens=args.max_new_tokens, seed=0)

    def run(label, fn):
        t0 = time.perf_counter()
        try:
            pcm = fn()
        except RuntimeError as e:
            log(f"{label}: FAILED ({e})")
            return
        wall = time.perf_counter() - t0
        audio_s = len(pcm) / pipeline.codec.sample_rate
        log(f"{label}: wall {wall:.2f}s, audio {audio_s:.2f}s, "
            f"RTF {wall / max(audio_s, 1e-9):.4f}")

    # warm-up, excluded from the timings, like a warmed server
    log("warmup...")
    t0 = time.perf_counter()
    for warm in (lambda: pipeline.synthesize(args.text, **kwargs),
                 lambda: pipeline.synthesize_batched(args.text, 4, **kwargs)):
        try:
            warm()
        except RuntimeError:
            pass
    log(f"warmup: {time.perf_counter() - t0:.1f}s")
    run("unbatched", lambda: pipeline.synthesize(args.text, **kwargs))
    run("batch_size=1", lambda: pipeline.synthesize_batched(args.text, 1, **kwargs))
    run("batch_size=4", lambda: pipeline.synthesize_batched(args.text, 4, **kwargs))
    log(f"frame rate: {pipeline.codec.cfg.frame_rate:.3f} Hz")


if __name__ == "__main__":
    main()
