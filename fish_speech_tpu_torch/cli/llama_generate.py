"""text + speaker prompt -> semantic tokens .npy, on the card.

The port's counterpart of `fish_speech_tpu/cli/llama_generate.py`, with
its flags, defaults (temp 0.7, top-p 0.7, top-k 256, rep-pen 1.2, max
1024), .npy format and prints, and `--device` (default cuda; without a
card it raises, as the engine does; `--device cpu` runs the plain
versions of the kernels on the CPU).

Usage:
  python -m fish_speech_tpu_torch.cli.llama_generate \\
      --checkpoint checkpoints/fish-speech-1.5 --fish-version 1.5 \\
      --text "Hello world" --prompt-tokens voice.npy --prompt-text "..." \\
      --out-path out.npy

Two JAX behaviours are not copied: without a config.json the JAX CLI
loads every version with the Fish 1.2 config, where the port takes the
version's own (1.2 or 1.5; 1.4 and dual_ar need the file), and the
port's loader checks every tensor's shape against it.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from fish_speech_tpu_torch.config import (
    DualARConfig, FireflyConfig, TokenConfig, WhichLM, WhichModel)
from fish_speech_tpu_torch.device import resolve_device
from fish_speech_tpu_torch.generate.engine import LMEngine
from fish_speech_tpu_torch.io.checkpoint import load_lm_params
from fish_speech_tpu_torch.io.hub import resolve_checkpoint
from fish_speech_tpu_torch.ops.sampling import SamplingArgs
from fish_speech_tpu_torch.text.clean import preprocess_text
from fish_speech_tpu_torch.text.prompt import (
    FISH_1_5_SYSPROMPT, PromptEncoder, load_prompt_tokens)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="text -> semantic tokens (.npy)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--fish-version", default="1.5", choices=["1.2", "1.4", "1.5", "dual_ar"])
    p.add_argument("--text", required=True)
    p.add_argument("--prompt-tokens", action="append", default=[],
                   help=".npy speaker codec tokens (repeatable)")
    p.add_argument("--prompt-text", action="append", default=[],
                   help="transcript for each --prompt-tokens")
    p.add_argument("--out-path", default="out.npy")
    p.add_argument("--temp", type=float, default=0.7)
    p.add_argument("--top-p", type=float, default=0.7)
    p.add_argument("--top-k", type=int, default=256)
    p.add_argument("--repetition-penalty", type=float, default=1.2)
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def load_config(ckpt_dir: Path, model: WhichModel) -> DualARConfig:
    """The checkpoint's config.json, else the version's built-in config."""
    path = Path(ckpt_dir) / "config.json"
    if path.exists():
        return DualARConfig.from_json(path)
    if model == WhichModel.FISH_1_2:
        return DualARConfig.fish_speech_1_2()
    if model == WhichModel.FISH_1_5:
        return DualARConfig.fish_speech_1_5()
    raise FileNotFoundError(f"{path} is missing, and {model.value} has no built-in config")


def load_tokenizer(path: Path):
    """tokenizer.json through the `tokenizers` package, the one place the
    port needs it."""
    from tokenizers import Tokenizer

    return Tokenizer.from_file(str(path))


def frame_rate(lm: WhichLM) -> float:
    """Code frames a second of audio: 12.5 for DualAR (Mimi), else the
    version's Firefly rate."""
    if lm == WhichLM.DUAL_AR:
        return 12.5
    return FireflyConfig.for_version(lm.fish_version).frame_rate


def build_prompts(tokenizer, cfg: DualARConfig, lm: WhichLM,
                  args: argparse.Namespace) -> Tuple[int, List[np.ndarray]]:
    """(conditioning length, one prompt a text chunk): the 1.5 system
    prompt and the speaker turns prefix the first chunk only."""
    encoder = PromptEncoder(tokenizer, cfg.num_codebooks, lm)
    if len(args.prompt_tokens) != len(args.prompt_text):
        raise SystemExit("--prompt-tokens and --prompt-text must pair up")
    conditioning = [
        encoder.encode_conditioning_prompt(text, load_prompt_tokens(path, cfg.num_codebooks))
        for path, text in zip(args.prompt_tokens, args.prompt_text)
    ]
    if lm == WhichLM.FISH_1_5:
        conditioning.insert(0, encoder.encode_text("system", FISH_1_5_SYSPROMPT))
    speaker = np.concatenate(conditioning, axis=1) if conditioning else None
    return encoder.encode_sequence(preprocess_text(args.text), None, speaker,
                                   assume_kv_cache=True)


def generate_codes(tokenizer, engine: LMEngine, args: argparse.Namespace) -> np.ndarray:
    """The text's codes, (num_codebooks, T) uint32: chunk by chunk, the
    conditioning prefilled with the first chunk only, the cache rewound to
    it after each chunk and the later chunks prefilled behind it; Fish
    <= 1.4 codes shifted by -1."""
    lm = engine.lm
    n_cond, encoded = build_prompts(tokenizer, engine.cfg, lm, args)
    sampling = SamplingArgs(temp=args.temp, top_p=args.top_p, top_k=args.top_k,
                            repetition_penalty=args.repetition_penalty)
    rate = frame_rate(lm)
    state = engine.init_state(args.seed)
    all_codes = []
    cond_len = 0
    for i, chunk_tokens in enumerate(encoded):
        offset = cond_len if i > 0 else 0
        result, state = engine.generate(chunk_tokens, max_new_tokens=args.max_new_tokens,
                                        sampling=sampling, state=state,
                                        conditioning_offset=offset)
        if i == 0:
            cond_len = n_cond
        state = engine.rewind(state, cond_len)
        codes = result.tokens
        if not lm.uses_explicit_semantic_ids:
            codes = np.maximum(codes.astype(np.int64) - 1, 0)
        all_codes.append(codes)
        decode_s = max(result.decode_s, 1e-9)
        print(f"chunk {i}: {result.frames} frames, prefill {result.prefill_s * 1e3:.1f}ms, "
              f"decode {result.decode_s:.2f}s ({result.frames / decode_s:.1f} tokens/s, "
              f"RTF {(result.frames / rate) / decode_s:.3f})")
    return np.concatenate(all_codes, axis=1).astype(np.uint32)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    model = WhichModel(args.fish_version)
    lm = WhichLM.from_model(model)
    device = resolve_device(args.device)
    ckpt = resolve_checkpoint(args.checkpoint, model)
    cfg = load_config(ckpt, model)
    tokenizer = load_tokenizer(ckpt / "tokenizer.json")
    token_cfg = TokenConfig.from_tokenizer(lm, tokenizer, cfg)

    t0 = time.perf_counter()
    params = load_lm_params(ckpt, cfg, dtype=torch.bfloat16, device=device)
    engine = LMEngine(params, cfg, token_cfg, lm, dtype=torch.bfloat16, device=device)
    print(f"Model loaded in {time.perf_counter() - t0:.1f}s")

    out = generate_codes(tokenizer, engine, args)
    np.save(args.out_path, out)
    print(f"Wrote {out.shape} tokens to {args.out_path}")


if __name__ == "__main__":
    main()
