"""codec tokens .npy -> wav, on the card.

The port's counterpart of `fish_speech_tpu/cli/vocoder.py`, with its
flags, formats and prints, and `--device` (default cuda).

Usage:
  python -m fish_speech_tpu_torch.cli.vocoder --input codes.npy --checkpoint \\
      checkpoints/fish-speech-1.5 --fish-version 1.5 --out-path out.wav
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from fish_speech_tpu_torch.audio.wav import write_pcm_as_wav
from fish_speech_tpu_torch.config import FireflyConfig, WhichModel
from fish_speech_tpu_torch.device import resolve_device
from fish_speech_tpu_torch.io.checkpoint import load_firefly_params
from fish_speech_tpu_torch.io.hub import resolve_checkpoint
from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="codec tokens (.npy) -> wav")
    p.add_argument("--input", "-i", default="out.npy")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--fish-version", default="1.5", choices=["1.2", "1.4", "1.5"])
    p.add_argument("--out-path", "-o", default="fish_speech.wav")
    p.add_argument("--bf16", action="store_true", help="run the vocoder in bfloat16")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def load_codec(checkpoint, fish_version: str, device, dtype=torch.float32) -> FireflyCodec:
    """The version's Firefly codec from a weights file or a local
    directory (anything else raises: the port does not fetch)."""
    model = WhichModel(fish_version)
    cfg = FireflyConfig.for_version(model.fish_version)
    if not Path(checkpoint).is_file():
        checkpoint = resolve_checkpoint(checkpoint, model)
    params = load_firefly_params(checkpoint, cfg, dtype=dtype, device=device)
    return FireflyCodec(params, cfg, device=device)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    codec = load_codec(args.checkpoint, args.fish_version, device,
                       torch.bfloat16 if args.bf16 else torch.float32)
    print(f"Codec loaded in {time.perf_counter() - t0:.1f}s")

    codes = np.load(args.input)
    if codes.ndim == 3:
        codes = codes[0]
    t0 = time.perf_counter()
    audio = codec.decode(codes.astype(np.int32))[0]
    dt = time.perf_counter() - t0
    duration = audio.shape[-1] / codec.sample_rate
    print(f"Decoded {codes.shape} tokens to {duration:.2f}s of audio in {dt:.2f}s "
          f"(RTF {duration / dt:.1f}x)")
    with open(args.out_path, "wb") as f:
        write_pcm_as_wav(f, np.asarray(audio, np.float32), codec.sample_rate)
    print(f"Wrote {args.out_path}")


if __name__ == "__main__":
    main()
