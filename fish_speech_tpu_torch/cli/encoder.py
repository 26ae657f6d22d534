"""wav -> codec tokens .npy (voice cloning / speaker prompts), on the card.

The port's counterpart of `fish_speech_tpu/cli/encoder.py`, with its
flags, formats and prints, and `--device` (default cuda). The encode
runs in float32 with TF32 off (`FireflyCodec.encode`).

Usage:
  python -m fish_speech_tpu_torch.cli.encoder --input ref.wav --checkpoint \\
      checkpoints/fish-speech-1.5 --fish-version 1.5 --out-path codes.npy
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from fish_speech_tpu_torch.audio.resample import resample
from fish_speech_tpu_torch.audio.wav import read_wav
from fish_speech_tpu_torch.cli.vocoder import load_codec
from fish_speech_tpu_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="wav -> codec tokens (.npy)")
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--fish-version", default="1.5", choices=["1.2", "1.4", "1.5"])
    p.add_argument("--out-path", "-o", default="codes.npy")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    codec = load_codec(args.checkpoint, args.fish_version, device)
    print(f"Codec loaded in {time.perf_counter() - t0:.1f}s")

    audio, sr = read_wav(args.input)
    audio = resample(audio, sr, codec.sample_rate)
    duration = audio.shape[-1] / codec.sample_rate
    t0 = time.perf_counter()
    codes = codec.encode(audio)[0]
    dt = time.perf_counter() - t0
    print(f"Encoded {duration:.2f}s of audio to {codes.shape} tokens in {dt:.2f}s "
          f"(RTF {duration / dt:.1f}x, frame rate {codec.cfg.frame_rate:.3f} Hz)")
    np.save(args.out_path, codes.astype(np.uint32))
    print(f"Wrote {args.out_path}")


if __name__ == "__main__":
    main()
