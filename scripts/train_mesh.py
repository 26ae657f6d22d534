#!/usr/bin/env python3
"""Finetuning under a mesh on one NVIDIA GPU, alone: `chip_smoke.py`'s
train worlds (`train_mesh`) without the rest of the smoke and without
the kernel library, which this path does not run.

    python3 scripts/train_mesh.py

Fish-1.5 at full width in float32 with TF32 off, random weights from a
seed: (a) a world of one rank on nccl, bit for bit the unsharded step;
(b) tp = 2 and (c) dp = 2 over gloo, two ranks sharing the card, against
the unsharded step; (d) at 2 slow layers, a snapshot at tp = 2 resumed at
tp = 2 (bit for bit), at dp = 2 and on one device. Each world logs its
seconds a step, collectives and bytes a step, peak allocation a rank and
rank 0's seconds in each phase, beside the card's name and power limit.
Exits non-zero where a check fails.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from fish_speech_tpu_torch.config import DualARConfig, TokenConfig

    if not torch.cuda.is_available():
        print("train_mesh: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DualARConfig.fish_speech_1_5()
    tok = TokenConfig(im_end_id=100011, pad_id=5, semantic_start_id=100012,
                      semantic_end_id=100012 + cfg.codebook_size - 1)
    with tempfile.TemporaryDirectory() as d:
        chip_smoke.train_mesh(torch, np, cfg, tok, Path(d), chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
