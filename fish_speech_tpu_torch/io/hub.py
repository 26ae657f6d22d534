"""Checkpoint resolution for a local directory.

The port's counterpart of `fish_speech_tpu/io/hub.py`, without the
fetch: an existing directory is used as it is; anything else raises a
`ValueError` that names the version's pinned Hub repo, to download by
hand. The repo and file names stay here as data, for those messages.
"""

from __future__ import annotations

from pathlib import Path

from fish_speech_tpu_torch.config import WhichModel

HUB_REPOS = {
    WhichModel.FISH_1_2: "fishaudio/fish-speech-1.2-sft",
    WhichModel.FISH_1_4: "jkeisling/fish-speech-1.4",
    WhichModel.FISH_1_5: "jkeisling/fish-speech-1.5",
    WhichModel.DUAL_AR: "jkeisling/smoltts_v0",
}

# The Firefly codec's weights file in each model repo.
_CODEC_FILES = {
    WhichModel.FISH_1_2: "firefly-gan-vq-fsq-4x1024-42hz-generator-merged.pth",
    WhichModel.FISH_1_4: "firefly-gan-vq-fsq-8x1024-21hz-generator.safetensors",
    WhichModel.FISH_1_5: "firefly-gan-vq-fsq-8x1024-21hz-generator.safetensors",
}


def resolve_checkpoint(checkpoint: str | Path, model: WhichModel) -> Path:
    """`checkpoint` as a local directory; the port does not fetch, so a
    repo id, an empty string or a missing path raises, naming what to
    download."""
    p = Path(checkpoint) if checkpoint else None
    if p is not None and p.is_dir():
        return p
    repo = str(checkpoint) if checkpoint else HUB_REPOS[model]
    weights = "model.pth" if model == WhichModel.FISH_1_2 else "model.safetensors"
    files = ["config.json", "tokenizer.json", weights]
    if model in _CODEC_FILES:
        files.append(_CODEC_FILES[model])
    raise ValueError(
        f"{checkpoint!r} is not a local directory, and the port does not fetch checkpoints: "
        f"download {', '.join(files)} of {repo} (the pinned repo for {model.value} is "
        f"{HUB_REPOS[model]}) into a directory and pass its path")
