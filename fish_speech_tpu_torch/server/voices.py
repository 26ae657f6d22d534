"""Voice registry: speaker-conditioning prompts encoded at start-up.

Counterpart of `fish_speech_tpu/server/voices.py`, the voices-template
format: a directory with index.json ({"speakers": {name: prompt_text}})
and a <name>.npy of codec tokens a speaker. Each voice is encoded to a
whole conditioning prompt; a "default" voice is required.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from fish_speech_tpu_torch.text.prompt import PromptEncoder, load_prompt_tokens


def load_speaker_prompts(voice_dir: str | Path, prompt_encoder: PromptEncoder,
                         num_codebooks: int) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """(voices: name -> (C+1, N) conditioning tokens, the default voice)."""
    voice_dir = Path(voice_dir)
    with open(voice_dir / "index.json") as f:
        speakers: Dict[str, str] = json.load(f)["speakers"]
    voices = {name: prompt_encoder.encode_conditioning_prompt(
        text, load_prompt_tokens(voice_dir / f"{name}.npy", num_codebooks))
        for name, text in speakers.items()}
    if "default" not in voices:
        raise ValueError(f"Voice directory {voice_dir} must contain a 'default' speaker")
    return voices, voices["default"]


def save_voice(voice_dir: str | Path, name: str, prompt_text: str, codes: np.ndarray) -> None:
    """Persist a voice registered at run time: <name>.npy (uint32) and its
    entry in index.json (written to a temporary file, then renamed)."""
    voice_dir = Path(voice_dir)
    voice_dir.mkdir(parents=True, exist_ok=True)
    np.save(voice_dir / f"{name}.npy", np.asarray(codes, np.uint32))
    index_path = voice_dir / "index.json"
    index = {"speakers": {}}
    if index_path.exists():
        with open(index_path) as f:
            index = json.load(f)
    index.setdefault("speakers", {})[name] = prompt_text
    tmp = index_path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(index, indent=2) + "\n")
    tmp.replace(index_path)
