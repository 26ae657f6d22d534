"""User-facing Python API: `LM` and `FireflyCodec`.

Counterpart of `fish_speech_tpu/api.py`, with its constructors and calls
(device and dtype strings, the same sampling defaults):

    from fish_speech_tpu_torch.api import LM, FireflyCodec
    lm = LM("checkpoints/fish-speech-1.5", version="1.5", dtype="bf16")
    codec = FireflyCodec("checkpoints/fish-speech-1.5", version="1.5")
    codes = lm(["Hello world."], speaker_prompt=prompt)   # (1, C, T) uint32
    pcm = codec.decode(codes)                              # (1, 1, T * 2048)

`device` is "cuda" by default (without a card the constructors raise;
"cpu" runs the plain versions of the kernels). On CUDA the LM takes
"bf16" only, as the port's kernels do.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from fish_speech_tpu_torch.config import FireflyConfig, TokenConfig, WhichLM, WhichModel
from fish_speech_tpu_torch.device import resolve_device
from fish_speech_tpu_torch.generate.engine import LMEngine
from fish_speech_tpu_torch.io.checkpoint import load_firefly_params, load_lm_params
from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec as _Codec
from fish_speech_tpu_torch.ops.sampling import SamplingArgs
from fish_speech_tpu_torch.text.prompt import PromptEncoder


def _dtype_of(dtype: str) -> torch.dtype:
    if dtype == "bf16":
        return torch.bfloat16
    if dtype == "f32":
        return torch.float32
    raise ValueError(f"Unsupported dtype: {dtype}")


class LM:
    """Text -> codebook tokens."""

    def __init__(self, dir: str | Path, version: str = "1.5", device: str = "cuda",
                 dtype: str = "bf16") -> None:
        from fish_speech_tpu_torch.cli.llama_generate import load_config, load_tokenizer

        device = resolve_device(device)
        dir = Path(dir)
        model = WhichModel(version)
        self.lm_type = WhichLM.from_model(model)
        self.cfg = load_config(dir, model)
        self.tokenizer = load_tokenizer(dir / "tokenizer.json")
        token_cfg = TokenConfig.from_tokenizer(self.lm_type, self.tokenizer, self.cfg)
        params = load_lm_params(dir, self.cfg, dtype=_dtype_of(dtype), device=device)
        self.engine = LMEngine(params, self.cfg, token_cfg, self.lm_type,
                               dtype=_dtype_of(dtype), device=device)
        self.prompt_encoder = PromptEncoder(self.tokenizer, self.cfg.num_codebooks, self.lm_type)

    def __call__(self, input: List[str], sysprompt: Optional[str] = "Speak out the provided text",
                 speaker_prompt: Optional[np.ndarray] = None, temp: float = 0.7,
                 top_p: float = 0.9, top_k: int = 50, repetition_penalty: float = 1.2,
                 max_new_tokens: int = 1024, seed: Optional[int] = None) -> np.ndarray:
        """input: the text, chunked. speaker_prompt: a (1, C+1, T)
        conditioning prompt from create_speaker_prompt. Returns the
        codebook tokens, uint32 (1, C, frames), with no version shift."""
        speaker = None
        if speaker_prompt is not None:
            speaker = np.asarray(speaker_prompt)
            if speaker.ndim == 3:
                speaker = speaker[0]
        n_cond, prompts = self.prompt_encoder.encode_sequence(list(input), sysprompt, speaker,
                                                              assume_kv_cache=True)
        sampling = SamplingArgs(temp=temp, top_p=top_p, top_k=top_k,
                                repetition_penalty=repetition_penalty)
        state = self.engine.init_state(seed)
        outputs = []
        cond_len = 0
        for i, prompt in enumerate(prompts):
            offset = cond_len if i > 0 else 0
            result, state = self.engine.generate(prompt, max_new_tokens=max_new_tokens,
                                                 sampling=sampling, state=state,
                                                 conditioning_offset=offset)
            if i == 0:
                cond_len = n_cond
            state = self.engine.rewind(state, cond_len)
            outputs.append(result.tokens)
        return np.concatenate(outputs, axis=1)[None].astype(np.uint32)

    def create_speaker_prompt(self, input: List[Dict[str, np.ndarray]]) -> np.ndarray:
        """input: [{"text": str, "codes": uint32 (1, C, T)}]. Returns the
        conditioning prompt, (1, C+1, total) uint32."""
        if not input:
            raise ValueError("input is empty")
        prompts = []
        for sample in input:
            codes = np.asarray(sample["codes"])
            if codes.ndim == 3:
                codes = codes[0]
            prompts.append(self.prompt_encoder.encode_conditioning_prompt(sample["text"], codes))
        return np.concatenate(prompts, axis=1)[None].astype(np.uint32)


class FireflyCodec:
    """Audio <-> codes with the Firefly codec of a Fish version."""

    def __init__(self, dir: str | Path, version: str = "1.5", device: str = "cuda",
                 dtype: str = "f32") -> None:
        device = resolve_device(device)
        fish_version = WhichModel(version).fish_version
        if fish_version is None:
            raise ValueError(f"No Firefly codec for version {version}")
        cfg = FireflyConfig.for_version(fish_version)
        params = load_firefly_params(dir, cfg, dtype=_dtype_of(dtype), device=device)
        self._codec = _Codec(params, cfg, device=device)

    @property
    def sample_rate(self) -> int:
        return self._codec.sample_rate

    def encode(self, audio: np.ndarray) -> np.ndarray:
        """float32 (B, 1, T) or (B, T) PCM -> uint32 (B, C, T') codes."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 3:
            audio = audio.mean(axis=1)
        return self._codec.encode(audio).astype(np.uint32)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """uint32 (B, C, T) codes -> float32 (B, 1, T * samples_per_frame)."""
        codes = np.asarray(codes, np.int64).astype(np.int32)
        if codes.ndim == 2:
            codes = codes[None]
        return self._codec.decode(codes)[:, None, :]
