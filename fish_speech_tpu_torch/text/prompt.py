"""ChatML prompt assembly with codec-token conditioning.

The port's own copy of the JAX package's `text/prompt.py`. Every output
is a (num_codebooks + 1, N) int32 numpy array: row 0 is the text /
semantic vocab row, rows 1.. the codebook rows (zero under text). The
version quirks are kept:

* Fish 1.5 / DualAR: the semantic row carries `<|semantic:code|>` vocab
  ids (semantic_start + code); the 1.5 assistant prefix gains
  `<|voice|>`.
* Fish <= 1.4: the semantic row is all `<|semantic|>` (pad) and the
  codebook tokens are stored + 1; generated codes are shifted - 1 later.

The tokenizer is duck-typed: anything with `encode(text,
add_special_tokens=False).ids` and `token_to_id(str)` (a
`tokenizers.Tokenizer`, or a stand-in that needs no package).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from fish_speech_tpu_torch.config import WhichLM

# The system prompt Fish 1.5 generation is conditioned on.
FISH_1_5_SYSPROMPT = "Speak out the provided text."


class PromptEncoder:
    def __init__(self, tokenizer, num_codebooks: int, lm: WhichLM) -> None:
        self.tokenizer = tokenizer
        self.num_codebooks = num_codebooks
        self.lm = lm

    def _tokenize_text(self, text: str) -> np.ndarray:
        ids = self.tokenizer.encode(text, add_special_tokens=False).ids
        out = np.zeros((self.num_codebooks + 1, len(ids)), np.int32)
        out[0] = ids
        return out

    def encode_text(self, role: str, content: Optional[str] = None) -> np.ndarray:
        if content is not None:
            s = f"<|im_start|>{role}\n{content}<|im_end|>"
        else:
            s = f"<|im_start|>{role}\n"
        return self._tokenize_text(s)

    def encode_vq(self, prompt_tokens: Optional[np.ndarray] = None) -> np.ndarray:
        """The assistant turn around codec tokens (num_codebooks, T); with
        none, the bare assistant prefix."""
        voice = "<|voice|>" if self.lm == WhichLM.FISH_1_5 else ""
        prefix = self._tokenize_text(f"<|im_start|>assistant\n{voice}")
        if prompt_tokens is None:
            return prefix
        suffix = self._tokenize_text("<|im_end|>")

        prompt_tokens = np.asarray(prompt_tokens, dtype=np.int32)
        if prompt_tokens.shape[0] != self.num_codebooks:
            raise ValueError(
                f"Expected {self.num_codebooks} codebooks, got {prompt_tokens.shape[0]}")
        seqlen = prompt_tokens.shape[1]

        if self.lm.uses_explicit_semantic_ids:
            semantic_start = self.tokenizer.token_to_id("<|semantic:0|>")
            semantic_row = semantic_start + prompt_tokens[0]
            codebook_rows = prompt_tokens
        else:
            semantic_id = self.tokenizer.token_to_id("<|semantic|>")
            if semantic_id is None:
                semantic_id = 5
            semantic_row = np.full((seqlen,), semantic_id, np.int32)
            codebook_rows = prompt_tokens + 1  # the <= 1.4 quirk

        vq_span = np.concatenate([semantic_row[None], codebook_rows], axis=0)
        return np.concatenate([prefix, vq_span, suffix], axis=1)

    def encode_conditioning_prompt(self, prompt_text: str,
                                   prompt_tokens: np.ndarray) -> np.ndarray:
        """A user turn with the transcript, then the assistant VQ turn."""
        return np.concatenate(
            [self.encode_text("user", prompt_text), self.encode_vq(prompt_tokens)], axis=1)

    def encode_sequence(
        self,
        chunks: List[str],
        sysprompt_text: Optional[str] = None,
        cached_speaker: Optional[np.ndarray] = None,
        assume_kv_cache: bool = False,
    ) -> Tuple[int, List[np.ndarray]]:
        """(number of conditioning tokens, one encoded prompt a chunk).
        With assume_kv_cache the conditioning (system prompt + speaker)
        prefixes only the first chunk; later chunks rely on the cache
        prefix kept by `rewind`."""
        if not chunks:
            raise ValueError("Input text cannot be empty")

        sysprompt = (self.encode_text("system", sysprompt_text)
                     if sysprompt_text is not None else None)
        parts = [p for p in (sysprompt, cached_speaker) if p is not None]
        conditioning = np.concatenate(parts, axis=1).astype(np.int32) if parts else None
        n_conditioning = conditioning.shape[1] if conditioning is not None else 0

        assistant_start = self.encode_vq(None)
        encoded = []
        for i, chunk in enumerate(chunks):
            prompt_parts = []
            if conditioning is not None and (i == 0 or not assume_kv_cache):
                prompt_parts.append(conditioning)
            prompt_parts.append(self.encode_text("user", chunk))
            prompt_parts.append(assistant_start)
            encoded.append(np.concatenate(prompt_parts, axis=1))
        return n_conditioning, encoded


def load_prompt_tokens(path: str | Path, num_codebooks: int) -> np.ndarray:
    """Speaker codec tokens from a .npy, (num_codebooks, T) or
    (1, num_codebooks, T), as int32."""
    arr = np.load(path)
    if arr.ndim == 3 and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim != 2:
        raise ValueError(f"Incorrect prompt token dimensions for {path}: {arr.ndim}")
    if arr.shape[0] != num_codebooks:
        raise ValueError(f"Expected {num_codebooks} codebooks but got {arr.shape[0]}")
    return arr.astype(np.int32)
