"""Text cleaning and script-aware chunking.

The port's own copy of the JAX package's `text/clean.py` (pure Python):
Unicode symbol normalisation, emoji stripping, punctuation collapsing,
CJK script detection, and sentence chunking with thresholds that grow
chunk by chunk (the first chunk is kept small for time to first audio).
Symbol replacements apply longest key first, in a fixed order.
"""

from __future__ import annotations

import enum
from typing import List, Tuple

SYMBOL_MAP = {
    "“": '"',
    "”": '"',
    "‘": "'",
    "’": "'",
    "…": "...",
    " « ": '"',
    " » ": '"',
    "«": '"',
    "»": '"',
    "​": "",
    "‌": "",
    "‍": "",
    "﻿": "",
    "。": ".",
    "、": ", ",
    "！": "!",
    "？": "?",
    "「": '"',
    "」": '"',
    "『": '"',
    "』": '"',
    "・": "",
    "：": ",",
    "；": ",",
    "（": "",
    "）": "",
    "【": "",
    "】": "",
}
_ORDERED_KEYS = sorted(SYMBOL_MAP, key=len, reverse=True)


class Script(enum.Enum):
    CHINESE = "chinese"
    JAPANESE = "japanese"
    KOREAN = "korean"
    LATIN = "latin"


def _thresholds(script: Script) -> Tuple[int, int]:
    """(combine_threshold, split_threshold)."""
    return {
        Script.CHINESE: (30, 100),
        Script.JAPANESE: (45, 150),
        Script.KOREAN: (40, 120),
        Script.LATIN: (150, 400),
    }[script]


def clean_text(text: str) -> str:
    """Normalise symbols, strip emoji, collapse punctuation and spaces."""
    result = text.strip()
    for key in _ORDERED_KEYS:
        result = result.replace(key, SYMBOL_MAP[key])
    # strip emoji (U+1F300..U+1F9FF)
    result = "".join(c for c in result if not (0x1F300 <= ord(c) <= 0x1F9FF))
    # dashes to em-dash
    result = result.replace(" - ", "—").replace("--", "—").replace(" – ", "—")
    # collapse repeated punctuation
    result = (
        result.replace("....", ".")
        .replace("...", ".")
        .replace("..", ".")
        .replace(",,", ",")
    )
    return " ".join(result.split())


def _is_hanzi(c: str) -> bool:
    return "一" <= c <= "鿿"


def _is_kana(c: str) -> bool:
    return "぀" <= c <= "ゟ" or "゠" <= c <= "ヿ"


def _is_hangul(c: str) -> bool:
    return "가" <= c <= "힯"


def detect_script(text: str) -> Script:
    """The script by character shares: Chinese, Japanese, Korean or Latin."""
    if not text:
        return Script.LATIN
    total = len(text)
    hanzi = sum(1 for c in text if _is_hanzi(c)) / total
    kana = sum(1 for c in text if _is_kana(c)) / total
    hangul = sum(1 for c in text if _is_hangul(c)) / total
    if hanzi > 0.5 and kana < 0.1:
        return Script.CHINESE
    if kana > 0.2 or (hanzi > 0.2 and kana > 0.1):
        return Script.JAPANESE
    if hangul > 0.3:
        return Script.KOREAN
    return Script.LATIN


def _split_inclusive(text: str, delimiters: str) -> List[str]:
    """Rust's split_inclusive: pieces end with the delimiter; a trailing
    piece without one is kept."""
    out: List[str] = []
    start = 0
    for i, c in enumerate(text):
        if c in delimiters:
            out.append(text[start : i + 1])
            start = i + 1
    if start < len(text):
        out.append(text[start:])
    return out


def preprocess_text(text: str) -> List[str]:
    """Clean `text` and split it into chunks for generation."""
    text = clean_text(text)
    script = detect_script(text)
    sentences = [s for s in _split_inclusive(text, ".!?") if s.strip()]
    if not sentences:
        return []

    chunks: List[str] = []
    combine_threshold, split_threshold = _thresholds(script)

    # the first sentence ships on its own, for time to first audio
    first = sentences[0]
    if len(first) <= split_threshold:
        chunks.append(first)
    else:
        for piece in _split_inclusive(first, ",，、"):
            if piece.strip():
                chunks.append(piece.strip())

    current = ""
    chunk_index = len(chunks)
    for sentence in sentences[1:]:
        multiplier = min(1.0 + chunk_index * 0.2, 2.0)
        combine_t = int(combine_threshold * multiplier)
        split_t = int(split_threshold * multiplier)

        sentence_chars = len(sentence.strip())
        if sentence_chars > split_t:
            if current:
                chunks.append(current.strip())
                current = ""
                chunk_index += 1
            for piece in _split_inclusive(sentence, ",，、"):
                if piece.strip():
                    chunks.append(piece.strip())
                    chunk_index += 1
            continue

        if current and len(current) + sentence_chars > combine_t:
            chunks.append(current.strip())
            chunk_index += 1
            current = ""

        if not current:
            current = sentence.strip()
        else:
            current = current + " " + sentence.strip()

    if current:
        chunks.append(current.strip())
    return chunks
