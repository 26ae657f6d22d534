"""Streaming Ogg/Opus encoding through the native runtime.

Counterpart of `fish_speech_tpu/audio/opus.py`: 24 kHz mono VoIP Opus at
24 kb/s, 20 ms frames, Ogg pages flushed at every encode call. Both
packages drive the same `native/fishaudio.cpp`, so for the same PCM the
bytes are the same. Where the library cannot be built or loaded
(`audio/_natlib.py`), `OggOpusEncoder.available()` is False.
"""

from __future__ import annotations

import ctypes

import numpy as np

from fish_speech_tpu_torch.audio import _natlib

OPUS_SAMPLE_RATE = 24000
OPUS_BITRATE = 24000


class OggOpusEncoder:
    """Stateful streaming encoder: feed float32 PCM, read Ogg bytes."""

    def __init__(self, sample_rate: int = OPUS_SAMPLE_RATE, bitrate: int = OPUS_BITRATE) -> None:
        lib = _natlib.load()
        if lib is None:
            raise RuntimeError("native opus encoder unavailable (libfishaudio.so failed to "
                               f"build or load: {_natlib.build_error()})")
        self._lib = lib
        self._h = lib.fa_ogg_opus_create(sample_rate, bitrate)
        if not self._h:
            raise RuntimeError("opus_encoder_create failed")

    @staticmethod
    def available() -> bool:
        return _natlib.available()

    def _drain(self) -> bytes:
        n = self._lib.fa_ogg_opus_pending(self._h)
        if n <= 0:
            return b""
        buf = (ctypes.c_ubyte * n)()
        got = self._lib.fa_ogg_opus_read(self._h, buf, n)
        return bytes(buf[:got])

    def header(self) -> bytes:
        """The OpusHead and OpusTags pages (ready right after creation)."""
        return self._drain()

    def encode(self, pcm: np.ndarray, *, final: bool = False) -> bytes:
        """Encode float32 PCM in [-1, 1]; returns the finished pages.
        final: pad the last partial frame and close the stream."""
        pcm = np.ascontiguousarray(pcm, dtype=np.float32)
        rc = self._lib.fa_ogg_opus_encode(
            self._h, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pcm.shape[0],
            1 if final else 0)
        if rc < 0:
            raise RuntimeError("opus_encode_float failed")
        return self._drain()

    def close(self) -> None:
        if self._h:
            self._lib.fa_ogg_opus_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
