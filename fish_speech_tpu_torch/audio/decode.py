"""Any-container audio decode: WAV / WebM / MP3 / Ogg Vorbis / Ogg Opus /
FLAC bytes -> mono float32 and the sample rate.

Counterpart of `fish_speech_tpu/audio/decode.py`. WAV parses in Python
(`audio/wav.py::read_wav`), WebM/Matroska demuxes in Python
(`audio/webm.py`); the other containers decode in the native runtime
(`fa_decode_auto`: libmpg123, libvorbisfile, libopus and a FLAC decoder
of its own).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from fish_speech_tpu_torch.audio import _natlib
from fish_speech_tpu_torch.audio.wav import read_wav


def native_available() -> bool:
    return _natlib.available()


def decode_audio_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """An audio file's bytes -> (mono float32 (T,), sample_rate). Raises
    ValueError for unsupported or corrupt input."""
    data = bytes(data)  # multipart readers may hand back a bytearray
    if data[:4] == b"RIFF":
        return read_wav(data)
    if data[:4] == b"\x1a\x45\xdf\xa3":  # EBML: WebM / Matroska
        from fish_speech_tpu_torch.audio.webm import decode_webm_bytes

        return decode_webm_bytes(data)
    lib = _natlib.load()
    if lib is None:
        raise ValueError("Only WAV and WebM PCM input are supported without the native "
                         f"decoder (libfishaudio.so: {_natlib.build_error()})")
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_longlong()
    rate = ctypes.c_int()
    rc = lib.fa_decode_auto(data, len(data), ctypes.byref(out), ctypes.byref(n),
                            ctypes.byref(rate))
    if rc != 0 or n.value <= 0:
        raise ValueError(f"Could not decode audio (native rc={rc})")
    try:
        pcm = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.fa_free(out)
    return pcm.astype(np.float32), int(rate.value)
