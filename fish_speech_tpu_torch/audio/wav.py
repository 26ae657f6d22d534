"""WAV IO, the port's own copy of the JAX package's `audio/wav.py`:
writing 16-bit mono PCM with the same header fields, and reading every
WAV encoding the JAX reader takes. numpy only."""

from __future__ import annotations

import io
import struct
from typing import Tuple, Union

import numpy as np


def write_pcm_as_wav(buf, samples: np.ndarray, sample_rate: int) -> None:
    """Write float PCM in [-1, 1] (clipped) or int16 PCM as a WAV file."""
    samples = np.asarray(samples)
    if samples.dtype != np.int16:
        samples = (np.clip(samples, -1.0, 1.0) * 32767.0).astype(np.int16)
    data = samples.tobytes()
    n = len(samples)
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 12 + 24 + n * 2 + 8 - 8))
    buf.write(b"WAVE")
    buf.write(b"fmt ")
    buf.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
    buf.write(b"data")
    buf.write(struct.pack("<I", n * 2))
    buf.write(data)


def pcm_to_wav_bytes(samples: np.ndarray, sample_rate: int) -> bytes:
    out = io.BytesIO()
    write_pcm_as_wav(out, samples, sample_rate)
    return out.getvalue()


# ---------------------------------------------------------------------------
# Reading. Compressed PCM inside WAV (format codes 2 / 17 / 6 / 7) is
# decoded here too, once per file on the host: the per-nibble ADPCM loops
# favour clarity over speed.
# ---------------------------------------------------------------------------

_MS_ADAPT = [230, 230, 230, 230, 307, 409, 512, 614,
             768, 614, 512, 409, 307, 230, 230, 230]
_MS_COEF1 = [256, 512, 0, 192, 240, 460, 392]
_MS_COEF2 = [0, -256, 0, 64, 0, -208, -232]

_IMA_INDEX = [-1, -1, -1, -1, 2, 4, 6, 8]
_IMA_STEPS = [
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767,
]


def _clamp16(v: int) -> int:
    return -32768 if v < -32768 else (32767 if v > 32767 else v)


def _decode_ms_adpcm(data: bytes, channels: int, block_align: int) -> np.ndarray:
    """MS ADPCM (WAVE format 2) -> interleaved f32 in [-1, 1)."""
    out: list = []
    nch = max(1, channels)
    for base in range(0, len(data) - nch * 7 + 1, max(block_align, nch * 7)):
        blk = data[base : base + block_align]
        pred = [min(blk[c], 6) for c in range(nch)]
        off = nch
        idelta = [
            struct.unpack_from("<h", blk, off + 2 * c)[0] for c in range(nch)
        ]
        off += 2 * nch
        s1 = [struct.unpack_from("<h", blk, off + 2 * c)[0] for c in range(nch)]
        off += 2 * nch
        s2 = [struct.unpack_from("<h", blk, off + 2 * c)[0] for c in range(nch)]
        off += 2 * nch
        # the two seeded samples are the block's first outputs (older first)
        out.extend(s2)
        out.extend(s1)
        c1 = [_MS_COEF1[p] for p in pred]
        c2 = [_MS_COEF2[p] for p in pred]
        ch = 0
        for byte in blk[off:]:
            for nib in (byte >> 4, byte & 0xF):
                signed = nib - 16 if nib >= 8 else nib
                p = (s1[ch] * c1[ch] + s2[ch] * c2[ch]) >> 8
                p = _clamp16(p + signed * idelta[ch])
                s2[ch], s1[ch] = s1[ch], p
                idelta[ch] = max(16, (_MS_ADAPT[nib] * idelta[ch]) >> 8)
                out.append(p)
                ch = (ch + 1) % nch
    return np.asarray(out, np.float32) / 32768.0


def _decode_ima_adpcm(data: bytes, channels: int, block_align: int) -> np.ndarray:
    """IMA/DVI ADPCM (WAVE format 17) -> interleaved f32 in [-1, 1)."""
    nch = max(1, channels)
    rows: list = [[] for _ in range(nch)]
    hdr = 4 * nch
    for base in range(0, len(data) - hdr + 1, max(block_align, hdr)):
        blk = data[base : base + block_align]
        samp = []
        index = []
        for c in range(nch):
            samp.append(struct.unpack_from("<h", blk, 4 * c)[0])
            index.append(min(max(blk[4 * c + 2], 0), 88))
            rows[c].append(samp[c])
        # data: per-channel 4-byte groups round-robin, low nibble first
        pos = hdr
        while pos + 4 * nch <= len(blk):
            for c in range(nch):
                for byte in blk[pos + 4 * c : pos + 4 * c + 4]:
                    for nib in (byte & 0xF, byte >> 4):
                        step = _IMA_STEPS[index[c]]
                        diff = step >> 3
                        if nib & 1:
                            diff += step >> 2
                        if nib & 2:
                            diff += step >> 1
                        if nib & 4:
                            diff += step
                        if nib & 8:
                            diff = -diff
                        samp[c] = _clamp16(samp[c] + diff)
                        index[c] = min(max(index[c] + _IMA_INDEX[nib & 7], 0), 88)
                        rows[c].append(samp[c])
            pos += 4 * nch
    n = min(len(r) for r in rows)
    inter = np.stack([np.asarray(r[:n], np.float32) for r in rows], axis=1)
    return inter.reshape(-1) / 32768.0


def _alaw_decode(u: np.ndarray) -> np.ndarray:
    """G.711 a-law -> f32 (ITU-T table, computed once)."""
    a = np.arange(256, dtype=np.int32) ^ 0x55
    sign = np.where(a & 0x80, -1, 1)
    exp = (a >> 4) & 7
    mant = a & 0xF
    mag = np.where(
        exp == 0, (mant << 4) + 8, ((mant << 4) + 0x108) << (exp - 1)
    )
    table = (sign * mag).astype(np.float32) / 32768.0
    return table[np.asarray(u, np.uint8)]


def _mulaw_decode(u: np.ndarray) -> np.ndarray:
    """G.711 mu-law -> f32."""
    m = ~np.arange(256, dtype=np.int32) & 0xFF
    sign = np.where(m & 0x80, -1, 1)
    exp = (m >> 4) & 7
    mant = m & 0xF
    mag = (((mant << 3) + 0x84) << exp) - 0x84
    table = (sign * mag).astype(np.float32) / 32768.0
    return table[np.asarray(u, np.uint8)]


def read_wav(src: Union[str, bytes]) -> Tuple[np.ndarray, int]:
    """Decode a WAV file or its bytes to (mono float32 (T,), sample_rate):
    PCM 8/16/24/32, IEEE float, MS and IMA ADPCM, A-law and mu-law, plain
    or WAVE_FORMAT_EXTENSIBLE; channels are averaged to mono."""
    if isinstance(src, (bytes, bytearray)):
        fobj = io.BytesIO(bytes(src))
    else:
        fobj = open(src, "rb")
    try:
        header = fobj.read(12)
        fobj.seek(0)
        if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError("Unsupported audio container (the port reads WAV only)")
        # Parse fmt chunk manually so IEEE-float WAVs also work.
        fobj.seek(12)
        fmt = None
        data = None
        while True:
            head = fobj.read(8)
            if len(head) < 8:
                break
            cid, size = head[:4], struct.unpack("<I", head[4:])[0]
            payload_pos = fobj.tell()
            if cid == b"fmt ":
                fmt = fobj.read(size)
            elif cid == b"data":
                data = fobj.read(size)
            else:
                fobj.seek(size, 1)
            fobj.seek(payload_pos + size + (size & 1))
        if fmt is None or data is None:
            raise ValueError("Malformed WAV: missing fmt or data chunk")
        audio_format, channels, rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
        if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
            audio_format = struct.unpack("<H", fmt[24:26])[0]
        if audio_format == 1:  # PCM
            if bits == 16:
                x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
            elif bits == 32:
                x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
            elif bits == 8:
                x = (np.frombuffer(data, "u1").astype(np.float32) - 128.0) / 128.0
            elif bits == 24:
                raw = np.frombuffer(data, "u1").reshape(-1, 3)
                x = (
                    raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16)
                )
                x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
            else:
                raise ValueError(f"Unsupported PCM bit depth: {bits}")
        elif audio_format == 3:  # IEEE float
            x = np.frombuffer(data, "<f4" if bits == 32 else "<f8").astype(np.float32)
        elif audio_format == 2:  # MS ADPCM
            block_align = struct.unpack("<H", fmt[12:14])[0]
            x = _decode_ms_adpcm(data, channels, block_align)
        elif audio_format == 17:  # IMA/DVI ADPCM
            block_align = struct.unpack("<H", fmt[12:14])[0]
            x = _decode_ima_adpcm(data, channels, block_align)
        elif audio_format == 6:  # a-law
            x = _alaw_decode(np.frombuffer(data, np.uint8))
        elif audio_format == 7:  # mu-law
            x = _mulaw_decode(np.frombuffer(data, np.uint8))
        else:
            raise ValueError(f"Unsupported WAV format code: {audio_format}")
        if channels > 1:
            x = x.reshape(-1, channels).mean(axis=1)
        return x, rate
    finally:
        fobj.close()
