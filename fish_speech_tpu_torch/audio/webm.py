"""Matroska / WebM audio demux -> mono float32 PCM.

Counterpart of `fish_speech_tpu/audio/webm.py`, the same EBML walk in
plain Python. Tracks A_PCM/* decode here; the demuxed A_OPUS and
A_VORBIS packets decode in the native runtime's packet-level entry
points (`fa_decode_opus_packets` / `fa_decode_vorbis_packets` of
native/fishaudio.cpp, loaded by `audio/_natlib.py`). The first audio
track wins.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from fish_speech_tpu_torch.audio import _natlib

EBML_MAGIC = b"\x1a\x45\xdf\xa3"

# EBML element IDs (with marker bits, as they appear in the stream)
_SEGMENT = 0x18538067
_TRACKS = 0x1654AE6B
_TRACK_ENTRY = 0xAE
_TRACK_NUMBER = 0xD7
_TRACK_TYPE = 0x83
_CODEC_ID = 0x86
_CODEC_PRIVATE = 0x63A2
_AUDIO = 0xE1
_SAMPLING_FREQ = 0xB5
_CHANNELS = 0x9F
_BIT_DEPTH = 0x6264
_CLUSTER = 0x1F43B675
_SIMPLE_BLOCK = 0xA3
_BLOCK_GROUP = 0xA0
_BLOCK = 0xA1

# elements whose payload we must recurse into
_MASTERS = {_SEGMENT, _TRACKS, _TRACK_ENTRY, _AUDIO, _CLUSTER, _BLOCK_GROUP}


def _read_id(data: bytes, pos: int) -> Tuple[int, int]:
    """EBML IDs keep their length-marker bits."""
    first = data[pos]
    for n in range(1, 5):
        if first & (0x80 >> (n - 1)):
            return int.from_bytes(data[pos : pos + n], "big"), pos + n
    raise ValueError("invalid EBML ID")


def _read_size(data: bytes, pos: int) -> Tuple[Optional[int], int]:
    """EBML sizes strip the marker bit; all-ones payload means 'unknown'."""
    first = data[pos]
    for n in range(1, 9):
        if first & (0x80 >> (n - 1)):
            raw = int.from_bytes(data[pos : pos + n], "big")
            val = raw & ((1 << (7 * n)) - 1)
            if val == (1 << (7 * n)) - 1:
                return None, pos + n  # unknown size
            return val, pos + n
    raise ValueError("invalid EBML size")


def _walk(data: bytes, start: int, end: int):
    """Yield (element_id, payload_start, payload_end) for the children of
    [start, end). Unknown-size elements (streamed Segments/Clusters)
    extend to the parent's end."""
    pos = start
    while pos < end:
        eid, pos = _read_id(data, pos)
        size, pos = _read_size(data, pos)
        pend = end if size is None else min(pos + size, end)
        yield eid, pos, pend
        pos = pend


def _uint(data: bytes, a: int, b: int) -> int:
    return int.from_bytes(data[a:b], "big")


def _float(data: bytes, a: int, b: int) -> float:
    import struct

    n = b - a
    if n == 4:
        return struct.unpack(">f", data[a:b])[0]
    if n == 8:
        return struct.unpack(">d", data[a:b])[0]
    return float(_uint(data, a, b))


def _parse_tracks(data: bytes, a: int, b: int):
    """First audio TrackEntry -> (track_number, codec_id, sample_rate,
    channels, bit_depth, codec_private)."""
    for eid, ta, tb in _walk(data, a, b):
        if eid != _TRACK_ENTRY:
            continue
        num = None
        ttype = None
        codec = ""
        private = b""
        rate = 0.0
        ch = 1
        depth = 16
        for fid, fa, fb in _walk(data, ta, tb):
            if fid == _TRACK_NUMBER:
                num = _uint(data, fa, fb)
            elif fid == _TRACK_TYPE:
                ttype = _uint(data, fa, fb)
            elif fid == _CODEC_ID:
                codec = data[fa:fb].decode("ascii", "replace").rstrip("\x00")
            elif fid == _CODEC_PRIVATE:
                private = data[fa:fb]
            elif fid == _AUDIO:
                for aid, aa, ab in _walk(data, fa, fb):
                    if aid == _SAMPLING_FREQ:
                        rate = _float(data, aa, ab)
                    elif aid == _CHANNELS:
                        ch = _uint(data, aa, ab)
                    elif aid == _BIT_DEPTH:
                        depth = _uint(data, aa, ab)
        if ttype == 2 and num is not None:  # audio track
            return num, codec, rate, ch, depth, private
    return None


def _block_frames(data: bytes, a: int, b: int, track: int) -> List[bytes]:
    """Frames of one (Simple)Block for `track` (all four lacing modes)."""
    pos = a
    # block's track number is an EBML vint with marker stripped
    first = data[pos]
    for n in range(1, 5):
        if first & (0x80 >> (n - 1)):
            tnum = int.from_bytes(data[pos : pos + n], "big") & (
                (1 << (7 * n)) - 1
            )
            pos += n
            break
    else:
        return []
    if tnum != track:
        return []
    pos += 2  # int16 relative timestamp
    flags = data[pos]
    pos += 1
    lacing = (flags >> 1) & 0x3
    if lacing == 0:
        return [data[pos:b]]
    nframes = data[pos] + 1
    pos += 1
    sizes: List[int] = []
    if lacing == 2:  # fixed
        total = b - pos
        sizes = [total // nframes] * nframes
    elif lacing == 1:  # Xiph
        for _ in range(nframes - 1):
            sz = 0
            while data[pos] == 255:
                sz += 255
                pos += 1
            sz += data[pos]
            pos += 1
            sizes.append(sz)
        sizes.append(b - pos - sum(sizes))
    else:  # EBML lacing: first size is a vint, rest are signed deltas
        first_sz, pos = _read_size(data, pos)
        sizes = [first_sz or 0]
        for _ in range(nframes - 2):
            raw, pos2 = _read_size(data, pos)
            n = pos2 - pos
            pos = pos2
            delta = (raw or 0) - ((1 << (7 * n - 1)) - 1)
            sizes.append(sizes[-1] + delta)
        sizes.append(b - pos - sum(sizes))
    out = []
    for sz in sizes:
        out.append(data[pos : pos + sz])
        pos += sz
    return out


def demux_webm(data: bytes):
    """-> (codec_id, sample_rate, channels, bit_depth, codec_private,
    packets). Raises ValueError when no audio track is found."""
    data = bytes(data)
    if data[:4] != EBML_MAGIC:
        raise ValueError("not an EBML (WebM/Matroska) stream")
    track = None
    packets: List[bytes] = []
    for eid, a, b in _walk(data, 0, len(data)):
        if eid != _SEGMENT:
            continue
        for sid, sa, sb in _walk(data, a, b):
            if sid == _TRACKS and track is None:
                track = _parse_tracks(data, sa, sb)
            elif sid == _CLUSTER and track is not None:
                for cid, ca, cb in _walk(data, sa, sb):
                    if cid == _SIMPLE_BLOCK:
                        packets.extend(
                            _block_frames(data, ca, cb, track[0])
                        )
                    elif cid == _BLOCK_GROUP:
                        for gid, ga, gb in _walk(data, ca, cb):
                            if gid == _BLOCK:
                                packets.extend(
                                    _block_frames(data, ga, gb, track[0])
                                )
    if track is None:
        raise ValueError("WebM/Matroska stream has no audio track")
    num, codec, rate, ch, depth, private = track
    return codec, rate, ch, depth, private, packets


def _packets_to_ctypes(packets: List[bytes]):
    bufs = [ctypes.create_string_buffer(p, len(p)) for p in packets]
    arr = (ctypes.POINTER(ctypes.c_ubyte) * len(packets))(
        *[
            ctypes.cast(b, ctypes.POINTER(ctypes.c_ubyte))
            for b in bufs
        ]
    )
    lens = (ctypes.c_longlong * len(packets))(*[len(p) for p in packets])
    return bufs, arr, lens


def decode_webm_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """WebM/MKV bytes -> (mono f32 (T,), sample_rate)."""
    codec, rate, ch, depth, private, packets = demux_webm(data)
    if not packets:
        raise ValueError("WebM/Matroska stream has no audio packets")

    if codec.startswith("A_PCM"):
        raw = b"".join(packets)
        if codec == "A_PCM/INT/LIT":
            if depth == 16:
                x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
            elif depth == 24:
                u = np.frombuffer(raw, "u1").reshape(-1, 3)
                v = (
                    u[:, 0].astype(np.int32)
                    | (u[:, 1].astype(np.int32) << 8)
                    | (u[:, 2].astype(np.int32) << 16)
                )
                x = (v - ((v & 0x800000) << 1)).astype(np.float32) / 8388608.0
            else:
                raise ValueError(f"unsupported PCM bit depth {depth}")
        elif codec == "A_PCM/FLOAT/IEEE":
            x = np.frombuffer(raw, "<f4" if depth == 32 else "<f8").astype(
                np.float32
            )
        else:
            raise ValueError(f"unsupported PCM codec {codec}")
        if ch > 1:
            x = x[: (len(x) // ch) * ch].reshape(-1, ch).mean(axis=1)
        return x.astype(np.float32), int(rate)

    lib = _natlib.load()
    if lib is None:
        raise ValueError("WebM Opus/Vorbis decode requires the native runtime "
                         f"(libfishaudio.so: {_natlib.build_error()})")
    if codec == "A_OPUS":
        fn = lib.fa_decode_opus_packets
    elif codec == "A_VORBIS":
        fn = lib.fa_decode_vorbis_packets
    else:
        raise ValueError(f"unsupported WebM/Matroska audio codec {codec}")
    _bufs, arr, lens = _packets_to_ctypes(packets)
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_longlong()
    out_rate = ctypes.c_int()
    rc = fn(
        bytes(private),
        ctypes.c_size_t(len(private)),
        arr,
        lens,
        ctypes.c_int(len(packets)),
        ctypes.byref(out),
        ctypes.byref(n),
        ctypes.byref(out_rate),
    )
    if rc != 0 or n.value <= 0:
        raise ValueError(f"could not decode {codec} packets (rc={rc})")
    try:
        pcm = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.fa_free(out)
    return pcm.astype(np.float32), int(out_rate.value)


# -- Ogg page parsing (fixture/re-mux helper) -------------------------------


def ogg_packets(data: bytes) -> List[bytes]:
    """Extract the packet sequence from an Ogg stream (same framing the
    native encoder writes). Used to re-mux Ogg codec streams into test
    WebM fixtures and by any caller needing raw packets."""
    packets: List[bytes] = []
    cur = b""
    pos = 0
    data = bytes(data)
    while pos + 27 <= len(data):
        if data[pos : pos + 4] != b"OggS":
            pos += 1
            continue
        nsegs = data[pos + 26]
        lacing = data[pos + 27 : pos + 27 + nsegs]
        body = pos + 27 + nsegs
        for seg in lacing:
            cur += data[body : body + seg]
            body += seg
            if seg < 255:
                packets.append(cur)
                cur = b""
        pos = body
    if cur:
        packets.append(cur)
    return packets
