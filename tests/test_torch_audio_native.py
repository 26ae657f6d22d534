"""The port's native audio modules (audio/{_natlib,opus,decode,webm}.py)
against the JAX package's, on the same bytes.

Both packages load a build of the same native/fishaudio.cpp, so the
decoders' PCM and the Ogg/Opus encoder's bytes must be equal exactly:
WAV, FLAC (tests/flac_writer.py), MP3 and Ogg Vorbis (the pygame example
files, where installed), Ogg Opus (the encoder's own stream) and WebM
(PCM, and Opus and Vorbis packets re-muxed by tests/test_containers.py's
muxer), the WebM demuxer's packets, and OggOpusEncoder's header and
stream, with final=True's partial-frame flush. The port builds its own
copy under build/native/ and never resolves a path inside the JAX
package or writes into native/. The native cases skip only where the
library cannot be built, naming the compiler's reason."""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

from fish_speech_tpu.audio import decode as jdecode
from fish_speech_tpu.audio import opus as jopus
from fish_speech_tpu.audio import webm as jwebm
from fish_speech_tpu.audio.wav import pcm_to_wav_bytes as jax_wav_bytes
from fish_speech_tpu_torch.audio import _natlib
from fish_speech_tpu_torch.audio import decode as tdecode
from fish_speech_tpu_torch.audio import opus as topus
from fish_speech_tpu_torch.audio import webm as twebm
from fish_speech_tpu_torch.audio.wav import pcm_to_wav_bytes
from flac_writer import write_flac
from test_containers import _mux_webm, _sine, _xiph_private

REPO = Path(__file__).resolve().parent.parent



def _need_native():
    if not _natlib.available():
        pytest.skip(f"libfishaudio.so could not be built: {_natlib.build_error()}")
    if not jdecode.native_available():
        pytest.skip("the JAX package's native library could not be built")


def _fixture(name):
    """One of pygame's example sounds (the MP3 and Ogg Vorbis files the
    JAX container tests use)."""
    spec = importlib.util.find_spec("pygame")
    path = Path(spec.origin).parent / "examples" / "data" / name if spec else None
    if path is None or not path.exists():
        pytest.skip(f"pygame's example file {name} is not installed")
    return path.read_bytes()


def _same(data):
    got, rate = tdecode.decode_audio_bytes(data)
    ref, ref_rate = jdecode.decode_audio_bytes(data)
    assert rate == ref_rate and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    return got, rate


@pytest.mark.parametrize("rate", [16000, 44100])
def test_wav_decode_equal(rate):
    pcm = _sine(n=3000, rate=rate, amp=0.4)
    data = pcm_to_wav_bytes(pcm, rate)
    assert data == jax_wav_bytes(pcm, rate)
    got, _ = _same(data)
    np.testing.assert_allclose(got, pcm, atol=2 / 32768)  # int16 rounding and 32767 vs 32768


@pytest.mark.parametrize("subframe", ["verbatim", "fixed"])
def test_flac_decode_equal(subframe):
    _need_native()
    x = np.round(_sine(n=5000, rate=22050) * 32767).astype(np.int32)
    got, rate = _same(write_flac(x, 22050, subframe=subframe))
    assert rate == 22050 and got.shape == (5000,)


@pytest.mark.parametrize("name", ["house_lo.ogg", "house_lo.mp3"])
def test_vorbis_and_mp3_decode_equal(name):
    _need_native()
    got, rate = _same(_fixture(name))
    assert got.shape[0] > rate  # more than a second


def test_ogg_opus_decode_equal():
    _need_native()
    enc = topus.OggOpusEncoder()
    data = enc.header() + enc.encode(_sine(n=24000, rate=24000, amp=0.3), final=True)
    enc.close()
    got, rate = _same(data)
    assert rate == 48000 and got.shape[0] >= 2 * (24000 - 480)  # libopus decodes at 48 kHz


def test_webm_pcm_decode_equal():
    x = _sine(rate=24000)
    raw = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2").tobytes()
    data = _mux_webm("A_PCM/INT/LIT", 24000, 1, 16, b"", [raw[i:i + 4096] for i in
                                                           range(0, len(raw), 4096)])
    got, rate = _same(data)
    assert rate == 24000
    np.testing.assert_allclose(got, x, atol=1 / 32768)


def test_webm_opus_and_vorbis_decode_equal():
    _need_native()
    enc = topus.OggOpusEncoder(48000)
    ogg = enc.header() + enc.encode(_sine(n=48000, rate=48000), final=True)
    enc.close()
    pkts = twebm.ogg_packets(ogg)
    assert pkts == jwebm.ogg_packets(ogg)
    got, rate = _same(_mux_webm("A_OPUS", 48000, 1, 16, pkts[0], pkts[2:]))
    assert rate == 48000 and got.shape[0] > 40000
    vorbis = twebm.ogg_packets(_fixture("house_lo.ogg"))
    _same(_mux_webm("A_VORBIS", 44100, 2, 16, _xiph_private(vorbis[:3]), vorbis[3:],
                    frames_per_block=8, lacing="xiph"))


@pytest.mark.parametrize("lacing", ["none", "xiph", "fixed"])
def test_webm_demux_packets_equal(lacing):
    x = _sine(n=4096, rate=16000)
    raw = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2").tobytes()
    frames = [raw[i:i + 512] for i in range(0, len(raw), 512)]
    data = _mux_webm("A_PCM/INT/LIT", 16000, 1, 16, b"", frames, frames_per_block=4,
                     lacing=lacing)
    got = twebm.demux_webm(data)
    assert got == jwebm.demux_webm(data)
    assert got[0] == "A_PCM/INT/LIT" and b"".join(got[5]) == raw


def test_webm_without_audio_track_raises_as_jax():
    from test_containers import _el, _uint_el

    data = _el(0x1A45DFA3, _uint_el(0x4286, 1)) + _el(0x18538067, _el(0x1654AE6B, b""))
    for decode in (tdecode.decode_audio_bytes, jdecode.decode_audio_bytes):
        with pytest.raises(ValueError):
            decode(data)


@pytest.mark.parametrize("n_samples", [100, 12000, 24000 + 250])
def test_ogg_opus_encoder_bytes_equal(n_samples):
    """Header, a stream fed in two calls and the final flush of a partial
    20 ms frame: the same bytes from both packages' encoders."""
    _need_native()
    if not jopus.OggOpusEncoder.available():
        pytest.skip("the JAX package's native encoder could not be built")
    pcm = _sine(n=n_samples, rate=24000, amp=0.3)
    out = []
    for cls in (topus.OggOpusEncoder, jopus.OggOpusEncoder):
        enc = cls()
        half = n_samples // 2
        out.append((enc.header(), enc.encode(pcm[:half]), enc.encode(pcm[half:], final=True)))
        enc.close()
    assert out[0] == out[1]
    header, body, tail = out[0]
    assert header[:4] == b"OggS" and b"OpusHead" in header[:64]
    assert tail[tail.rfind(b"OggS") + 5] & 0x04  # the last page ends the stream


def test_natlib_resolves_nothing_inside_the_jax_package(monkeypatch):
    """The port's library is its own build under build/native/ (or the
    override / its package's _native/), never the JAX package's
    _native/, never native/, and the JAX override variable is ignored."""
    _need_native()
    monkeypatch.setenv("FISH_TPU_NATIVE_LIB", str(REPO / "native" / "libfishaudio.so"))
    path = _natlib.find_lib().resolve()
    assert REPO / "fish_speech_tpu" not in path.parents
    assert REPO / "native" not in path.parents
    assert REPO / "build" / "native" in path.parents
    monkeypatch.setenv(_natlib.ENV_VAR, str(path))
    assert _natlib.find_lib() == path


def test_build_goes_to_build_and_keeps_the_compilers_reason(monkeypatch):
    """A build writes under build/native/ only, with native/Makefile's
    flags; a compiler that fails leaves its reason in build_error()."""
    before = sorted(os.listdir(REPO / "native"))
    flags = _natlib.makefile_vars()
    assert "-std=c++17" in flags["CXXFLAGS"].split() and "-shared" in flags["LDFLAGS"].split()
    if _natlib.available():
        built = _natlib.build_lib()
        assert built is not None and REPO / "build" / "native" in built.resolve().parents
    assert sorted(os.listdir(REPO / "native")) == before
    monkeypatch.setattr(_natlib, "_error", None)
    monkeypatch.setenv("CXX", str(REPO / "build" / "no-such-compiler"))
    assert _natlib.build_lib() is None
    assert "no-such-compiler" in _natlib.build_error()
