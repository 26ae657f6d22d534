"""The port's encode side against the JAX package's: `read_wav` on every
WAV encoding the JAX reader takes, `resample` and `StreamingResampler`
equal; FSQ, residual FSQ, the ConvNeXt encoder, the quantizer's encode
and `FireflyCodec.encode` at the tiny codec of tests/test_server.py.

Codes come from rounding float features, so two implementations whose
features differ in the last bits can flip an index where a value lies
next to a half-integer (and a flip in stage 1 moves every later stage's
residual). The codes are held exact wherever the JAX value before
rounding lies at least TIE_BAND from a half-integer in every dimension
(and every earlier stage); the rest are counted, printed, and at most
MAX_FLIP_SHARE of all codes may differ. Features are held to 1e-5
relative.

The JAX encode pads the mel to a compile bucket with log(1e-5); the
port encodes at the longest row's length. Fish 1.4+ convolutions are
causal, so the kept codes are exact at lengths off the buckets; Fish
1.2's symmetric padding lets the last frames see the bucket's padding,
a divergence `test_fish_1_2_bucket_padding_divergence` names."""

import pytest

# these CPU parity tests (no `cuda` case among them) write their files
# with the safetensors package; where it is missing they are not collected
pytest.importorskip("safetensors")

import functools
import importlib
import io
import struct

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fish_speech_tpu.models.codec import convnext as jconvnext
from fish_speech_tpu.models.codec import firefly as jfire
from fish_speech_tpu.models.codec import fsq as jfsq
from fish_speech_tpu.models.codec import grfsq as jgrfsq
from fish_speech_tpu.models.codec.conv import fish_conv1d as jfish_conv1d
from fish_speech_tpu_torch.audio import resample as tres
from fish_speech_tpu_torch.audio import wav as twav
from fish_speech_tpu_torch.io.convert import firefly_params_from_numpy
from fish_speech_tpu_torch.models.codec import convnext as tconvnext
from fish_speech_tpu_torch.models.codec import firefly as tfire
from fish_speech_tpu_torch.models.codec import fsq as tfsq
from fish_speech_tpu_torch.models.codec import grfsq as tgrfsq
from fish_speech_tpu_torch.models.codec import quantizer as tquant

from test_containers import _encode_ima_adpcm, _encode_ms_adpcm, _g711_encode, _sine, _wav
from test_torch_checkpoint import codec_cfgs, jax_codec_params

# the JAX package's audio/__init__ exports functions under the module names
jres = importlib.import_module("fish_speech_tpu.audio.resample")
jwav = importlib.import_module("fish_speech_tpu.audio.wav")

torch.set_num_threads(1)

TIE_BAND = 1e-3
MAX_FLIP_SHARE = 0.005


def _t(a):
    return torch.from_numpy(np.array(a))


# -- read_wav -------------------------------------------------------------------


def _pcm_payload(x, bits):
    if bits == 8:
        return (np.clip(x * 128 + 128, 0, 255)).astype(np.uint8).tobytes()
    if bits == 16:
        return (x * 32767).astype("<i2").tobytes()
    if bits == 24:
        v = (x * 8388607).astype(np.int32)
        return np.stack([(v >> s) & 0xFF for s in (0, 8, 16)], 1).astype(np.uint8).tobytes()
    return (x * 2147483647).astype("<i4").tobytes()


def _extensible(code, channels, rate, bits, block_align, payload):
    """WAVE_FORMAT_EXTENSIBLE: cbSize 22, valid bits, channel mask, and
    the subformat GUID whose first two bytes are the format code."""
    extra = struct.pack("<HHI", 22, bits, 3 if channels == 2 else 4)
    extra += struct.pack("<H", code) + bytes(14)
    return _wav(0xFFFE, channels, rate, bits, block_align, payload, extra)


def _wav_cases():
    rng = np.random.default_rng(0)
    x = (rng.uniform(-0.9, 0.9, size=600)).astype(np.float32)
    st = (rng.uniform(-0.9, 0.9, size=(300, 2))).astype(np.float32)
    sine = _sine()
    cases = {}
    for bits in (8, 16, 24, 32):
        cases[f"pcm{bits}"] = _wav(1, 1, 22050, bits, bits // 8, _pcm_payload(x, bits))
        cases[f"pcm{bits}_stereo"] = _wav(1, 2, 48000, bits, bits // 4,
                                          _pcm_payload(st.reshape(-1), bits))
        cases[f"pcm{bits}_extensible"] = _extensible(1, 2, 44100, bits, bits // 4,
                                                     _pcm_payload(st.reshape(-1), bits))
    cases["float32"] = _wav(3, 1, 24000, 32, 4, x.astype("<f4").tobytes())
    cases["float64_stereo"] = _wav(3, 2, 24000, 64, 16, st.astype("<f8").tobytes())
    cases["float32_extensible"] = _extensible(3, 1, 16000, 32, 4, x.astype("<f4").tobytes())
    payload, ba = _encode_ima_adpcm(sine)
    cases["ima_adpcm"] = _wav(17, 1, 16000, 4, ba, payload)
    payload, ba = _encode_ms_adpcm(sine)
    cases["ms_adpcm"] = _wav(2, 1, 16000, 4, ba, payload)
    noise = rng.integers(0, 256, size=2048, dtype=np.uint8).tobytes()
    cases["ima_adpcm_stereo_noise"] = _wav(17, 2, 16000, 4, 512, noise)
    cases["ms_adpcm_stereo_noise"] = _wav(2, 2, 16000, 4, 512, noise)
    cases["alaw"] = _wav(6, 1, 8000, 8, 1, _g711_encode(sine, jwav._alaw_decode))
    cases["mulaw"] = _wav(7, 1, 8000, 8, 1, _g711_encode(sine, jwav._mulaw_decode))
    cases["mulaw_extensible"] = _extensible(7, 1, 8000, 8, 1,
                                            _g711_encode(sine, jwav._mulaw_decode))
    cases["writer"] = jwav.pcm_to_wav_bytes(x, 44100)
    # an odd-sized chunk before the data (padded to even, as RIFF says)
    data = jwav.pcm_to_wav_bytes(x[:101], 44100)
    cases["odd_list_chunk"] = (data[:36] + b"LIST" + struct.pack("<I", 3) + b"abc\x00"
                               + data[36:])
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes((st * 1000).astype(np.int16).tobytes())
    cases["stdlib_stereo"] = buf.getvalue()
    return cases


WAVS = _wav_cases()


@pytest.mark.parametrize("name", sorted(WAVS))
def test_read_wav_equal(name, tmp_path):
    """Bytes and a file path alike: the same samples and rate."""
    ref, sr = jwav.read_wav(WAVS[name])
    got, sr_t = twav.read_wav(WAVS[name])
    assert sr_t == sr and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    path = tmp_path / "x.wav"
    path.write_bytes(WAVS[name])
    np.testing.assert_array_equal(twav.read_wav(str(path))[0], ref)


@pytest.mark.parametrize("data,match", [
    (b"OggS" + bytes(100), "Unsupported audio container"),
    (b"RIFF" + struct.pack("<I", 4) + b"WAVE", "missing fmt or data"),
    (_wav(1, 1, 8000, 12, 2, bytes(8)), "bit depth: 12"),
    (_wav(85, 1, 8000, 16, 2, bytes(8)), "format code: 85"),
])
def test_read_wav_rejects_as_jax_does(data, match):
    with pytest.raises(ValueError, match=match):
        jwav.read_wav(data)
    with pytest.raises(ValueError, match=match if "container" not in match else "container"):
        twav.read_wav(data)


# -- resample -------------------------------------------------------------------


@pytest.mark.parametrize("rates", [(44100, 24000), (24000, 44100), (16000, 44100),
                                   (22050, 44100), (48000, 44100), (44100, 44100), (8000, 3)])
@pytest.mark.parametrize("shape", [(1000,), (2, 777), (1,)])
def test_resample_equal(rates, shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref = jres.resample(x, *rates)
    got = tres.resample(x, *rates)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rates", [(44100, 24000), (24000, 44100), (22050, 16000)])
@pytest.mark.parametrize("seed", [0, 1])
def test_streaming_resampler_equal(rates, seed):
    """Random chunkings: each chunk's output equal to the JAX streamer's,
    and the concatenation equal to the whole-signal resample."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=5000).astype(np.float32)
    cuts = np.sort(rng.choice(np.arange(1, 5000), size=12, replace=False))
    js, ts = jres.StreamingResampler(*rates), tres.StreamingResampler(*rates)
    outs = []
    for piece in np.split(x, cuts):
        a, b = js.process(piece), ts.process(piece)
        np.testing.assert_array_equal(b, a)
        outs.append(b)
    a, b = js.process(np.zeros(0, np.float32), final=True), ts.process(
        np.zeros(0, np.float32), final=True)
    np.testing.assert_array_equal(b, a)
    outs.append(b)
    np.testing.assert_array_equal(np.concatenate(outs), tres.resample(x, *rates))


# -- FSQ -------------------------------------------------------------------------


def _near_tie(values):
    """Where a value before rounding lies within TIE_BAND of a
    half-integer."""
    v = np.asarray(values, np.float64)
    return np.abs(np.abs(v - np.floor(v)) - 0.5) < TIE_BAND


def _assert_codes(got, ref, tie, what):
    """Exact outside the near-tie band; at most MAX_FLIP_SHARE differ."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    differ = got != ref
    n_tie = int(np.count_nonzero(tie))
    print(f"{what}: {got.size} codes, {n_tie} in the near-tie band, "
          f"{int(differ.sum())} differ")
    assert not (differ & ~tie).any(), f"{what}: a code outside the near-tie band differs"
    assert differ.sum() <= MAX_FLIP_SHARE * got.size, what


@pytest.mark.parametrize("levels", [(8, 5, 5, 5), (8, 6, 5), (4, 4, 4, 4, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_fsq_forward(levels, seed):
    z = np.random.default_rng(seed).normal(size=(3, 64, len(levels))).astype(np.float32) * 2
    jc, ji = jfsq.fsq_forward(jnp.asarray(z), levels)
    tc, ti = tfsq.fsq_forward(_t(z), levels)
    bounded = np.asarray(jfsq.bound(jnp.asarray(z), levels))
    np.testing.assert_allclose(tfsq.bound(_t(z), levels).numpy(), bounded, rtol=1e-6,
                               atol=1e-6)
    tie = _near_tie(bounded).any(-1)
    _assert_codes(ti.numpy(), ji, tie, f"fsq {levels}")
    ok = ~tie
    np.testing.assert_array_equal(tc.numpy()[ok], np.asarray(jc)[ok])
    assert ti.dtype == torch.int32


@pytest.mark.parametrize("num_quantizers", [1, 2, 3])
def test_residual_fsq_forward(num_quantizers):
    """Quantised output to 1e-5 relative and indices by the tie rule, with
    each stage's values before rounding taken from the JAX arithmetic."""
    rng = np.random.default_rng(num_quantizers)
    levels = (8, 5, 5, 5)
    x = rng.normal(size=(2, 50, 16)).astype(np.float32)
    gp = {"project_in": {"w": rng.normal(size=(16, 4)).astype(np.float32) * 0.3,
                         "b": rng.normal(size=(4,)).astype(np.float32) * 0.1},
          "project_out": {"w": rng.normal(size=(4, 16)).astype(np.float32),
                          "b": rng.normal(size=(16,)).astype(np.float32)}}
    jq, ji = jgrfsq.residual_fsq_forward(jnp.asarray(x), jax.tree.map(jnp.asarray, gp), levels,
                                         num_quantizers)
    tq, ti = tgrfsq.residual_fsq_forward(_t(x), jax.tree.map(_t, gp), levels, num_quantizers)
    tie = _stage_ties(jnp.asarray(x), gp, levels, num_quantizers)
    _assert_codes(ti.numpy(), ji, tie, f"residual fsq x{num_quantizers}")
    ok = ~tie.any(-1)
    np.testing.assert_allclose(tq.numpy()[ok], np.asarray(jq)[ok], rtol=1e-5, atol=1e-5)


def _stage_ties(x, gp, levels, num_quantizers):
    """(..., Q) near-tie flags of one group, each stage's flag also set
    where an earlier stage's is (its residual moved)."""
    z = jgrfsq._linear(x, jax.tree.map(jnp.asarray, gp["project_in"]))
    residual = jfsq.bound(z, levels)
    flags = []
    for scale in jgrfsq._scales(levels, num_quantizers):
        flags.append(_near_tie(jfsq.bound(residual / scale, levels)).any(-1))
        codes, _ = jfsq.fsq_forward(residual / scale, levels)
        residual = residual - codes * scale
    return np.logical_or.accumulate(np.stack(flags, -1), axis=-1)


# -- the encoder ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _codec(version):
    """(JAX config, port config, JAX params, port params) of the tiny
    codec, the parameters filled from a numpy seed."""
    jc, tc = codec_cfgs(version)
    params = jax_codec_params(jc, seed=5)
    return jc, tc, params, firefly_params_from_numpy(jax.tree.map(np.asarray, params))


@pytest.fixture(params=["1.2", "1.5"])
def codec(request):
    return _codec(request.param)


def _mel(jc, n_frames, seed=0):
    return np.random.default_rng(seed).normal(
        size=(2, jc.spec_transform.n_mels, n_frames)).astype(np.float32) * 3 - 4


def test_convnext_encoder_features(codec):
    jc, tc, params, tparams = codec
    mel = _mel(jc, 77)
    ref = np.asarray(jconvnext.convnext_encoder(jnp.asarray(mel), params["backbone"],
                                                jc.backbone, jc.version))
    got = tconvnext.convnext_encoder(_t(mel), tparams["backbone"], tc.backbone, tc.version)
    assert got.shape == ref.shape == (2, jc.backbone.dims[-1], 77)
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-5 * float(np.abs(ref).max())


def _jax_code_ties(jc, params, mel):
    """(B, G*Q, T') near-tie flags of the JAX encode of `mel` at its
    length: each group's stage values before rounding."""
    q = jc.quantizer
    z = jconvnext.convnext_encoder(jnp.asarray(mel), params["backbone"], jc.backbone, jc.version)
    for i, f in enumerate(q.downsample_factor):
        layer = params["quantizer"]["downsample"][i]
        z = jfish_conv1d(z, layer["conv"], stride=f, version=jc.version)
        z = jconvnext.convnext_block(z, layer["block"], version=jc.version)
    chunks = jnp.split(z.transpose(0, 2, 1), q.n_groups, axis=-1)
    ties = [_stage_ties(c, jax.tree.map(np.asarray, gp), q.levels, q.n_codebooks)
            for c, gp in zip(chunks, params["quantizer"]["rvqs"])]  # (B, T', Q) each
    g = np.stack(ties, 0)  # (G, B, T', Q)
    return g.transpose(1, 0, 3, 2).reshape(g.shape[1], -1, g.shape[2])


@pytest.mark.parametrize("n_codebooks", [1, 2])
def test_quantizer_encode_codes(codec, n_codebooks):
    jc, tc, params, tparams = codec
    if n_codebooks != 1:
        jc, tc = codec_cfgs(jc.version.value, n_codebooks=n_codebooks)
        params = jax_codec_params(jc, seed=6)
        tparams = firefly_params_from_numpy(jax.tree.map(np.asarray, params))
    feats = np.random.default_rng(2).normal(size=(2, jc.quantizer.input_dim, 120)).astype(
        np.float32)
    ref = np.asarray(jfire.quantizer_encode(jnp.asarray(feats), params["quantizer"],
                                            jc.quantizer, jc.version))
    got = tquant.quantizer_encode(_t(feats), tparams["quantizer"], tc.quantizer, tc.version)
    assert got.dtype == torch.int32
    mel_free = _quantizer_ties(jc, params, feats)
    _assert_codes(got.numpy(), ref, mel_free, f"quantizer_encode {jc.version.value} "
                  f"x{n_codebooks}")


def _quantizer_ties(jc, params, feats):
    q = jc.quantizer
    z = jnp.asarray(feats)
    for i, f in enumerate(q.downsample_factor):
        layer = params["quantizer"]["downsample"][i]
        z = jfish_conv1d(z, layer["conv"], stride=f, version=jc.version)
        z = jconvnext.convnext_block(z, layer["block"], version=jc.version)
    chunks = jnp.split(z.transpose(0, 2, 1), q.n_groups, axis=-1)
    g = np.stack([_stage_ties(c, jax.tree.map(np.asarray, gp), q.levels, q.n_codebooks)
                  for c, gp in zip(chunks, params["quantizer"]["rvqs"])], 0)
    return g.transpose(1, 0, 3, 2).reshape(g.shape[1], -1, g.shape[2])


def _audio(n_samples, rows=2, seed=3):
    return (np.random.default_rng(seed).normal(size=(rows, n_samples)) * 0.2).astype(np.float32)


@pytest.mark.parametrize("version,mel_frames", [("1.5", 64), ("1.5", 100), ("1.5", 256),
                                                ("1.2", 64), ("1.2", 256)])
def test_codec_encode(version, mel_frames):
    """FireflyCodec.encode of 2 rows (one with a silent tail): the port's
    codes against the JAX codec's. Fish 1.5 at any length; Fish 1.2 at
    lengths where the mel is a bucket's (the other lengths:
    test_fish_1_2_bucket_padding_divergence)."""
    jc, tc, params, tparams = _codec(version)
    hop = jc.spec_transform.hop_length
    n = mel_frames * hop  # the framing gives n / hop mel frames
    audio = _audio(n)
    audio[1, n - 5 * hop:] = 0.0
    jcodec = jfire.FireflyCodec(params, jc)
    tcodec = tfire.FireflyCodec(tparams, tc, device="cpu")
    mel_t = jcodec.spec_transform(audio[0]).shape[-1]
    assert mel_t == mel_frames
    assert version == "1.5" or mel_t in jfire.DECODE_BUCKETS
    ref = jcodec.encode(audio)
    got = tcodec.encode(audio)
    assert got.shape == ref.shape == (2, jc.quantizer.num_semantic_codebooks,
                                      mel_t // jc.quantizer.total_downsample)
    assert got.shape[-1] == tcodec.frames_for_samples(n)
    mel = np.stack([np.asarray(jcodec.spec_transform(a))[0] for a in audio])
    _assert_codes(got, ref, _jax_code_ties(jc, params, mel), f"encode {jc.version.value} "
                  f"{mel_frames} frames")


@pytest.mark.parametrize("n_samples", [1, 30, 64])
def test_codec_encode_shorter_than_a_frame(codec, n_samples):
    """Audio shorter than one code frame gives (B, C, 0) codes, as the
    JAX encode's trim does."""
    jc, tc, params, tparams = codec
    audio = _audio(n_samples)
    ref = jfire.FireflyCodec(params, jc).encode(audio)
    got = tfire.FireflyCodec(tparams, tc, device="cpu").encode(audio)
    assert got.shape == ref.shape and got.shape[-1] == 0 and got.dtype == np.int32


def test_fish_1_2_bucket_padding_divergence():
    """The JAX encode pads the mel with log(1e-5) to a compile bucket. A
    Fish 1.2 encode (symmetric padding) then lets the last frames see
    the padding: off the buckets the JAX codes differ from the port's
    exact-length encode, in the frames the padding reaches and nowhere
    else; at a bucket length they agree (test_codec_encode)."""
    jc, tc, params, tparams = _codec("1.2")
    hop = jc.spec_transform.hop_length
    audio = _audio(100 * hop, rows=1)
    jcodec = jfire.FireflyCodec(params, jc)
    mel_t = jcodec.spec_transform(audio[0]).shape[-1]
    assert mel_t not in jfire.DECODE_BUCKETS
    ref = jcodec.encode(audio)
    got = tfire.FireflyCodec(tparams, tc, device="cpu").encode(audio)
    # frames of the mel a symmetric encode reaches to the right: the stem,
    # every block's depthwise conv; then the downsample stack's blocks
    bb = jc.backbone
    reach_mel = bb.kernel_size // 2 + sum(bb.depths) * (bb.kernel_size - 1) // 2
    ds = jc.quantizer.total_downsample
    reach = -(-reach_mel // ds) + len(jc.quantizer.downsample_factor) * 3 + 1
    t = got.shape[-1]
    mel = np.asarray(jcodec.spec_transform(audio[0]))
    ties = _jax_code_ties(jc, params, mel)
    _assert_codes(got[..., :t - reach], ref[..., :t - reach], ties[..., :t - reach],
                  "1.2 off the buckets, before the padding's reach")
    assert (got[..., t - reach:] != ref[..., t - reach:]).any(), (
        "the JAX 1.2 codes near the end no longer see the bucket's padding")


def test_encode_decode_round_trip(codec):
    """Encode -> decode through the port: codes in the codebook, the
    decode's length the frames times the samples a frame, the PCM
    finite."""
    jc, tc, params, tparams = codec
    codec_t = tfire.FireflyCodec(tparams, tc, device="cpu")
    audio = _audio(64 * jc.spec_transform.hop_length, rows=1)
    codes = codec_t.encode(audio)
    assert codes.min() >= 0 and codes.max() < 1000
    pcm = codec_t.decode(codes)
    assert pcm.shape == (1, codes.shape[-1] * codec_t.samples_per_frame)
    assert np.isfinite(pcm).all()


def test_tf32_blocks_run_one_at_a_time():
    """The encode's TF32 switch is process-wide: a second thread's block
    waits for the first's to end, so neither restores a value the other
    set, and the switches end as they were."""
    import threading

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    inside, release = threading.Event(), threading.Event()
    seen = []

    def first():
        with tfire._tf32(False):
            inside.set()
            release.wait(10)
            seen.append(("first", torch.backends.cudnn.allow_tf32))

    def second():
        with tfire._tf32(True):
            seen.append(("second", torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))

    a = threading.Thread(target=first)
    a.start()
    assert inside.wait(10)
    b = threading.Thread(target=second)
    b.start()
    b.join(0.2)
    assert b.is_alive() and seen == []  # waiting for the first block
    release.set()
    a.join(10)
    b.join(10)
    assert seen == [("first", False), ("second", True, True)]
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == saved
