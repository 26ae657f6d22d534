"""The port's streaming Firefly decode (models/codec/stream_conv.py,
firefly_stream.py and FireflyCodec's streaming surface) against the JAX
package's, at test_torch_codec.py's tiny configuration, on the same
float32 parameters carried across by io/convert.py.

Tolerances (float32; XLA and PyTorch sum the convolutions in other
orders): the port against JAX, 1e-4 absolute and relative, chunk by
chunk, carried state included; the port's stream against its own batch
decode, 1e-5 absolute (the same ops in the same order, on other
lengths). bf16: the stream's largest distance to the float32 batch
decode stays within twice the bf16 batch decode's own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.models.codec import firefly as jfire
from fish_speech_tpu.models.codec import firefly_stream as jstream
from fish_speech_tpu.models.codec import stream_conv as jsc
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.io.convert import firefly_params_from_numpy
from fish_speech_tpu_torch.models.codec import firefly_stream as tstream
from fish_speech_tpu_torch.models.codec import stream_conv as tsc
from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec
from test_torch_codec import HEAD, QUANT

torch.set_num_threads(1)
TOL = 1e-4
SELF_TOL = 1e-5
ACCURACY_FACTOR = 2.0
N = 37  # frames
CHUNKINGS = [[37], [5, 16, 16], [1] * 37, [2, 3, 32]]


def _cfgs(version="1.5"):
    jv, tv = jcfg.FishVersion(version), tcfg.FishVersion(version)
    jc = jcfg.FireflyConfig(
        spec_transform=jcfg.SpecTransformConfig(hop_length=4),
        backbone=jcfg.BackboneConfig(input_channels=8, depths=(1,), dims=(16,)),
        head=jcfg.HiFiGANConfig(**HEAD), quantizer=jcfg.DownsampleFSQConfig(**QUANT),
        version=jv)
    tc = tcfg.FireflyConfig(
        spec_transform=tcfg.SpecTransformConfig(hop_length=4),
        head=tcfg.HiFiGANConfig(**HEAD), quantizer=tcfg.DownsampleFSQConfig(**QUANT),
        version=tv)
    return jc, tc


def _params(jc, seed=0):
    """The JAX initialiser's tree filled from a numpy seed (every bias and
    the layer scale nonzero), and its port conversion."""
    shapes = jax.eval_shape(
        lambda: jfire.init_firefly_params(jax.random.PRNGKey(0), jc, jnp.float32))
    leaves, tree = jax.tree.flatten(shapes)
    rng = np.random.default_rng(seed)
    leaves = [jnp.asarray(rng.normal(size=l.shape).astype(np.float32) * 0.2) for l in leaves]
    params = jax.tree.unflatten(tree, leaves)
    return params, firefly_params_from_numpy(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def setup():
    jc, tc = _cfgs()
    params, tparams = _params(jc)
    codes = np.random.default_rng(5).integers(0, 1000, size=(2, 2, N)).astype(np.int32)
    return jc, tc, params, tparams, codes


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def _pieces(chunking):
    s = 0
    for n in chunking:
        yield s, s + n
        s += n


@pytest.mark.parametrize("kind", ["conv", "conv_dilated", "conv_grouped", "transpose",
                                  "transpose_grouped"])
def test_stream_convs_match_jax_chunk_by_chunk(kind):
    rng = np.random.default_rng(1)
    groups = 2 if kind.endswith("grouped") else 1
    x = rng.normal(size=(2, 4, 23)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    if kind.startswith("conv"):
        d = 3 if kind == "conv_dilated" else 1
        w = rng.normal(size=(6, 4 // groups, 5)).astype(np.float32)
        kw = dict(dilation=d, groups=groups)
        jfn, tfn = jsc.stream_conv1d, tsc.stream_conv1d
        jstate, tstate = jsc.conv_state(2, 4, 5, dilation=d), tsc.conv_state(2, 4, 5, dilation=d)
    else:
        w = rng.normal(size=(4, 6 // groups, 5)).astype(np.float32)  # (I, O/groups, K)
        kw = dict(stride=2, groups=groups)
        jfn, tfn = jsc.stream_conv_transpose1d, tsc.stream_conv_transpose1d
        jstate = jsc.conv_transpose_state(2, 6, 5, stride=2)
        tstate = tsc.conv_transpose_state(2, 6, 5, stride=2)
    for a, e in _pieces([1, 4, 7, 11]):
        jout, jstate = jfn(jnp.asarray(x[..., a:e]), jnp.asarray(w), jnp.asarray(b), jstate, **kw)
        tout, tstate = tfn(torch.from_numpy(x[..., a:e]), torch.from_numpy(w),
                           torch.from_numpy(b), tstate, **kw)
        _close(tout, jout)
        _close(tstate, jstate)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


@pytest.mark.parametrize("chunking", CHUNKINGS, ids=lambda c: f"{len(c)}pieces")
def test_decode_step_matches_jax(setup, chunking):
    """firefly_decode_step chunk by chunk: each chunk's PCM and the carried
    state after it equal JAX's within 1e-4."""
    jc, tc, params, tparams, codes = setup
    jstate = jstream.stream_state_init(params, jc, batch=2)
    tstate = tstream.stream_state_init(tparams, tc, batch=2)
    step = jax.jit(lambda p, c, s: jstream.firefly_decode_step(c, p, jc, s))
    for a, e in _pieces(chunking):
        jout, jstate = step(params, jnp.asarray(codes[..., a:e]), jstate)
        tout, tstate = tstream.firefly_decode_step(torch.from_numpy(codes[..., a:e]), tparams,
                                                   tc, tstate)
        assert tout.shape == (2, 1, (e - a) * tc.samples_per_frame)
        _close(tout, jout)
    jflat, tflat = _flat(jstate), _flat(tstate)
    assert len(jflat) == len(tflat)
    for t, j in zip(tflat, jflat):
        _close(t, j)


@pytest.mark.parametrize("chunking", [[37], [5, 16, 16]], ids=lambda c: f"{len(c)}pieces")
def test_codec_decode_step_matches_jax(setup, chunking):
    """FireflyCodec.decode_step on numpy codes, (C, t) at batch 1 and
    (B, C, t): float32 numpy PCM of each chunk as JAX's codec gives it
    (1e-4), and the chunks concatenate to the port's batch decode (1e-5)."""
    jc, tc, params, tparams, codes = setup
    codec = FireflyCodec(tparams, tc, device="cpu")
    jcodec = jfire.FireflyCodec(params, jc, buckets=(8, 16, 32, 64))
    for batch_codes in (codes[0], codes):
        b = 1 if batch_codes.ndim == 2 else batch_codes.shape[0]
        state = codec.stream_template(b)
        jstate = jstream.stream_state_init(params, jc, batch=b)
        got = []
        for a, e in _pieces(chunking):
            pcm, state = codec.decode_step(batch_codes[..., a:e], state)
            jpcm, jstate = jcodec.decode_step(batch_codes[..., a:e], jstate)
            assert isinstance(pcm, np.ndarray) and pcm.dtype == np.float32
            assert pcm.shape == (b, (e - a) * tc.samples_per_frame)
            np.testing.assert_allclose(pcm, jpcm, rtol=TOL, atol=TOL)
            got.append(pcm)
        np.testing.assert_allclose(np.concatenate(got, axis=-1), codec.decode(batch_codes),
                                   rtol=0, atol=SELF_TOL)


@pytest.mark.parametrize("chunking", CHUNKINGS, ids=lambda c: f"{len(c)}pieces")
def test_session_matches_jax_and_own_batch_decode(setup, chunking):
    """The port's session against JAX's (1e-4) and against the port's own
    whole-sequence decode (1e-5)."""
    jc, tc, params, tparams, codes = setup
    codec = FireflyCodec(tparams, tc, device="cpu")
    jcodec = jfire.FireflyCodec(params, jc, buckets=(8, 16, 32, 64))
    sess, jsess = codec.start_stream(batch=2, max_step_frames=64), jcodec.start_stream(
        batch=2, max_step_frames=64)
    got, ref = [], []
    for a, e in _pieces(chunking):
        got.append(sess.feed(codes[..., a:e]))
        ref.append(jsess.feed(codes[..., a:e]))
    got, ref = np.concatenate(got, axis=-1), np.concatenate(ref, axis=-1)
    assert got.dtype == np.float32 and got.shape == (2, N * tc.samples_per_frame)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, codec.decode(codes), rtol=0, atol=SELF_TOL)


@pytest.mark.parametrize("max_step", [1, 4, 64])
def test_piece_size_does_not_change_the_pcm(setup, max_step):
    """A feed is split into pieces of at most max_step frames (JAX splits
    into powers of two); the PCM is the batch decode's either way, and
    feed_async with pad_to gives the same real samples."""
    _, tc, _, tparams, codes = setup
    codec = FireflyCodec(tparams, tc, device="cpu")
    ref = codec.decode(codes)
    sess = codec.start_stream(batch=2, max_step_frames=max_step)
    assert sess.max_step == max_step
    np.testing.assert_allclose(sess.feed(codes), ref, rtol=0, atol=SELF_TOL)
    sess.reset()
    spf = tc.samples_per_frame
    parts = []
    for a, e in _pieces([16, 16, 5]):
        audio, t = sess.feed_async(codes[..., a:e], pad_to=16)
        assert t == e - a and audio.shape == (2, 16 * spf)
        parts.append(audio[:, :t * spf].numpy())
    np.testing.assert_allclose(np.concatenate(parts, axis=-1), ref, rtol=0, atol=SELF_TOL)


def test_reset_restarts_the_stream(setup):
    _, tc, _, tparams, codes = setup
    codec = FireflyCodec(tparams, tc, device="cpu")
    sess = codec.start_stream(batch=2, max_step_frames=8)
    first = sess.feed(codes[..., :9])
    sess.feed(codes[..., 9:20])
    sess.reset()
    np.testing.assert_array_equal(sess.feed(codes[..., :9]), first)
    sess.reset(batch=1)
    assert sess.batch == 1
    np.testing.assert_allclose(sess.feed(codes[0, :, :9]), first[:1], rtol=0, atol=SELF_TOL)
    # the zero template is shared by sessions and never written
    assert all(float(t.abs().max()) == 0 for t in _flat(codec.stream_template(2)) if t.numel())


def test_fish_1_2_is_not_streamable():
    jc, tc = _cfgs("1.2")
    _, tparams = _params(jc)
    codec = FireflyCodec(tparams, tc, device="cpu")
    assert not codec.can_stream
    with pytest.raises(ValueError, match="not streamable"):
        codec.start_stream()
    with pytest.raises(ValueError, match="1.2"):
        tstream.stream_state_init(tparams, tc)
    assert FireflyCodec(_params(_cfgs()[0])[1], _cfgs()[1], device="cpu").can_stream


def test_bf16_stream_tracks_float32(setup):
    """A bf16 codec's stream is as close to the float32 batch decode as
    the bf16 batch decode is, within ACCURACY_FACTOR on the largest
    error."""
    _, tc, _, tparams, codes = setup
    ref = FireflyCodec(tparams, tc, device="cpu").decode(codes)
    codec16 = FireflyCodec(jax.tree.map(lambda t: t.to(torch.bfloat16), tparams), tc,
                           device="cpu")
    sess = codec16.start_stream(batch=2, max_step_frames=16)
    got = np.concatenate([sess.feed(codes[..., a:e]) for a, e in _pieces([5, 16, 16])],
                         axis=-1)
    batch_err = float(np.abs(codec16.decode(codes) - ref).max())
    stream_err = float(np.abs(got - ref).max())
    assert np.isfinite(got).all() and 0 < batch_err
    assert stream_err <= ACCURACY_FACTOR * batch_err, (stream_err, batch_err)


def test_decode_tail_and_frames_for_samples_match_jax(setup):
    jc, tc, params, tparams, codes = setup
    codec = FireflyCodec(tparams, tc, device="cpu")
    jcodec = jfire.FireflyCodec(params, jc, buckets=(8, 16, 32, 64))
    for new, ctx in ((5, 8), (37, 4), (3, 40)):
        got = codec.decode_tail(codes[0], new, context_frames=ctx)
        np.testing.assert_allclose(got, jcodec.decode_tail(codes[0], new, context_frames=ctx),
                                   rtol=TOL, atol=TOL)
        assert got.shape == (min(new, N) * tc.samples_per_frame,)
    # a context that covers the receptive field gives the whole decode's tail
    whole = codec.decode(codes[:1])[0]
    np.testing.assert_allclose(codec.decode_tail(codes[0], 5, context_frames=32),
                               whole[-5 * tc.samples_per_frame:], rtol=0, atol=SELF_TOL)
    for n in (0, 1, 100, 1023, 1024, 4096, 44100, 123457):
        assert codec.frames_for_samples(n) == jcodec.frames_for_samples(n), n
