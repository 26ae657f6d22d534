"""The port's Mimi codec (fish_speech_tpu_torch/models/codec/mimi.py)
against the JAX package's, on tests/test_mimi.py's tiny transformers-
built Mimi (random weights, codebooks randomised), in float32 on the CPU.

The decoder's last conv is scaled by 2^-4 (exact in float32), so the
PCM of these random weights peaks near 1, as audio does, where it would
peak near 15. Tolerances: the parts (SEANet encode and decode, the
transformer, split-RVQ decode) and the whole decode within 1e-5
absolute of JAX's (float32; XLA and PyTorch sum convolutions and
products in other orders); the port's stream within 1e-5 of its own
batch decode; RVQ codes exactly equal; an encode's codes equal wherever JAX's distance
margin between the nearest and the second-nearest centroid, at that
codebook and every earlier one of its RVQ, is 1e-3 or more (a code
nearer a tie may flip on float noise, and the residual carries it to the
later codebooks)."""

import pytest

pytest.importorskip("transformers")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from fish_speech_tpu.models.codec import mimi as jmimi  # noqa: E402
from fish_speech_tpu_torch.io.checkpoint import save_safetensors  # noqa: E402
from fish_speech_tpu_torch.io.convert import mimi_params_from_numpy  # noqa: E402
from fish_speech_tpu_torch.models.codec import mimi as tmimi  # noqa: E402
from fish_speech_tpu_torch.models.codec.stream_conv import tree_where  # noqa: E402
from test_mimi import models  # noqa: E402,F401 - the tiny transformers Mimi

torch.set_num_threads(1)
TOL = 1e-5
TIE_BAND = 1e-3
PCM_SCALE = 2.0**-4  # the decoder's last conv, weight and bias


def port_cfg(jc) -> tmimi.MimiConfig:
    return tmimi.MimiConfig(**{f.name: getattr(jc, f.name)
                               for f in dataclasses.fields(tmimi.MimiConfig)})


@pytest.fixture(scope="module")
def both(models):  # noqa: F811
    """(JAX cfg, JAX params, port cfg, port params, the transformers model)."""
    hf, jc, jp = models
    jp = jax.tree.map(lambda a: a, jp)  # a copy of the containers
    last = jp["decoder"]["layers"][-1]
    jp["decoder"]["layers"][-1] = {"w": last["w"] * PCM_SCALE, "b": last["b"] * PCM_SCALE}
    tp = mimi_params_from_numpy(jax.tree.map(np.asarray, jp))
    return jc, jp, port_cfg(jc), tp, hf


def _close(got, ref, atol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _codes(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.codebook_size, size=shape)


@pytest.mark.parametrize("part", ["seanet_encode", "seanet_decode", "transformer",
                                  "rvq_encode", "rvq_decode", "upsample", "downsample"])
def test_parts_match_jax(both, part):
    jc, jp, tc, tp, _ = both
    rng = np.random.default_rng(5)
    if part == "seanet_encode":
        x = rng.normal(size=(2, 1, jc.hop_length * 6 + 7)).astype(np.float32) * 0.1
        ref = jmimi.seanet_encode(jnp.asarray(x), jp["encoder"], jc)
        got = tmimi.seanet_encode(torch.from_numpy(x), tp["encoder"], tc)
    elif part == "seanet_decode":
        x = rng.normal(size=(2, jc.hidden_size, 9)).astype(np.float32)
        ref = jmimi.seanet_decode(jnp.asarray(x), jp["decoder"], jc)
        got = tmimi.seanet_decode(torch.from_numpy(x), tp["decoder"], tc)
    elif part == "transformer":  # 20 positions > the window of 6
        x = rng.normal(size=(2, 20, jc.hidden_size)).astype(np.float32)
        ref = jmimi.mimi_transformer(jnp.asarray(x), jp["decoder_transformer"], jc)
        got = tmimi.mimi_transformer(torch.from_numpy(x), tp["decoder_transformer"], tc)
    elif part == "rvq_encode":
        x = rng.normal(size=(2, jc.hidden_size, 11)).astype(np.float32)
        ref = jmimi.split_rvq_encode(jnp.asarray(x), jp["quantizer"], jc)
        got = tmimi.split_rvq_encode(torch.from_numpy(x), tp["quantizer"], tc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        return
    elif part == "rvq_decode":
        codes = _codes(jc, (2, jc.num_quantizers, 9), 6)
        ref = jmimi.split_rvq_decode(jnp.asarray(codes, jnp.int32), jp["quantizer"], jc)
        got = tmimi.split_rvq_decode(torch.from_numpy(codes), tp["quantizer"], tc)
    elif part == "upsample":
        x = rng.normal(size=(2, jc.hidden_size, 9)).astype(np.float32)
        ref = jmimi.mimi_conv_transpose1d(jnp.asarray(x), jp["upsample"]["w"], None, stride=2,
                                          groups=jc.upsample_groups)
        got = tmimi.mimi_conv_transpose1d(torch.from_numpy(x), tp["upsample"]["w"], None,
                                          stride=2, groups=tc.upsample_groups)
    else:  # the encoder's replicate-padded stride-2 conv, on an odd length
        x = rng.normal(size=(2, jc.hidden_size, 9)).astype(np.float32)
        ref = jmimi.mimi_conv1d(jnp.asarray(x), jp["downsample"]["w"], None, stride=2,
                                pad_mode="replicate")
        got = tmimi.mimi_conv1d(torch.from_numpy(x), tp["downsample"]["w"], None, stride=2,
                                pad_mode="replicate")
    _close(got.numpy(), ref)


@pytest.mark.parametrize("frames", [1, 9, 20, 33])
def test_decode_at_the_true_length_equals_the_jax_bucketed_decode(both, frames):
    """The JAX codec pads the codes to a bucket (16, 32, 64, ...) and trims;
    the port decodes the true length."""
    jc, jp, tc, tp, _ = both
    codes = _codes(jc, (2, 3, frames), frames)  # the LM's 3 of the 4 codebooks
    ref = jmimi.MimiCodec(jp, jc).decode(codes)
    got = tmimi.MimiCodec(tp, tc, device="cpu").decode(codes)
    assert got.dtype == np.float32 and got.shape == (2, frames * 160)
    _close(got, ref)


def test_decode_matches_transformers(both):
    """The port against transformers' MimiModel itself (test_mimi.py's
    tolerance for JAX)."""
    _, _, tc, tp, hf = both
    codes = _codes(tc, (1, tc.num_quantizers, 9), 0)
    with torch.no_grad():
        ref = hf.decode(torch.from_numpy(codes))[0].numpy()
    got = tmimi.MimiCodec(tp, tc, device="cpu").decode(codes)
    _close(got, ref[:, 0] * PCM_SCALE, atol=1e-3)


def _jax_margins(jc, jp, audio, n):
    """JAX's encode with each code's distance margin (second-nearest minus
    nearest centroid), (B, n, frames), at every codebook of both RVQs."""
    emb = jmimi.seanet_encode(jnp.asarray(audio), jp["encoder"], jc)
    emb = jmimi.mimi_transformer(emb.transpose(0, 2, 1), jp["encoder_transformer"],
                                 jc).transpose(0, 2, 1)
    emb = np.asarray(jmimi.mimi_conv1d(emb, jp["downsample"]["w"], None, stride=2,
                                       pad_mode="replicate"))
    ns = jc.num_semantic_quantizers
    margins = []
    for q, count in ((jp["quantizer"]["semantic"], ns), (jp["quantizer"]["acoustic"], n - ns)):
        res = np.einsum("oc,bct->bto", np.asarray(q["in_proj"]), emb)
        chain = np.full(res.shape[:2], np.inf)
        for i in range(count):
            cb = np.asarray(q["codebooks"][i])
            d = (np.sum(res**2, -1, keepdims=True) - 2.0 * res @ cb.T + np.sum(cb**2, -1))
            two = np.sort(d, axis=-1)[..., :2]
            chain = np.minimum(chain, two[..., 1] - two[..., 0])  # this and earlier codes
            margins.append(chain.copy())
            res = res - cb[np.argmin(d, axis=-1)]
    return np.stack(margins, axis=1)


def test_encode_codes_equal_outside_the_tie_band(both):
    jc, jp, tc, tp, _ = both
    rng = np.random.default_rng(1)
    audio = (rng.normal(size=(2, jc.hop_length * 14 + 13)) * 0.1).astype(np.float32)
    n = jc.num_quantizers - 1  # the codec's num_quantizers (an LM's codebooks)
    ref = np.asarray(jmimi.MimiCodec(jp, jc, num_quantizers=n).encode(audio))
    got = tmimi.MimiCodec(tp, tc, num_quantizers=n, device="cpu").encode(audio)
    assert got.dtype == np.int32 and got.shape == ref.shape and got.shape[:2] == (2, n)
    clear = _jax_margins(jc, jp, audio[:, None], n) >= TIE_BAND
    assert clear.mean() > 0.5  # the rule holds most codes
    np.testing.assert_array_equal(got[clear], ref[clear])


@pytest.mark.parametrize("pieces", [[1, 3, 4, 2, 4, 1, 5], [20], [7, 13]])
def test_stream_in_uneven_pieces_equals_the_batch_decode(both, pieces):
    """Carried conv tails, overlap-add tails and the KV ring (40
    transformer positions against a window of 6: several turns of the
    ring) give the batch decode of the prefix, piece by piece."""
    jc, jp, tc, tp, _ = both
    codec = tmimi.MimiCodec(tp, tc, device="cpu")
    codes = _codes(tc, (tc.num_quantizers, sum(pieces)), 3)
    ref = codec.decode(codes)
    session = codec.start_stream(max_step_frames=max(pieces))
    parts, i = [], 0
    for step in pieces:
        parts.append(session.feed(codes[:, i:i + step]))
        i += step
    _close(np.concatenate(parts, axis=-1), ref)
    _close(ref, jmimi.MimiCodec(jp, jc).decode(codes))


def test_feed_cuts_a_chunk_into_steps_the_ring_takes(both):
    """feed() cuts 20 frames into steps of max_step_frames; decode_step
    itself refuses more transformer positions than the ring's oversize,
    with has_resample two a frame."""
    _, _, tc, tp, _ = both
    codec = tmimi.MimiCodec(tp, tc, device="cpu")
    codes = _codes(tc, (tc.num_quantizers, 20), 8)
    session = codec.start_stream(max_step_frames=3)
    assert session.state["transformer"]["slot_pos"].shape == (1, tc.sliding_window + 6)
    _close(session.feed(codes), codec.decode(codes))
    codec.decode_step(codes[:, :3], codec.start_stream(max_step_frames=3).state)
    with pytest.raises(ValueError, match="at most 6 a call"):
        codec.decode_step(codes[:, :4], codec.start_stream(max_step_frames=3).state)


def test_reset_keeps_the_batch_and_starts_a_new_stream(both):
    _, _, tc, tp, _ = both
    codec = tmimi.MimiCodec(tp, tc, device="cpu")
    codes = _codes(tc, (2, tc.num_quantizers, 6), 6)
    session = codec.start_stream(batch=2, max_step_frames=4)
    session.feed(codes)
    template = session._template()
    session.reset()
    assert session.batch == 2 and session.state is template
    _close(session.feed(codes), codec.decode(codes))
    assert int(template["transformer"]["pos"].abs().sum()) == 0  # never written


def test_each_lane_keeps_its_own_stream(both):
    """What the central vocoder does to a 2-lane stream: lane 1 sits a
    step out (its state kept by a masked select) and lane 0 is reset
    mid-way (the masked select with the zero template); each lane's PCM
    is still its own codes' batch decode. The JAX ring shares one
    position across rows, so there lane 1 would attend at lane 0's
    positions."""
    _, _, tc, tp, _ = both
    codec = tmimi.MimiCodec(tp, tc, device="cpu")
    a, b, c = (_codes(tc, (tc.num_quantizers, 8), s) for s in (10, 11, 12))
    session = codec.start_stream(batch=2, max_step_frames=4)
    lane0, lane1 = [], []

    def step(codes0, codes1, keep1=False, reset0=False):
        state = session.state
        if reset0:
            state = tree_where(torch.tensor([True, False]), session._template(), state)
        pcm, new = codec.decode_step(np.stack([codes0, codes1]), state)
        if keep1:
            new = tree_where(torch.tensor([False, True]), state, new)
        session.state = new
        lane0.append(pcm[0])
        if not keep1:
            lane1.append(pcm[1])

    step(a[:, :4], b[:, :4])
    step(a[:, 4:8], b[:, 4:8] * 0, keep1=True)  # lane 1 sits out
    step(c[:, :4], b[:, 4:8], reset0=True)  # lane 0's next stream
    step(c[:, 4:8], b[:, :4] * 0, keep1=True)
    spf = codec.samples_per_frame
    whole0 = np.concatenate(lane0)
    _close(whole0[:8 * spf], codec.decode(a)[0])
    _close(whole0[8 * spf:], codec.decode(c)[0])
    _close(np.concatenate(lane1), codec.decode(b)[0])


def test_weights_through_the_ports_loader(both, tmp_path):
    """transformers' state dict written as model.safetensors and read by
    the port's reader equals JAX's conversion of the same state dict, bit
    for bit, whichever of the two is on the CPU; a config whose shapes
    the file does not hold is refused by name."""
    jc, _, tc, _, hf = both
    sd = {k: v.detach().contiguous() for k, v in hf.state_dict().items()}
    path = tmp_path / "model.safetensors"
    save_safetensors(path, sd)
    got = tmimi.load_mimi_params(path, tc, device="cpu")
    ref = mimi_params_from_numpy(jax.tree.map(np.asarray, jmimi.convert_mimi_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jc)))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, ref))
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert g.dtype == torch.float32 and torch.equal(g, r)
    with pytest.raises(ValueError, match="codebook.embed_sum"):
        tmimi.load_mimi_params(path, dataclasses.replace(tc, codebook_dim=8), device="cpu")
    with pytest.raises(KeyError, match="acoustic_residual_vector_quantizer.layers.3"):
        tmimi.load_mimi_params(path, dataclasses.replace(tc, num_quantizers=6), device="cpu")
    (tmp_path / "other.safetensors").write_bytes(b"")
    save_safetensors(tmp_path / "other.safetensors", {"embeddings.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="transformers-format Mimi"):
        tmimi.load_mimi_params(tmp_path / "other.safetensors", tc, device="cpu")


def test_state_shapes_are_transformers_names_and_shapes(both):
    """mimi_state_shapes (the loader's checks, the random weights) lists
    every tensor of transformers' model but the codebooks' `initialized`
    flags, with its shape."""
    _, _, tc, _, hf = both
    ref = {k: tuple(v.shape) for k, v in hf.state_dict().items()
           if not k.endswith("codebook.initialized")}
    assert tmimi.mimi_state_shapes(tc) == ref


def test_mimi_params_from_numpy(both):
    """The JAX tree's leaves as float32 CPU tensors, its None entries
    (the resampling convs' biases) left out, and a dtype cast."""
    _, jp, _, tp, _ = both
    assert set(tp) == set(jp) and "b" not in tp["upsample"]
    assert len(tp["decoder"]["layers"]) == len(jp["decoder"]["layers"])
    for g, r in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    bf = mimi_params_from_numpy(jax.tree.map(np.asarray, jp), dtype=torch.bfloat16)
    assert bf["quantizer"]["semantic"]["codebooks"][0].dtype == torch.bfloat16


def test_random_weights_load_and_decode(both, tmp_path):
    """random_mimi_state_dict at the tiny config: written, read back
    bit-equal to its conversion, and decoded to finite PCM."""
    _, _, tc, _, _ = both
    sd = tmimi.random_mimi_state_dict(tc, seed=2, device="cpu")
    save_safetensors(tmp_path / "mimi.safetensors", sd)
    params = tmimi.load_mimi_params(tmp_path / "mimi.safetensors", tc, device="cpu")
    ref = tmimi.convert_mimi_state_dict(sd, tc)
    for g, r in zip(jax.tree.leaves(params), jax.tree.leaves(ref)):
        assert torch.equal(g, r)
    pcm = tmimi.MimiCodec(params, tc, device="cpu").decode(_codes(tc, (4, 5), 1))
    assert pcm.shape == (1, 5 * 160) and np.isfinite(pcm).all() and np.abs(pcm).max() > 0
