"""The port's dynamic (per-row) sampling against the JAX package's:
`sample_top_k_top_p_dynamic`, `legacy_pad_eos_sample_rows` (the port's
`legacy_pad_eos_sample` on per-row uniforms),
`RepPenWindow.penalize_rows` and `RowSampling`, fed the JAX package's own
per-row draws; token streams must be exactly equal.

Also home of `JaxRowNoise`, which replays the JAX dynamic engine's
per-row key chains (fish_speech_tpu/generate/engine.py: `init_state`,
`split_row_keys`, `_row_key`) as a drop-in for the port's `RowNoise`, so
engine tests can run both engines on the same draws."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.ops import sampling as js
from fish_speech_tpu_torch.generate.frame import FrameNoise, NoiseLayout, RowNoise
from fish_speech_tpu_torch.ops import sampling as ts

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_frame_noise(frame_keys, layout: NoiseLayout) -> FrameNoise:
    """The draws that the JAX dynamic frame makes from per-row frame keys
    (B, 2): each key splits into C+1 keys, the first for the semantic
    head (k Gumbel draws, or one uniform for Fish <= 1.4), then one per
    codebook step (k_dyn Gumbel draws)."""
    ks = jax.vmap(lambda k: jax.random.split(k, layout.codebooks + 1))(frame_keys)
    if layout.semantic == 0:
        sem = jax.vmap(lambda k: jax.random.uniform(k, ()))(ks[:, 0])
    else:
        sem = jax.vmap(lambda k: jax.random.gumbel(k, (layout.semantic,), jnp.float32))(ks[:, 0])
    cbs = jax.vmap(jax.vmap(lambda k: jax.random.gumbel(k, (layout.k_dyn,), jnp.float32)))(
        ks[:, 1:])
    return FrameNoise(semantic=_t(sem), codebooks=_t(cbs))


def jax_row_key(seed: int):
    """The JAX engine's admission key data for a seed (`_row_key`)."""
    seed = int(seed) & 0x7FFFFFFF
    return jnp.asarray(np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32))


class JaxRowNoise:
    """`RowNoise`'s interface on the JAX engine's per-row key chains:
    init_state seeds row r with PRNGKey(seed + r); every frame splits
    (chain, frame key); an admission splits its row key into (chain, the
    admission frame's key)."""

    def __init__(self, batch: int, seed: int):
        self.chains = [jax.random.PRNGKey((seed + r) & 0xFFFFFFFF) for r in range(batch)]
        self.pending = [None] * batch

    def reseed(self, row: int, seed: int) -> None:
        ks = jax.random.split(jax_row_key(seed), 2)
        self.chains[row], self.pending[row] = ks[0], ks[1]

    def frame(self, rows, layout: NoiseLayout) -> FrameNoise:
        keys = []
        for r in rows:
            if self.pending[r] is not None:
                keys.append(self.pending[r])
                self.pending[r] = None
            else:
                self.chains[r], fk = jax.random.split(self.chains[r])
                keys.append(fk)
        return jax_frame_noise(jnp.stack(keys), layout)


EDGE = dict(temp=[0.0, 1.0, 1.0, 1.0], top_p=[0.5, 1.0, 0.0, 0.5], top_k=[4, 0, 99, 1])


def _knobs(rng, b):
    return dict(temp=rng.choice([0.0, 0.5, 0.7, 1.2], b).astype(np.float32),
                top_p=rng.choice([0.0, 0.6, 0.8, 1.0, 1.5], b).astype(np.float32),
                top_k=rng.choice([0, 1, 4, 16, 99, -3], b).astype(np.int32))


@pytest.mark.parametrize("case", ["edge", "random0", "random1", "bf16_ties"])
def test_dynamic_sampler_matches_jax(case):
    """Per-row temp/top_p/top_k, including the edge operands of
    tests/test_dynamic_sampling.py::test_edge_operands (temp 0, top_p
    0 and 1, top_k 0 and > k_max, top_k 1), on JAX's own Gumbel draws."""
    rng = np.random.default_rng(["edge", "random0", "random1", "bf16_ties"].index(case))
    if case == "edge":
        knobs = {k: np.array(v, np.float32 if k != "top_k" else np.int32)
                 for k, v in EDGE.items()}
        b, vocab, k_max = 4, 16, 8
    else:
        b, vocab, k_max = 12, 40, 32
        knobs = _knobs(rng, b)
    logits = rng.normal(size=(b, vocab)).astype(np.float32) * 3
    if case == "bf16_ties":  # many equal values: the top-k order of ties
        logits = np.asarray(jnp.asarray(logits, jnp.bfloat16).astype(jnp.float32))
    keys = jnp.stack([jax.random.PRNGKey(50 + i) for i in range(b)])
    ref = js.sample_top_k_top_p_dynamic(
        jnp.asarray(logits), keys, temp=jnp.asarray(knobs["temp"]),
        top_p=jnp.asarray(knobs["top_p"]), top_k=jnp.asarray(knobs["top_k"]), k_max=k_max)
    k = min(k_max, vocab)
    gumbel = jax.vmap(lambda kk: jax.random.gumbel(kk, (k,), dtype=jnp.float32))(keys)
    got = ts.sample_top_k_top_p_dynamic(
        _t(logits), _t(gumbel), temp=_t(knobs["temp"]), top_p=_t(knobs["top_p"]),
        top_k=_t(knobs["top_k"]), k_max=k_max)
    assert got.dtype == torch.int32 and got.shape == (b,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if case == "edge":
        assert int(got[0]) == int(np.argmax(logits[0]))  # temp 0
        assert int(got[3]) == int(np.argmax(logits[3]))  # top_k 1


def test_dynamic_sampler_rows_are_independent():
    """A row's token depends on its own logits, knobs and draws only."""
    rng = np.random.default_rng(3)
    logits = _t(rng.normal(size=(6, 30)).astype(np.float32))
    gumbel = _t(rng.gumbel(size=(6, 16)).astype(np.float32))
    knobs = {k: _t(v) for k, v in _knobs(rng, 6).items()}
    full = ts.sample_top_k_top_p_dynamic(logits, gumbel, k_max=16, **knobs)
    for r in range(6):
        one = ts.sample_top_k_top_p_dynamic(logits[r:r + 1], gumbel[r:r + 1], k_max=16,
                                            **{k: v[r:r + 1] for k, v in knobs.items()})
        assert int(one[0]) == int(full[r])


def test_legacy_pad_eos_rows_matches_jax():
    rng = np.random.default_rng(4)
    pad, eos = (rng.normal(size=(8,)).astype(np.float32) for _ in range(2))
    keys = jnp.stack([jax.random.PRNGKey(i) for i in range(8)])
    ref = js.legacy_pad_eos_sample_rows(jnp.asarray(pad), jnp.asarray(eos), 5, 9, keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, ()))(keys)
    got = ts.legacy_pad_eos_sample(_t(pad), _t(eos), 5, 9, uniform=_t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_penalize_rows_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(4, 1, 20)).astype(np.float32)
    tokens = rng.integers(-1, 20, size=(4, 3, 12)).astype(np.int32)
    pen = np.array([1.0, 1.3, 0.8, 2.0], np.float32)
    ref = js.RepPenWindow(jnp.asarray(tokens[:, 0]), jnp.int32(0)).penalize_rows(
        jnp.asarray(logits[:, 0]), jnp.asarray(pen))
    got = ts.RepPenWindow(_t(tokens[:, 0]), 0).penalize_rows(_t(logits[:, 0]), _t(pen))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(got[0], _t(logits[0, 0]))  # penalty 1.0 changes nothing


def test_row_sampling_matches_jax():
    args = [js.SamplingArgs(temp=0.0, top_p=0.9, top_k=8, repetition_penalty=1.1),
            js.SamplingArgs(temp=1.2, top_p=0.5, top_k=0, repetition_penalty=1.0)]
    targs = [ts.SamplingArgs(**dataclasses.asdict(a)) for a in args]
    ref = js.RowSampling.broadcast(js.SamplingArgs(), 5).set_rows(
        2, jnp.stack([js.RowSampling.row_vector(a) for a in args]))
    got = ts.RowSampling.broadcast(ts.SamplingArgs(), 5).set_rows(
        2, _t(np.stack([ts.RowSampling.row_vector(a) for a in targs])))
    for name in ("temp", "top_p", "top_k", "rep_pen"):
        r, g = np.asarray(getattr(ref, name)), getattr(got, name)
        assert g.dtype == _t(r).dtype and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), r)
    assert ts.BATCHED_REP_PEN_WINDOW == js.BATCHED_REP_PEN_WINDOW


@pytest.mark.parametrize("legacy", [False, True])
def test_row_noise_streams_depend_on_own_seed_only(legacy):
    """RowNoise: one stream per row; reseeding a row restarts its stream
    and leaves the others; a row's frames do not depend on which other
    rows draw."""
    layout = NoiseLayout(semantic=0 if legacy else 9, codebooks=3, k_dyn=8)
    a, b = RowNoise(4, 7, "cpu"), RowNoise(4, 7, "cpu")
    fa = a.frame(range(4), layout)
    fb = b.frame([2], layout)
    assert torch.equal(fa.semantic[2], fb.semantic[0])
    assert torch.equal(fa.codebooks[2], fb.codebooks[0])
    assert fa.codebooks.shape == (4, 3, 8)
    assert fa.semantic.shape == ((4,) if legacy else (4, 9))
    a.reseed(1, 99)
    b.reseed(3, 99)
    assert torch.equal(a.frame([1], layout).codebooks, b.frame([3], layout).codebooks)


def test_jax_row_noise_replays_the_jax_engine_chain():
    """The replayer's admission and decode keys are the JAX engine's:
    split(row_key) at admission, split_row_keys every frame after."""
    layout = NoiseLayout(semantic=5, codebooks=2, k_dyn=4)
    noise = JaxRowNoise(2, 0)
    noise.reseed(1, 42)
    first = noise.frame([1], layout)
    ks = jax.random.split(jax_row_key(42), 2)
    np.testing.assert_array_equal(
        first.codebooks.numpy(), jax_frame_noise(ks[1][None], layout).codebooks.numpy())
    nxt = noise.frame([0, 1], layout)
    _, fk = js.split_row_keys(jnp.stack([jax.random.PRNGKey(0), ks[0]]))
    np.testing.assert_array_equal(nxt.semantic.numpy(), jax_frame_noise(fk, layout).semantic.numpy())
