"""Sampling in the port (ops/sampling.py, generate/frame.py) against the
JAX package, fed the JAX package's own jax.random draws: tokens must be
exactly equal, including through the repetition-penalty window and the
fast codebook loop of one whole frame."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.generate.frame import generate_frame as j_generate_frame
from fish_speech_tpu.models.dual_ar import init_dual_ar_params
from fish_speech_tpu.ops import sampling as js
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.generate.frame import FrameNoise
from fish_speech_tpu_torch.generate.frame import generate_frame as t_generate_frame
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy
from fish_speech_tpu_torch.models.dual_ar import rope_tables
from fish_speech_tpu_torch.ops import sampling as ts

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("temp,top_p,top_k,vocab", [
    (0.7, 0.8, 16, 50),   # both filters active
    (1.0, 1.0, 64, 50),   # top_k wider than the vocab, no nucleus
    (0.3, 0.5, 256, 300),
    (0.0, 0.8, 16, 50),   # argmax
])
def test_sample_top_k_top_p_same_draws_same_tokens(temp, top_p, top_k, vocab):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(64, vocab)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = js.sample_top_k_top_p(jnp.asarray(logits), key, temp=temp, top_p=top_p, top_k=top_k)
    gumbel = jax.random.gumbel(key, (64, min(top_k, vocab)), dtype=jnp.float32)
    got = ts.sample_top_k_top_p(_t(logits), temp=temp, top_p=top_p, top_k=top_k,
                                gumbel=_t(gumbel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_generator_draws_are_reproducible():
    logits = torch.randn(4, 40, generator=torch.Generator().manual_seed(0))
    a, b = (ts.sample_top_k_top_p(logits, temp=0.7, top_p=0.8, top_k=16,
                                  generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a, b) and a.dtype == torch.int32


def test_legacy_pad_eos_same_uniforms():
    rng = np.random.default_rng(1)
    pad, eos = (rng.normal(size=(32,)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(3)
    ref = js.legacy_pad_eos_sample(jnp.asarray(pad), jnp.asarray(eos), 5, 9, key)
    u = jax.random.uniform(key, (32,))
    got = ts.legacy_pad_eos_sample(_t(pad), _t(eos), 5, 9, uniform=_t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_rep_pen_window_push_and_penalize():
    rng = np.random.default_rng(2)
    jw = js.RepPenWindow.init((2, 3), 4)
    tw = ts.RepPenWindow.init((2, 3), 4)
    logits = rng.normal(size=(2, 3, 10)).astype(np.float32)
    for step in range(6):  # wraps the ring
        new = rng.integers(0, 10, size=(2, 3)).astype(np.int32)
        jw, tw = jw.push(jnp.asarray(new)), tw.push(_t(new))
        np.testing.assert_array_equal(tw.tokens.numpy(), np.asarray(jw.tokens))
        assert tw.ptr == int(jw.ptr)
        np.testing.assert_array_equal(
            tw.penalize(_t(logits), 1.4).numpy(),
            np.asarray(jw.penalize(jnp.asarray(logits), 1.4)))


KW = dict(vocab_size=96, n_layer=2, n_fast_layer=1, n_head=4, dim=64, intermediate_size=128,
          n_local_heads=2, head_dim=16, rope_base=10000.0, norm_eps=1e-6, max_seq_len=64,
          codebook_size=32, num_codebooks=3)
TOK = dict(im_end_id=9, pad_id=5, semantic_start_id=10, semantic_end_id=41)


def test_generate_frame_same_draws_same_tokens():
    """One whole frame at temp 0.7 with rep-pen 1.4: the semantic draw
    and every codebook draw consume the JAX frame's own gumbel noise
    (same rng splits and shapes as fish_speech_tpu/generate/frame.py)."""
    jc, tc = jcfg.DualARConfig(**KW), tcfg.DualARConfig(**KW)
    jt, tt = jcfg.TokenConfig(**TOK), tcfg.TokenConfig(**TOK)
    params = jax.jit(init_dual_ar_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jc, jnp.float32)
    tparams = dual_ar_params_from_numpy(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(3)
    b, w = 4, 1 + jc.codebook_size
    logits = (rng.normal(size=(b, w)) * 2).astype(np.float32)
    hidden = rng.normal(size=(b, jc.dim)).astype(np.float32)
    prev = np.concatenate([rng.integers(10, 42, (b, 1)), rng.integers(0, 32, (b, 3))],
                          axis=1).astype(np.int32)
    window = rng.integers(0, 32, size=(b, 3, 16)).astype(np.int32)
    sampling_j = js.SamplingArgs(temp=0.7, top_p=0.8, top_k=16, repetition_penalty=1.4)
    sampling_t = ts.SamplingArgs(**dataclasses.asdict(sampling_j))
    key = jax.random.PRNGKey(11)

    ref = jax.jit(j_generate_frame, static_argnums=(1, 2, 3, 4))(
                           params, jc, jt, jcfg.WhichLM.FISH_1_5, sampling_j,
                           jnp.asarray(logits), jnp.asarray(hidden),
                           js.RepPenWindow(jnp.asarray(window), jnp.int32(5)),
                           jnp.asarray(prev), key)

    rest, sem_key = jax.random.split(key)
    cb_keys = jax.random.split(rest, jc.num_codebooks)
    noise = FrameNoise(
        semantic=_t(jax.random.gumbel(sem_key, (b, min(16, w)), dtype=jnp.float32)),
        codebooks=[_t(jax.random.gumbel(cb_keys[i], (b, 16), dtype=jnp.float32))
                   for i in range(jc.num_codebooks)],
    )
    got = t_generate_frame(tparams, tc, tt, tcfg.WhichLM.FISH_1_5, sampling_t, _t(logits),
                           _t(hidden), ts.RepPenWindow(_t(window), 5), _t(prev), noise,
                           rope_tables(tc, "cpu"))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.is_eos.numpy(), np.asarray(ref.is_eos))
    np.testing.assert_array_equal(got.rep_pen.tokens.numpy(), np.asarray(ref.rep_pen.tokens))


def _bf16_valued_logits(rows, vocab, seed):
    """N(0, 3^2) logits rounded to bf16, as the unfused heads give them:
    many tokens share a value, so the top-k order of ties matters."""
    rng = np.random.default_rng(seed)
    return np.asarray(jnp.asarray(rng.normal(size=(rows, vocab)) * 3.0, jnp.bfloat16)
                      .astype(jnp.float32))


@pytest.mark.parametrize("vocab", [1024, 1025])  # a codebook head, the gathered semantic head
def test_top_k_order_of_ties_is_lax_top_k(vocab):
    logits = _bf16_valued_logits(20, vocab, vocab)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits) / 0.7, axis=-1))
    assert all(len(np.unique(row[np.argsort(-row)[:256]])) < 256 for row in probs)  # ties
    ref_p, ref_i = jax.lax.top_k(jnp.asarray(probs), 256)
    got_p, got_i = ts.top_k_sorted(_t(probs), 256)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))


@pytest.mark.parametrize("vocab", [1024, 1025])
def test_bf16_valued_logits_same_draws_same_tokens(vocab):
    """200 draws at temp 0.7 / top_p 0.8 / top_k 256, each fed the
    Gumbel draws jax.random.gumbel(key, (1, 256)) that the JAX sampler
    makes from its key: the port's tokens equal the JAX package's."""
    logits = _bf16_valued_logits(200, vocab, 7 + vocab)
    kw = dict(temp=0.7, top_p=0.8, top_k=256)
    jax_sample = jax.jit(lambda row, key: js.sample_top_k_top_p(row, key, **kw))
    got, ref = [], []
    for i in range(200):
        key = jax.random.PRNGKey(1000 + i)
        row = logits[i:i + 1]
        ref.append(int(jax_sample(jnp.asarray(row), key)[0]))
        gumbel = jax.random.gumbel(key, (1, 256), dtype=jnp.float32)
        got.append(int(ts.sample_top_k_top_p(_t(row), gumbel=_t(gumbel), **kw)[0]))
    assert got == ref
