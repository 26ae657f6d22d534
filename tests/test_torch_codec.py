"""The port's Firefly decode side (fish_speech_tpu_torch/models/codec)
against the JAX package's, at a tiny configuration, on the same float32
parameters carried across by io/convert.py: FSQ lookup, grouped
residual FSQ, the Fish convolutions of versions 1.2 and 1.5, ConvNeXt,
the quantizer decode, HiFiGAN and the whole firefly_decode.

Tolerance 1e-4 absolute (float32; convolutions by XLA and by PyTorch sum
in other orders). FSQ codes are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.models.codec import conv as jconv
from fish_speech_tpu.models.codec import convnext as jconvnext
from fish_speech_tpu.models.codec import firefly as jfire
from fish_speech_tpu.models.codec import fsq as jfsq
from fish_speech_tpu.models.codec import grfsq as jgrfsq
from fish_speech_tpu.models.codec import hifigan as jhifi
from fish_speech_tpu.models.codec import quantizer as jquant
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.io.convert import firefly_params_from_numpy, tensor_from_numpy
from fish_speech_tpu_torch.models.codec import conv as tconv
from fish_speech_tpu_torch.models.codec import convnext as tconvnext
from fish_speech_tpu_torch.models.codec import firefly as tfire
from fish_speech_tpu_torch.models.codec import fsq as tfsq
from fish_speech_tpu_torch.models.codec import grfsq as tgrfsq
from fish_speech_tpu_torch.models.codec import hifigan as thifi
from fish_speech_tpu_torch.models.codec import quantizer as tquant

torch.set_num_threads(1)
TOL = 1e-4

HEAD = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
            resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)),
            num_mels=16, upsample_initial_channel=16, pre_conv_kernel_size=5,
            post_conv_kernel_size=5)
QUANT = dict(input_dim=16, n_codebooks=1, n_groups=2, levels=(8, 5, 5, 5),
             downsample_factor=(2, 2))


def _cfgs(version="1.5"):
    jv, tv = jcfg.FishVersion(version), tcfg.FishVersion(version)
    jc = jcfg.FireflyConfig(
        spec_transform=jcfg.SpecTransformConfig(hop_length=4),
        backbone=jcfg.BackboneConfig(input_channels=8, depths=(1,), dims=(16,)),
        head=jcfg.HiFiGANConfig(**HEAD), quantizer=jcfg.DownsampleFSQConfig(**QUANT),
        version=jv)
    tc = tcfg.FireflyConfig(
        spec_transform=tcfg.SpecTransformConfig(hop_length=4),
        backbone=tcfg.BackboneConfig(input_channels=8, depths=(1,), dims=(16,)),
        head=tcfg.HiFiGANConfig(**HEAD), quantizer=tcfg.DownsampleFSQConfig(**QUANT),
        version=tv)
    return jc, tc


@pytest.fixture(scope="module")
def codec():
    jc, tc = _cfgs()
    # the JAX initialiser's tree, filled from a numpy seed: its own draws
    # zero the biases and set the layer scale to 1e-6, and the parity
    # check should see every term
    shapes = jax.eval_shape(
        lambda: jfire.init_firefly_params(jax.random.PRNGKey(0), jc, jnp.float32))
    leaves, tree = jax.tree.flatten(shapes)
    rng = np.random.default_rng(0)
    leaves = [jnp.asarray(rng.normal(size=l.shape).astype(np.float32) * 0.2) for l in leaves]
    params = jax.tree.unflatten(tree, leaves)
    return jc, tc, params, firefly_params_from_numpy(jax.tree.map(np.asarray, params))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def _codes(rng, b=1, t=6):
    return rng.integers(0, 1000, size=(b, 2, t)).astype(np.int32)


def test_fsq_and_grouped_decode(codec):
    jc, tc, params, tparams = codec
    idx = np.arange(1000, dtype=np.int32).reshape(10, 100)
    _close(tfsq.indices_to_codes(_t(idx), (8, 5, 5, 5)),
           jfsq.indices_to_codes(jnp.asarray(idx), (8, 5, 5, 5)), 0)
    g = _codes(np.random.default_rng(1), 2, 5).transpose(1, 0, 2)[..., None]  # (G, B, T, Q)
    _close(tgrfsq.grouped_decode(_t(g), tparams["quantizer"]["rvqs"], tc.quantizer),
           jgrfsq.grouped_decode(jnp.asarray(g), params["quantizer"]["rvqs"], jc.quantizer))


@pytest.mark.parametrize("version", ["1.2", "1.5"])
@pytest.mark.parametrize("stride,dilation", [(1, 1), (1, 3), (2, 1)])
def test_fish_convs(version, stride, dilation):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 11)).astype(np.float32)
    p = {"w": rng.normal(size=(5, 6, 4)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    jv, tv = jcfg.FishVersion(version), tcfg.FishVersion(version)
    _close(tconv.fish_conv1d(_t(x), tp, stride=stride, dilation=dilation, version=tv, pad_1_2=2),
           jconv.fish_conv1d(jnp.asarray(x), jp, stride=stride, dilation=dilation,
                             version=jv, pad_1_2=2))
    pt = {"w": rng.normal(size=(6, 5, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    _close(tconv.fish_conv_transpose1d(_t(x), {k: _t(v) for k, v in pt.items()},
                                       stride=2, version=tv, pad_1_2=1),
           jconv.fish_conv_transpose1d(jnp.asarray(x), {k: jnp.asarray(v) for k, v in pt.items()},
                                       stride=2, version=jv, pad_1_2=1))


def test_convnext_block(codec):
    jc, tc, params, tparams = codec
    x = np.random.default_rng(3).normal(size=(1, 16, 9)).astype(np.float32)
    jb = params["quantizer"]["upsample"][0]["block"]
    tb = tparams["quantizer"]["upsample"][0]["block"]
    _close(tconvnext.convnext_block(_t(x), tb, version=tc.version),
           jconvnext.convnext_block(jnp.asarray(x), jb, version=jc.version))


def test_quantizer_and_hifigan(codec):
    jc, tc, params, tparams = codec
    codes = _codes(np.random.default_rng(4))
    jz = jax.jit(jquant.quantizer_decode, static_argnums=(2, 3))(
        jnp.asarray(codes), params["quantizer"], jc.quantizer, jc.version)
    tz = tquant.quantizer_decode(_t(codes), tparams["quantizer"], tc.quantizer, tc.version)
    _close(tz, jz)
    ja = jax.jit(jhifi.hifigan_forward, static_argnums=(2, 3))(jz, params["head"], jc.head,
                                                              jc.version)
    _close(thifi.hifigan_forward(tz, tparams["head"], tc.head, tc.version), ja)


@pytest.mark.parametrize("lengths", [None, (6, 4)])
def test_firefly_decode(codec, lengths):
    jc, tc, params, tparams = codec
    codes = _codes(np.random.default_rng(5), 2)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths)
    ref = jax.jit(jfire.firefly_decode, static_argnums=1)(params, jc, jnp.asarray(codes), jl)
    got = tfire.firefly_decode(tparams, tc, _t(codes), tl)
    assert got.shape == (2, 1, 6 * 4 * 4)
    _close(got, ref)


def test_codec_entry_point_on_cpu(codec):
    jc, tc, params, tparams = codec
    codes = _codes(np.random.default_rng(6))[0]
    pcm = tfire.FireflyCodec(tparams, tc, device="cpu").decode(codes)
    ref = jax.jit(jfire.firefly_decode, static_argnums=1)(params, jc, jnp.asarray(codes)[None])
    ref = ref[:, 0]
    np.testing.assert_allclose(pcm, np.asarray(ref), rtol=TOL, atol=TOL)


def test_bf16_leaves_carry_bit_for_bit():
    a = jnp.asarray(np.random.default_rng(7).normal(size=(3, 5)), jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(a))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(a.astype(jnp.float32)))


@pytest.mark.parametrize("version", ["1.2", "1.5"])
def test_init_matches_jax_tree_shapes(version):
    """The port's random init has the shapes of the JAX initialiser's
    tree, encode and decode halves, so converted and port-made parameters
    are alike."""
    jc, tc = _cfgs(version)
    shapes = jax.eval_shape(
        lambda: jfire.init_firefly_params(jax.random.PRNGKey(0), jc, jnp.float32))
    ref = firefly_params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    got = tfire.init_firefly_params(tc, seed=0, dtype=torch.float32, device="cpu")
    as_shapes = lambda tree: jax.tree.map(lambda t: tuple(t.shape), tree)  # noqa: E731
    assert as_shapes(got) == as_shapes(ref)
