"""The port's checkpoint IO against the JAX package's, on the same files:
raw reads (f32 / bf16 / F8 safetensors, zip .pth with weight-norm
parametrizations, a legacy .pth, a wrapped state_dict) and the LM and
Firefly loaders (Fish 1.2 bare names and 1.4+ `conv.` infix) bit-equal;
the writers' round trips (read back by the port, by the JAX loaders and
by the `safetensors` package); the shape check and the missing key; and
`resolve_checkpoint`, which does not fetch."""

import dataclasses

import pytest

# these CPU parity tests (no `cuda` case among them) write their files
# with the safetensors package; where it is missing they are not collected
pytest.importorskip("safetensors")

import jax
import jax.numpy as jnp
import numpy as np
import torch
from safetensors.numpy import load_file as st_load_numpy
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import save_file as st_save_torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.io import checkpoint as jck
from fish_speech_tpu.models.codec import firefly as jfire
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.io import checkpoint as tck
from fish_speech_tpu_torch.io import hub

torch.set_num_threads(1)

LM_KW = dict(vocab_size=64, n_layer=2, n_fast_layer=2, n_head=4, dim=32,
             intermediate_size=64, n_local_heads=2, head_dim=8, rope_base=10000.0,
             norm_eps=1e-6, max_seq_len=64, codebook_size=8, num_codebooks=2)
JCFG = jcfg.DualARConfig(**LM_KW)
TCFG = tcfg.DualARConfig(**LM_KW)

# tests/test_server.py's tiny codec, in both packages' config types
_SPEC = dict(sample_rate=44100, n_mels=20, n_fft=256, hop_length=64, win_length=256)
_BACKBONE = dict(input_channels=20, depths=(1, 1), dims=(16, 32), kernel_size=7)
_HEAD = dict(hop_length=64, upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
             resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),), num_mels=32,
             upsample_initial_channel=32, pre_conv_kernel_size=7, post_conv_kernel_size=7)
_QUANT = dict(input_dim=32, n_groups=2, n_codebooks=1, levels=(8, 5, 5, 5),
              downsample_factor=(2,))


def codec_cfgs(version="1.5", **quant):
    """(JAX, port) FireflyConfig of the tiny test codec (the port's
    configs leave out the JAX fields nothing reads: win_length and the
    head's hop_length)."""
    out = []
    for m, spec, head in ((jcfg, _SPEC, _HEAD),
                          (tcfg, dict(_SPEC, win_length=None), dict(_HEAD, hop_length=None))):
        out.append(m.FireflyConfig(
            spec_transform=m.SpecTransformConfig(**{k: v for k, v in spec.items() if v}),
            backbone=m.BackboneConfig(**_BACKBONE),
            head=m.HiFiGANConfig(**{k: v for k, v in head.items() if v}),
            quantizer=m.DownsampleFSQConfig(**{**_QUANT, **quant}),
            version=m.FishVersion(version)))
    return tuple(out)


def make_lm_state_dict(cfg, rng):
    """Upstream-named LM weights (the layout of tests/test_checkpoint.py)."""
    d, f = cfg.dim, cfg.ffn_dim
    qkv = (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim
    sd = {
        "embeddings.weight": rng.normal(size=(cfg.vocab_size, d)),
        "codebook_embeddings.weight": rng.normal(size=(cfg.codebook_size * cfg.num_codebooks, d)),
        "fast_embeddings.weight": rng.normal(size=(cfg.codebook_size, d)),
        "norm.weight": rng.normal(size=(d,)),
        "fast_norm.weight": rng.normal(size=(d,)),
        "output.weight": rng.normal(size=(cfg.vocab_size, d)),
        "fast_output.weight": rng.normal(size=(cfg.codebook_size, d)),
    }
    for prefix, n in [("layers", cfg.n_layer), ("fast_layers", cfg.n_fast_layer)]:
        for i in range(n):
            sd[f"{prefix}.{i}.attention.wqkv.weight"] = rng.normal(size=(qkv, d))
            sd[f"{prefix}.{i}.attention.wo.weight"] = rng.normal(size=(d, d))
            sd[f"{prefix}.{i}.feed_forward.w1.weight"] = rng.normal(size=(f, d))
            sd[f"{prefix}.{i}.feed_forward.w3.weight"] = rng.normal(size=(f, d))
            sd[f"{prefix}.{i}.feed_forward.w2.weight"] = rng.normal(size=(d, f))
            sd[f"{prefix}.{i}.attention_norm.weight"] = rng.normal(size=(d,))
            sd[f"{prefix}.{i}.ffn_norm.weight"] = rng.normal(size=(d,))
    return {k: v.astype(np.float32) for k, v in sd.items()}


def jax_codec_params(jc, seed=0, scale=0.3):
    """The JAX initialiser's tree, filled from a numpy seed so that every
    bias and layer scale is non-trivial."""
    shapes = jax.eval_shape(lambda: jfire.init_firefly_params(jax.random.PRNGKey(0), jc,
                                                              jnp.float32))
    leaves, tree = jax.tree.flatten(shapes)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(
        tree, [jnp.asarray(rng.normal(size=l.shape).astype(np.float32) * scale) for l in leaves])


def bits(x):
    """A leaf's bits: torch tensors and JAX / numpy arrays alike."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def assert_trees_bit_equal(got, ref, path="params"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), (path, set(got) ^ set(ref))
        for k in ref:
            assert_trees_bit_equal(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            assert_trees_bit_equal(a, b, f"{path}[{i}]")
    else:
        a, b = bits(got), bits(ref)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def assert_raw_equal(got, ref):
    """Same names, dtypes and bits (bf16 as bf16)."""
    assert set(got) == set(ref)
    for k in ref:
        a, b = bits(got[k]), bits(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


# -- raw reads ----------------------------------------------------------------


def _mixed_state_dict(rng):
    return {"a.weight": rng.normal(size=(3, 5)).astype(np.float32),
            "b.bias": rng.normal(size=(7,)).astype(np.float32),
            "scalar": np.asarray(rng.normal(), np.float32),
            "empty": np.zeros((0, 4), np.float32),
            "f64": rng.normal(size=(2, 2)),
            "f16": rng.normal(size=(4,)).astype(np.float16),
            "ids": rng.integers(-5, 5, size=(6,)).astype(np.int64),
            "i32": rng.integers(-5, 5, size=(2, 3)).astype(np.int32),
            "u8": rng.integers(0, 255, size=(5,)).astype(np.uint8)}


def test_safetensors_f32_and_mixed_equal(tmp_path):
    path = tmp_path / "m.safetensors"
    st_save_numpy(_mixed_state_dict(np.random.default_rng(0)), str(path))
    assert_raw_equal(tck.load_raw_checkpoint(path), jck.load_raw_checkpoint(path))


@pytest.mark.parametrize("fmt", ["safetensors", "pth_zip", "pth_legacy"])
def test_bf16_reads_equal(tmp_path, fmt):
    """bf16 weights read bit for bit: kept bf16 from safetensors, widened
    to float32 from both .pth formats, as the JAX reader does."""
    t = torch.randn(6, 9, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    sd = {"w.weight": t, "b": torch.randn(4).to(torch.bfloat16)}
    path = tmp_path / ("m.safetensors" if fmt == "safetensors" else "m.pth")
    if fmt == "safetensors":
        st_save_torch(sd, str(path))
    else:
        torch.save(sd, str(path), _use_new_zipfile_serialization=fmt == "pth_zip")
    got = tck.load_raw_checkpoint(path)
    assert_raw_equal(got, jck.load_raw_checkpoint(path))
    np.testing.assert_array_equal(got["w.weight"].float().numpy(), t.float().numpy())
    assert got["w.weight"].dtype == (torch.bfloat16 if fmt == "safetensors" else torch.float32)


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_f8_safetensors_widened_equal(tmp_path, dtype):
    """F8 tensors widen to float32 as the JAX fallback through the
    safetensors package widens them; the other tensors of the file too."""
    g = torch.Generator().manual_seed(2)
    sd = {"w8": torch.randn(5, 7, generator=g).to(dtype), "w32": torch.randn(3, generator=g),
          "w16": torch.randn(3, generator=g).to(torch.bfloat16), "ids": torch.arange(4)}
    path = tmp_path / "f8.safetensors"
    st_save_torch(sd, str(path))
    got = tck.load_raw_checkpoint(path)
    assert_raw_equal(got, jck.load_raw_checkpoint(path))
    np.testing.assert_array_equal(got["w8"].numpy(), sd["w8"].float().numpy())


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("wrapped", [False, True])
def test_pth_weight_norm_merge_equal(tmp_path, legacy, wrapped):
    """A Fish 1.2-style .pth: weight-norm parametrizations of convs and a
    transposed conv, merged to float32 weights bit-equal to the JAX
    merge, and within float32 rounding of torch's own weight."""
    torch.manual_seed(0)
    mods = torch.nn.ModuleDict({
        "conv": torch.nn.utils.parametrizations.weight_norm(torch.nn.Conv1d(4, 6, 5)),
        "up": torch.nn.utils.parametrizations.weight_norm(torch.nn.ConvTranspose1d(6, 3, 4)),
        "lin": torch.nn.Linear(3, 2),
    })
    with torch.no_grad():
        for m in (mods["conv"], mods["up"]):
            m.parametrizations.weight.original0.mul_(
                torch.rand_like(m.parametrizations.weight.original0) + 0.5)
    sd = mods.state_dict()
    assert any("parametrizations" in k for k in sd)
    path = tmp_path / "g.pth"
    torch.save({"state_dict": sd} if wrapped else sd, str(path),
               _use_new_zipfile_serialization=not legacy)
    got = tck.load_raw_checkpoint(path)
    assert_raw_equal(got, jck.load_raw_checkpoint(path))
    assert not any("parametrizations" in k for k in got)
    with torch.no_grad():
        np.testing.assert_allclose(got["conv.weight"].numpy(), mods["conv"].weight.numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["up.weight"].numpy(), mods["up"].weight.numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_unmapped_dtype_raises(tmp_path):
    path = tmp_path / "c.safetensors"
    st_save_torch({"c": torch.zeros(2, dtype=torch.complex64)}, str(path))
    with pytest.raises(ValueError, match="'c' has dtype C64"):
        tck.load_raw_checkpoint(path)


# -- the LM ---------------------------------------------------------------------


def _write_lm(tmp_path, fmt, seed=0, cfg=JCFG):
    sd = make_lm_state_dict(cfg, np.random.default_rng(seed))
    if fmt == "f32":
        st_save_numpy(sd, str(tmp_path / "model.safetensors"))
    elif fmt == "bf16":
        st_save_torch({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()},
                      str(tmp_path / "model.safetensors"))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(tmp_path / "model.pth"))
    return sd


@pytest.mark.parametrize("fmt", ["f32", "bf16", "pth"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_load_lm_params_bit_equal(tmp_path, fmt, dtype):
    _write_lm(tmp_path, fmt)
    ref = jax.tree.map(np.asarray, jck.load_lm_params(tmp_path, JCFG, dtype=getattr(jnp, dtype)))
    got = tck.load_lm_params(tmp_path, TCFG, dtype=getattr(torch, dtype), device="cpu")
    assert_trees_bit_equal(got, ref)
    assert got["slow"]["wqkv"].is_contiguous() and got["output"].is_contiguous()


def test_load_lm_params_tied(tmp_path):
    sd = make_lm_state_dict(JCFG, np.random.default_rng(1))
    del sd["output.weight"]
    st_save_numpy(sd, str(tmp_path / "model.safetensors"))
    jc = dataclasses.replace(JCFG, tie_word_embeddings=True)
    tc = dataclasses.replace(TCFG, tie_word_embeddings=True)
    ref = jax.tree.map(np.asarray, jck.load_lm_params(tmp_path, jc, dtype=jnp.float32))
    assert_trees_bit_equal(tck.load_lm_params(tmp_path, tc, torch.float32, "cpu"), ref)


@pytest.mark.parametrize("key,shape", [("embeddings.weight", (65, 32)),
                                       ("layers.1.attention.wqkv.weight", (63, 32)),
                                       ("fast_layers.0.feed_forward.w2.weight", (32, 65)),
                                       ("fast_norm.weight", (31,))])
def test_lm_shape_check_names_the_key(tmp_path, key, shape):
    """A tensor whose shape the config does not give raises, naming the
    key (the JAX loader reads shapes unchecked)."""
    sd = make_lm_state_dict(JCFG, np.random.default_rng(2))
    sd[key] = np.zeros(shape, np.float32)
    st_save_numpy(sd, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match=key.replace(".", r"\.") + r"' has shape"):
        tck.load_lm_params(tmp_path, TCFG, device="cpu")


def test_lm_missing_weight_and_qkv_bias_raise(tmp_path):
    sd = make_lm_state_dict(JCFG, np.random.default_rng(3))
    del sd["norm.weight"]
    st_save_numpy(sd, str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError, match="norm.weight"):
        tck.load_lm_params(tmp_path, TCFG, device="cpu")
    with pytest.raises(ValueError, match="qkv bias"):
        tck.load_lm_params(tmp_path, dataclasses.replace(TCFG, attention_qkv_bias=True),
                           device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="No weights file"):
        tck.load_lm_params(tmp_path / "empty", TCFG, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_lm_params_round_trips(tmp_path, dtype):
    """The port's writer: read back bit-equal by the port, by the JAX
    loader and by the safetensors package; and a file from the JAX
    writer reads back bit-equal through the port."""
    sd = _write_lm(tmp_path, "f32", seed=4)
    params = tck.load_lm_params(tmp_path, TCFG, dtype=getattr(torch, dtype), device="cpu")
    out = tmp_path / "out"
    out.mkdir()
    tck.save_lm_params(out / "model.safetensors", params, TCFG)
    assert_trees_bit_equal(tck.load_lm_params(out, TCFG, getattr(torch, dtype), "cpu"), params)
    assert_trees_bit_equal(
        jax.tree.map(np.asarray, jck.load_lm_params(out, JCFG, dtype=getattr(jnp, dtype))),
        params)
    if dtype == "float32":
        back = st_load_numpy(str(out / "model.safetensors"))
        assert set(back) == set(sd)
        for k in sd:
            np.testing.assert_array_equal(back[k], sd[k])
    jx = tmp_path / "jax"
    jx.mkdir()
    jparams = jck.load_lm_params(tmp_path, JCFG, dtype=getattr(jnp, dtype))
    jck.save_lm_params(jx / "model.safetensors", jparams, JCFG)
    assert_trees_bit_equal(tck.load_lm_params(jx, TCFG, getattr(torch, dtype), "cpu"),
                           jax.tree.map(np.asarray, jparams))


def test_save_safetensors_header_aligned(tmp_path):
    """The writer pads the header to 8 bytes, so every tensor is viewed in
    place; an unpadded file (the JAX writer's) is read all the same."""
    t = {"a": torch.arange(3, dtype=torch.int8), "b": torch.randn(5, 2)}
    tck.save_safetensors(tmp_path / "x.safetensors", t)
    raw = (tmp_path / "x.safetensors").read_bytes()
    assert (8 + int.from_bytes(raw[:8], "little")) % 8 == 0
    got = tck.load_raw_checkpoint(tmp_path / "x.safetensors")
    for k in t:
        assert torch.equal(got[k], t[k])
    jck.save_safetensors(tmp_path / "j.safetensors", {k: v.numpy() for k, v in t.items()})
    got = tck.load_raw_checkpoint(tmp_path / "j.safetensors")
    for k in t:
        assert torch.equal(got[k], t[k])


# -- the codec ------------------------------------------------------------------


@pytest.mark.parametrize("version", ["1.2", "1.5"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_firefly_params_bit_equal(tmp_path, version, dtype):
    """The whole tree (backbone, downsample, project_in, the decode
    halves), from a file in the version's key names, each written by
    the JAX tree's inverse: bit-equal to the JAX loader's."""
    jc, tc = codec_cfgs(version)
    params = jax_codec_params(jc)
    sd = {k: np.ascontiguousarray(bits(v)).astype(np.float32)
          for k, v in tck.firefly_state_dict(jax.tree.map(np.asarray, params), tc).items()}
    assert any(".conv.weight" in k for k in sd) == (version != "1.2")
    path = tmp_path / "firefly-gan-vq-fsq-8x1024-21hz-generator.safetensors"
    st_save_numpy(sd, str(path))
    ref = jax.tree.map(np.asarray, jck.load_firefly_params(tmp_path, jc,
                                                          dtype=getattr(jnp, dtype)))
    got = tck.load_firefly_params(tmp_path, tc, dtype=getattr(torch, dtype), device="cpu")
    assert_trees_bit_equal(got, ref)
    if dtype == "float32":
        assert_trees_bit_equal(got, jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("version", ["1.2", "1.5"])
def test_save_firefly_params_round_trips(tmp_path, version):
    """The port's codec writer: the port's and the JAX loader read it back
    bit-equal, and a wrong shape raises naming the key."""
    jc, tc = codec_cfgs(version)
    from fish_speech_tpu_torch.models.codec.firefly import init_firefly_params

    params = init_firefly_params(tc, seed=3, dtype=torch.float32, device="cpu")
    path = tmp_path / "firefly-gan-vq-fsq-8x1024-21hz-generator.safetensors"
    tck.save_firefly_params(path, params, tc)
    assert_trees_bit_equal(tck.load_firefly_params(path, tc, device="cpu"), params)
    assert_trees_bit_equal(jax.tree.map(np.asarray, jck.load_firefly_params(path, jc)), params)
    wrong = dataclasses.replace(tc, backbone=dataclasses.replace(tc.backbone, dims=(16, 48)))
    with pytest.raises(ValueError, match=r"'backbone\.downsample_layers\.1\.1\.weight' has shape"):
        tck.load_firefly_params(path, wrong, device="cpu")


# -- resolve_checkpoint -------------------------------------------------------


def test_resolve_checkpoint_directory(tmp_path):
    assert hub.resolve_checkpoint(tmp_path, tcfg.WhichModel.FISH_1_5) == tmp_path
    assert hub.resolve_checkpoint(str(tmp_path), tcfg.WhichModel.DUAL_AR) == tmp_path


@pytest.mark.parametrize("model", ["FISH_1_2", "FISH_1_4", "FISH_1_5", "DUAL_AR"])
def test_resolve_checkpoint_does_not_fetch(model):
    """A repo id or an empty string raises, naming the repo, the files and
    the version's pinned repo, and for dual_ar Mimi's repo and file; the
    tables are the JAX package's."""
    from fish_speech_tpu.io import hub as jhub

    m = tcfg.WhichModel[model]
    assert (hub.MIMI_REPO, hub.MIMI_FILE) == (jhub.MIMI_REPO, jhub.MIMI_FILE)
    assert hub.HUB_REPOS[m] == jhub.HUB_REPOS[jcfg.WhichModel[model]]
    assert hub._CODEC_FILES.get(m) == jhub._CODEC_FILES.get(jcfg.WhichModel[model])
    with pytest.raises(ValueError, match="does not fetch") as e:
        hub.resolve_checkpoint("someone/some-repo", m)
    assert "someone/some-repo" in str(e.value) and hub.HUB_REPOS[m] in str(e.value)
    assert "tokenizer.json" in str(e.value)
    assert (hub.MIMI_REPO in str(e.value)) == (model == "DUAL_AR")
    with pytest.raises(ValueError, match=hub.HUB_REPOS[m]):
        hub.resolve_checkpoint("", m)
