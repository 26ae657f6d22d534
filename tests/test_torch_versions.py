"""Fish 1.2, Fish 1.4 and DualAR at full width on the port's kernels,
with chip_smoke.py's `versions` phase configurations (no JAX here).

On the CPU: each version's full-width shapes lie in every fused
kernel's domain (the persistent slow step and fast frame, the row
kernel, the batched frame), with the plans the kernels would be launched
with on an H100's 132 SMs, and the semantic head each engine gathers (2
columns [PAD, <|im_end|>] for Fish <= 1.4, 2049 for DualAR) padded for
the row kernel. On the card (`cuda`): each of rows 3, 3b, 4 and 5 at the
versions' widths (depth cut to 2 slow and 2 fast layers) against its
plain version, as chip_smoke.py holds them (`check_version_kernels`),
and Mimi at kyutai/mimi's widths: its float32 decode within 1e-4 of the
CPU's and its stream in uneven pieces within 1e-4 of its batch decode
(`version_mimi`)."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.config import WhichLM
from fish_speech_tpu_torch.generate.engine import LMEngine
from fish_speech_tpu_torch.generate.frame import semantic_head_columns
from fish_speech_tpu_torch.ops import fast_frame as ff
from fish_speech_tpu_torch.ops import fast_frame_batched as fb
from fish_speech_tpu_torch.ops import slow_step as ss

REPO = Path(__file__).resolve().parent.parent
H100_SMS = 132
VERSIONS = ("1.2", "1.4", "dual_ar")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def smoke():
    return _smoke()


def _head_params(cfg, n_cols):
    """What the domain checks read of a parameter tree: bf16 stacks of the
    config's widths (zeros; only shapes and dtypes are read) and a head
    of n_cols columns."""
    d, f = cfg.dim, cfg.ffn_dim
    qkv = (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim

    def stack(n):
        z = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
        return {"wqkv": z(n, d, qkv), "wo": z(n, cfg.n_head * cfg.head_dim, d),
                "w1": z(n, d, f), "w3": z(n, d, f), "w2": z(n, f, d),
                "attention_norm": z(n, d), "ffn_norm": z(n, d)}

    return {"slow": stack(cfg.n_layer), "fast": stack(cfg.n_fast_layer),
            "output": torch.zeros((d, n_cols), dtype=torch.bfloat16),
            "fast_output": torch.zeros((d, cfg.fast_output_size), dtype=torch.bfloat16),
            "fast_embeddings": torch.zeros((cfg.fast_vocab_size, d), dtype=torch.bfloat16),
            "norm": torch.zeros((d,), dtype=torch.bfloat16),
            "fast_norm": torch.zeros((d,), dtype=torch.bfloat16)}


@pytest.mark.parametrize("version", VERSIONS)
def test_full_width_shapes_lie_in_every_kernels_domain(smoke, version):
    cfg, lm, tokenizer, tok, _ = smoke.version_setup(version)
    cols = semantic_head_columns(lm, tok, cfg)
    legacy = lm in (WhichLM.FISH_1_2, WhichLM.FISH_1_4)
    assert len(cols) == (2 if legacy else 1 + cfg.codebook_size)
    assert int(cols.max()) < cfg.vocab_size and int(cols.min()) >= 0
    if legacy:
        assert tuple(cols) == (tokenizer.token_to_id("<|semantic|>"),
                               tokenizer.token_to_id("<|im_end|>"))
    else:
        assert tok.semantic_end_id == tokenizer.token_to_id(
            f"<|semantic:{cfg.codebook_size - 1}|>") < cfg.vocab_size
    params = _head_params(cfg, len(cols))
    cache = smoke.SERVE_CACHE
    assert ss.jax_bounds_ok(cfg, 1, cache) and ss.jax_bounds_ok(cfg, smoke.SERVE_ROWS, cache)
    for int8 in (False, True):
        assert ss.slow_plan(cfg, len(cols), cache, int8, H100_SMS) is not None
        assert ss.rows_plan(cfg, len(cols), cache, int8, H100_SMS) is not None
        assert ff.fast_plan(cfg, int8, H100_SMS) is not None
        assert fb.frame_plan(cfg, min(256, cfg.codebook_size), int8, H100_SMS) is not None
    stride = ss.head_stride(len(cols))
    assert stride >= len(cols) and (stride * 2) % 16 == 0  # 16-byte pieces of bf16
    head = torch.arange(cfg.dim * len(cols), dtype=torch.float32).reshape(
        cfg.dim, len(cols)).to(torch.bfloat16)
    padded = ss.padded_head(head)
    assert padded.shape == (cfg.dim, stride) and torch.equal(padded[:, :len(cols)], head)
    assert not padded[:, len(cols):].any()
    assert fb.fused_fast_frame_batched_supported(cfg, params, smoke.SERVE_ROWS)


@pytest.mark.parametrize("version", VERSIONS)
def test_version_tokens_and_weights(smoke, version):
    """The stand-in tokenizer's ids fit the version's vocab; the random
    weights zero <|im_end|>'s head column and, for Fish <= 1.4, make the
    PAD column read embedding dimension 0 alone, which the kernel checks
    then leave out of the hidden state (`held_dims`); made on the CPU at
    a cut depth."""
    cfg, lm, tokenizer, tok, _ = smoke.version_setup(version)
    assert max(tokenizer.vocab.values()) < cfg.vocab_size
    small = dataclasses.replace(cfg, n_layer=1, n_fast_layer=1)
    params = smoke.version_params(torch, small, tok, "cpu")
    assert params["output"].device.type == "cpu"
    assert not params["output"][:, tok.im_end_id].any()
    legacy = tok.semantic_end_id is None
    if legacy:
        assert bool((params["embeddings"][:, 0] == 30).all())
        assert params["output"][0, tok.pad_id] == 1 and not params["output"][1:, tok.pad_id].any()
    assert smoke.held_dims(params) == int(legacy)


def _card_engines(smoke, version):
    cfg, lm, _, tok, _ = smoke.version_setup(version)
    cfg = dataclasses.replace(cfg, n_layer=2, n_fast_layer=2)
    params = smoke.version_params(torch, cfg, tok, "cuda")
    kw = dict(cache_len=smoke.SERVE_CACHE, prompt_buckets=(64,))
    engine = LMEngine(params, cfg, tok, lm, **kw)
    rows = LMEngine(params, cfg, tok, lm, batch_size=smoke.SERVE_ROWS, dynamic_sampling=True,
                    rep_pen_window=12, **kw)
    assert engine.use_fused_slow and engine.use_fused_fast
    assert rows.use_fused_slow and rows.use_fused_fast
    return engine, rows


@pytest.mark.cuda
@pytest.mark.parametrize("version", VERSIONS)
def test_cuda_kernels_at_the_versions_shapes(smoke, version):
    """Rows 3, 3b, 4 and 5 at the version's widths (2 + 2 layers) on its
    weights against their plain versions, as chip_smoke.py's versions
    phase holds them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    engine, rows = _card_engines(smoke, version)
    with torch.inference_mode():
        out = smoke.check_version_kernels(torch, version, engine, rows)
    assert set(out) == {"fused_slow_step", "slow_step_rows", "fused_fast_frame",
                        "fused_fast_frame_batched"}
    head = 2 if version != "dual_ar" else 2049
    assert f"head ({engine.cfg.dim},{head})" in out["fused_slow_step"]["shape"]
    assert all(k["bound_ms"] > 0 for k in out.values())


@pytest.mark.cuda
def test_cuda_mimi_decode_and_stream(smoke):
    """Mimi at kyutai/mimi's widths on random weights written and read
    back: the card's float32 decode within 1e-4 of the CPU's with TF32
    off, its stream in uneven pieces within 1e-4 of its batch decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    switches = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        codec, steps = smoke.version_mimi(torch, np, "the test's card")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = switches
    assert codec.device.type == "cuda" and set(steps) == {"1x16", "1x64", "16x16", "16x64"}
