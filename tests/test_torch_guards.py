"""Guards of the PyTorch port: it never imports JAX or the JAX package,
its entry points run on CUDA unless asked otherwise, and its WAV bytes
parse."""

import io
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.audio.wav import pcm_to_wav_bytes
from fish_speech_tpu_torch.generate.engine import LMEngine, _check_cuda_dtypes
from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec
from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params
from fish_speech_tpu_torch.ops.quant import quantize_lm_params

REPO = Path(__file__).resolve().parent.parent

_ONE_CPU_STEP = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from fish_speech_tpu_torch import config as c
from fish_speech_tpu_torch.generate.engine import LMEngine
from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params
from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec, init_firefly_params
from fish_speech_tpu_torch.audio.wav import pcm_to_wav_bytes
from fish_speech_tpu_torch.ops.sampling import SamplingArgs
import fish_speech_tpu_torch.io.convert

cfg = c.DualARConfig(vocab_size=64, n_layer=1, n_fast_layer=1, n_head=2, dim=32,
                     intermediate_size=64, n_local_heads=1, head_dim=16, rope_base=1e4,
                     norm_eps=1e-6, max_seq_len=32, codebook_size=8, num_codebooks=2)
tok = c.TokenConfig(im_end_id=1, pad_id=2, semantic_start_id=10, semantic_end_id=17)
engine = LMEngine(init_dual_ar_params(cfg, 0, torch.float32, "cpu"), cfg, tok,
                  c.WhichLM.FISH_1_5, prompt_buckets=(8,), device="cpu")
res, _ = engine.generate(np.zeros((3, 4), np.int32), max_new_tokens=2,
                         sampling=SamplingArgs(), seed=0)
fused = LMEngine(init_dual_ar_params(cfg, 0, torch.float32, "cpu"), cfg, tok,
                 c.WhichLM.FISH_1_5, prompt_buckets=(8,), device="cpu",
                 slow_impl="fused", fast_frame_impl="fused")
fused.generate(np.zeros((3, 4), np.int32), max_new_tokens=3, sampling=SamplingArgs(), seed=0)
from fish_speech_tpu_torch.generate.continuous import ContinuousBatcher
import fish_speech_tpu_torch.ops.fast_frame_batched
batched = LMEngine(init_dual_ar_params(cfg, 0, torch.float32, "cpu"), cfg, tok,
                   c.WhichLM.FISH_1_5, batch_size=2, prompt_buckets=(8,), device="cpu",
                   dynamic_sampling=True, slow_impl="fused", fast_frame_impl="fused")
batched.generate_batch([np.zeros((3, 4), np.int32)] * 2, max_new_tokens=3)
batcher = ContinuousBatcher(batched, SamplingArgs(), horizon=2)
assert len(list(batcher.submit([np.zeros((3, 4), np.int32)], 0, 3).iter_chunks(timeout=60))) == 1
batcher.shutdown()
fc = c.FireflyConfig(head=c.HiFiGANConfig(upsample_rates=(2,), upsample_kernel_sizes=(4,),
                                          resblock_kernel_sizes=(3,),
                                          resblock_dilation_sizes=((1,),), num_mels=8,
                                          upsample_initial_channel=8),
                     quantizer=c.DownsampleFSQConfig(input_dim=8, n_groups=2,
                                                     downsample_factor=(2,)))
codec = FireflyCodec(init_firefly_params(fc, 1, torch.float32, "cpu"), fc, device="cpu")
pcm_to_wav_bytes(codec.decode(np.zeros((2, 3), np.int32))[0], 44100)
int8 = LMEngine(init_dual_ar_params(cfg, 0, torch.float32, "cpu"), cfg, tok,
                c.WhichLM.FISH_1_5, prompt_buckets=(8,), device="cpu", quantize_int8=True,
                slow_impl="fused", fast_frame_impl="fused")
int8.generate(np.zeros((3, 4), np.int32), max_new_tokens=3, sampling=SamplingArgs(), seed=0)
import fish_speech_tpu_torch.ops.quant
from fish_speech_tpu_torch.utils import int8_policy
from fish_speech_tpu_torch.utils.quality import (
    mel_l1_distance, pcm_metrics, teacher_forced_agreement, teacher_forced_predictions)
import fish_speech_tpu_torch.train.loss
import fish_speech_tpu_torch.audio.mel
seq = np.concatenate([np.full((1, 6), 12), np.zeros((2, 6))]).astype(np.int32)
preds = teacher_forced_predictions(int8.params, cfg, tok, seq)
teacher_forced_agreement(preds, preds)
pcm = np.sin(np.arange(4096) * 0.01).astype(np.float32)
mel_l1_distance(pcm, pcm, c.SpecTransformConfig(), device="cpu")
pcm_metrics(pcm, pcm)
int8_policy.evaluate(1.0, 0.0, 0.0, 99.0)
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m.split(".")[0] == "fish_speech_tpu")
print("FORBIDDEN", bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    """A fresh interpreter imports the port, runs one CPU generation on
    the unfused and on the fused decode path, a batched dynamic
    generation and one batcher request, one decode, an int8 generation
    and the int8 decision machinery (quant, train/loss, audio/mel,
    utils/quality, utils/int8_policy), and holds no jax* and no
    fish_speech_tpu module."""
    out = subprocess.run([sys.executable, "-c", _ONE_CPU_STEP], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout


def test_no_jax_import_in_port_sources():
    files = list((REPO / "fish_speech_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0].rstrip(",")
                assert not top.startswith("jax"), f"{f}: {line}"
                assert top != "fish_speech_tpu", f"{f}: {line}"


def _tiny():
    cfg = tcfg.DualARConfig(vocab_size=64, n_layer=1, n_fast_layer=1, n_head=2, dim=32,
                            intermediate_size=64, n_local_heads=1, head_dim=16, rope_base=1e4,
                            norm_eps=1e-6, max_seq_len=32, codebook_size=8, num_codebooks=2)
    tok = tcfg.TokenConfig(im_end_id=1, pad_id=2, semantic_start_id=10, semantic_end_id=17)
    return cfg, tok


@pytest.mark.parametrize("entry", ["engine", "codec"])
def test_entry_points_default_to_cuda(entry):
    """With no device argument the entry points ask for CUDA, and raise
    where it is missing instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    cfg, tok = _tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "engine":
            LMEngine(init_dual_ar_params(cfg, 0, torch.float32, "cpu"), cfg, tok,
                     tcfg.WhichLM.FISH_1_5)
        else:
            FireflyCodec({}, tcfg.FireflyConfig())


def test_cuda_engine_takes_int8_only_with_bf16_scales():
    """What an engine on CUDA accepts: bf16 weights, or int8 q with bf16
    s; float32 scales, a float q or float32 weights beside int8 stacks
    are refused before a first prefill would."""
    cfg, _ = _tiny()
    params = quantize_lm_params(init_dual_ar_params(cfg, 0, torch.bfloat16, "cpu"))
    _check_cuda_dtypes(params, torch.bfloat16)
    w1 = params["slow"]["w1"]
    bad = {
        "float32 scales": {"q": w1["q"], "s": w1["s"].float()},
        "bf16 q": {"q": w1["q"].to(torch.bfloat16), "s": w1["s"]},
        "float32 q": {"q": w1["q"].float(), "s": w1["s"]},
    }
    for what, w in bad.items():
        with pytest.raises(ValueError, match="slow.w1"):
            _check_cuda_dtypes(dict(params, slow=dict(params["slow"], w1=w)), torch.bfloat16)
    with pytest.raises(ValueError, match="output"):
        _check_cuda_dtypes(dict(params, output=params["output"].float()), torch.bfloat16)
    with pytest.raises(ValueError, match="dtype=torch.float32"):
        _check_cuda_dtypes(params, torch.float32)


def test_wav_bytes_parse_and_clip():
    pcm = np.array([0.0, 0.5, -0.5, 2.0, -2.0], np.float32)
    data = pcm_to_wav_bytes(pcm, 44100)
    with wave.open(io.BytesIO(data)) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate(), w.getnframes()) == (
            1, 2, 44100, 5)
        frames = np.frombuffer(w.readframes(5), np.int16)
    np.testing.assert_array_equal(frames, [0, 16383, -16383, 32767, -32767])
