"""Guards of the PyTorch port: it never imports JAX or the JAX package,
its entry points run on CUDA unless asked otherwise, and its WAV bytes
parse."""

import dataclasses
import io
import subprocess
import sys
import time
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
                                                     downsample_factor=(2,)),
                     backbone=c.BackboneConfig(depths=(1,), dims=(8,)))
codec = FireflyCodec(init_firefly_params(fc, 1, torch.float32, "cpu"), fc, device="cpu")
pcm_to_wav_bytes(codec.decode(np.zeros((2, 3), np.int32))[0], 44100)
import fish_speech_tpu_torch.models.codec.stream_conv
import fish_speech_tpu_torch.models.codec.firefly_stream
from fish_speech_tpu_torch.generate.overlap import generate_vocode_overlapped, output_shift
codec.start_stream().feed(np.zeros((2, 3), np.int32))
generate_vocode_overlapped(engine, codec, np.zeros((3, 4), np.int32), max_new_tokens=3, seed=0,
                           chunk=2, shift_fn=output_shift(c.WhichLM.FISH_1_5))
central = ContinuousBatcher(batched, SamplingArgs(), horizon=2, codec=codec)
events = list(central.submit([np.zeros((3, 4), np.int32)], 0, 3,
                             deliver_pcm=True).iter_events(timeout=60))
assert type(events[0]).__name__ == "_PartialPCM", events
central.shutdown()
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
import dataclasses, json, re, tempfile, pathlib, types
from fish_speech_tpu_torch.io.checkpoint import (
    load_firefly_params, load_lm_params, save_firefly_params, save_lm_params)
from fish_speech_tpu_torch.audio.resample import resample
from fish_speech_tpu_torch.audio.wav import read_wav, write_pcm_as_wav
from fish_speech_tpu_torch.cli import encoder, llama_generate, vocoder


class StandInTokenizer:  # what PromptEncoder calls, without the tokenizers package
    vocab = {"<|im_start|>": 3, "<|im_end|>": 1, "<|semantic|>": 2, "user": 4,
             "assistant": 5, "system": 6, "hi": 7, ".": 8,
             **{f"<|semantic:{i}|>": 10 + i for i in range(8)}}

    def token_to_id(self, token):
        return self.vocab.get(token)

    def encode(self, text, add_special_tokens=False):
        return types.SimpleNamespace(ids=[self.vocab.get(w, 0) for w in re.findall(
            r"<\|[^|]*\|>|\w+|[^\w\s]", text)])


llama_generate.load_tokenizer = lambda path: StandInTokenizer()
tmp = tempfile.TemporaryDirectory()
d = pathlib.Path(tmp.name)
save_lm_params(d / "model.safetensors", init_dual_ar_params(cfg, 0, torch.float32, "cpu"), cfg)
(d / "config.json").write_text(json.dumps({k: getattr(cfg, k) for k in (
    "vocab_size", "n_layer", "n_fast_layer", "n_head", "dim", "intermediate_size", "n_local_heads",
    "head_dim", "rope_base", "norm_eps", "max_seq_len", "codebook_size", "num_codebooks")}))
llama_generate.main(["--checkpoint", str(d), "--text", "hi . hi hi .", "--max-new-tokens", "2",
                     "--device", "cpu", "--out-path", str(d / "codes.npy")])
assert load_lm_params(d, cfg, device="cpu")["slow"]["wqkv"].shape == (1, 32, 64)
save_firefly_params(d / "firefly-gan-vq-fsq-8x1024-21hz-generator.safetensors",
                    init_firefly_params(fc, 1, torch.float32, "cpu"), fc)
c.FireflyConfig.for_version = staticmethod(lambda v: fc)
vocoder.main(["--checkpoint", str(d), "--input", str(d / "codes.npy"), "--device", "cpu",
              "--out-path", str(d / "out.wav")])
with open(d / "ref.wav", "wb") as f:
    write_pcm_as_wav(f, 0.3 * np.sin(np.arange(4096) * 0.05), 22050)
encoder.main(["--checkpoint", str(d), "--input", str(d / "ref.wav"), "--device", "cpu",
              "--out-path", str(d / "voice.npy")])
codec = FireflyCodec(load_firefly_params(d, fc, device="cpu"), fc, device="cpu")
pcm, sr = read_wav(str(d / "ref.wav"))
assert (codec.encode(resample(pcm, sr, 44100)) == np.load(d / "voice.npy")).all()
tmp.cleanup()
import importlib.util
from fish_speech_tpu_torch.pipeline import TTSPipeline
from fish_speech_tpu_torch import api
from fish_speech_tpu_torch.server import core, main as server_main, voices
from fish_speech_tpu_torch.audio import _natlib, decode, opus, webm
from fish_speech_tpu_torch.cli import benchmark
if importlib.util.find_spec("aiohttp") is not None:
    from fish_speech_tpu_torch.server import app
pipe = TTSPipeline(LMEngine(init_dual_ar_params(cfg, 0, torch.float32, "cpu"), cfg, tok,
                            c.WhichLM.FISH_1_5, prompt_buckets=(32,), device="cpu"),
                   codec, StandInTokenizer(), c.WhichLM.FISH_1_5, max_new_tokens=2)
pipe.reroll_on_runaway = False
st = core.AppState(pipe)
req = core.SpeechRequest.parse({"input": "hi ."}, pipe.default_sampling)
assert core.wav_bytes(st, core.wav_pcm(st, req))[:4] == b"RIFF"
if opus.OggOpusEncoder.available():
    assert b"".join(core.opus_body(st, req))[:4] == b"OggS"
from fish_speech_tpu_torch.models.codec import mimi
from fish_speech_tpu_torch.io.checkpoint import save_safetensors
from fish_speech_tpu_torch.io.convert import mimi_params_from_numpy
mc = mimi.MimiConfig(sampling_rate=2000, hidden_size=16, num_filters=4,
                     upsampling_ratios=(5, 4, 2, 2), num_hidden_layers=1, num_attention_heads=2,
                     num_key_value_heads=1, head_dim=8, intermediate_size=32, sliding_window=6,
                     num_quantizers=2, codebook_size=8, codebook_dim=8,
                     vector_quantization_hidden_dimension=8, upsample_groups=16)
mimi.MimiConfig.kyutai = staticmethod(lambda: mc)
dw = dataclasses.replace(cfg, depthwise_wte=True, depthwise_output=True)
tmp = tempfile.TemporaryDirectory()
d = pathlib.Path(tmp.name)
save_lm_params(d / "model.safetensors", init_dual_ar_params(dw, 0, torch.float32, "cpu"), dw)
(d / "config.json").write_text(json.dumps(dataclasses.asdict(dw)))
save_safetensors(d / "mimi.safetensors", mimi.random_mimi_state_dict(mc, device="cpu"))
dual = TTSPipeline.load(d, c.WhichModel.DUAL_AR, lm_dtype=torch.float32, max_new_tokens=3,
                        device="cpu")
assert isinstance(dual.codec, mimi.MimiCodec)
dual.reroll_on_runaway = False
st = core.AppState(dual)
assert core.wav_bytes(st, core.wav_pcm(st, req))[:4] == b"RIFF"
dual_batcher = dual.create_batcher(rows=2, horizon=2)
assert dual_batcher._central is not None
assert list(dual.synthesize_streaming_continuous(dual_batcher, "hi ."))[0].shape[0] % 160 == 0
dual_batcher.shutdown()
tmp.cleanup()
from fish_speech_tpu_torch.cli import finetune
from fish_speech_tpu_torch.train import checkpoint as train_checkpoint, step as train_step
from fish_speech_tpu_torch.utils.cache import setup_compilation_cache
from fish_speech_tpu_torch.utils.profiling import annotate, device_trace, memory_stats
from fish_speech_tpu_torch.utils.timing import Timer
tmp = tempfile.TemporaryDirectory()
d = pathlib.Path(tmp.name)
save_lm_params(d / "model.safetensors", init_dual_ar_params(cfg, 0, torch.float32, "cpu"), cfg)
(d / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
(d / "data").mkdir()
np.save(d / "data" / "a.npy", np.ones((2, 5), np.uint32))
(d / "data" / "a.txt").write_text("hi .")
timer = Timer()
with timer.span("finetune"), device_trace(d / "trace") as trace, annotate("finetune"):
    finetune.finetune(StandInTokenizer(), finetune.build_parser().parse_args([
        "--checkpoint", str(d), "--data", str(d / "data"), "--out", str(d / "out"),
        "--steps", "2", "--batch-size", "1", "--save-every", "1", "--device", "cpu"]))
assert (d / "out" / "train_state.npz").exists() and trace.path.exists()
assert memory_stats()["cpu"] is None and timer.total("finetune") > 0
setup_compilation_cache()
tmp.cleanup()
import fish_speech_tpu_torch.parallel
from fish_speech_tpu_torch.parallel import dryrun
world = dryrun.serving_dryrun(1, 2, dict(
    cfg=dataclasses.replace(cfg, n_head=4, n_local_heads=2, head_dim=8), token_cfg=tok,
    lm=c.WhichLM.FISH_1_5, dtype=torch.float32, seed=0,
    engine=dict(prompt_buckets=(8,), cache_len=16),
    parts={"frames": dict(prompts=np.zeros((1, 3, 4), np.int32), n=1, sampling=SamplingArgs())}),
    device="cpu", timeout_s=120)
assert [r["foreign_modules"] for r in world["ranks"]] == [[], []], world["ranks"]
from fish_speech_tpu_torch.train import TrainConfig
tcfg2 = dataclasses.replace(cfg, n_head=4, n_local_heads=2, head_dim=8)
batch = {"tokens": np.zeros((2, 3, 6), np.int32), "seq_lens": np.array([6, 4], np.int32)}
batch["tokens"][:, 0] = 12
trained = dryrun.train_dryrun(2, 2, dict(
    cfg=tcfg2, token_cfg=tok, tcfg=TrainConfig(warmup_steps=1), dtype=torch.float32, seed=0,
    runs=[{"batches": [batch]}]), device="cpu", timeout_s=120)
assert [r["foreign_modules"] for r in trained["ranks"]] == [[], [], [], []], trained["ranks"]
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m.split(".")[0] == "fish_speech_tpu"
             or m.split(".")[0] in ("optax", "safetensors", "ml_dtypes", "tokenizers"))
print("FORBIDDEN", bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    """A fresh interpreter imports the port, runs one CPU generation on
    the unfused and on the fused decode path, a batched dynamic
    generation and one batcher request, one decode, a streaming feed, an
    overlapped generation and a central-vocoder request (stream_conv,
    firefly_stream, overlap), an int8 generation and the int8 decision
    machinery (quant, train/loss, audio/mel, utils/quality,
    utils/int8_policy), a checkpoint written and read back, the three
    CLIs (llama_generate on a checkpoint directory, the vocoder, the
    encoder) and an encode, the serving surface (pipeline, api,
    server.{core,app,main,voices}, audio.{_natlib,opus,decode,webm},
    cli.benchmark; a TTSPipeline request through the server core to WAV
    and, where the native library builds, to Ogg/Opus), the Mimi codec
    and the dual_ar pipeline (TTSPipeline.load of a depthwise LM with
    mimi.safetensors, a request through the server core and one through
    the central vocoder on Mimi), finetuning (two steps of the finetune
    CLI's function on a checkpoint directory, a train-state snapshot) under
    the utilities (a Timer span, a device_trace with an annotate region,
    memory_stats, setup_compilation_cache), a tp = 2 serving world of two
    spawned ranks and a dp = tp = 2 train world of four (`parallel.dryrun`)
    whose ranks hold none either, and holds no
    jax*, no optax, no fish_speech_tpu, no
    safetensors, no ml_dtypes and no tokenizers module: llama_generate
    reads its tokenizer through a stand-in with the methods PromptEncoder
    calls, as where the tokenizers package is missing."""
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


def _tiny_codec_cfg():
    """The fresh-interpreter script's tiny Firefly config."""
    return tcfg.FireflyConfig(
        head=tcfg.HiFiGANConfig(upsample_rates=(2,), upsample_kernel_sizes=(4,),
                                resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),),
                                num_mels=8, upsample_initial_channel=8),
        quantizer=tcfg.DownsampleFSQConfig(input_dim=8, n_groups=2, downsample_factor=(2,)),
        backbone=tcfg.BackboneConfig(depths=(1,), dims=(8,)))


def _tiny():
    cfg = tcfg.DualARConfig(vocab_size=64, n_layer=1, n_fast_layer=1, n_head=2, dim=32,
                            intermediate_size=64, n_local_heads=1, head_dim=16, rope_base=1e4,
                            norm_eps=1e-6, max_seq_len=32, codebook_size=8, num_codebooks=2)
    tok = tcfg.TokenConfig(im_end_id=1, pad_id=2, semantic_start_id=10, semantic_end_id=17)
    return cfg, tok


@pytest.mark.parametrize("entry", ["engine", "codec", "load_lm_params", "load_firefly_params",
                                   "llama_generate", "vocoder", "encoder", "pipeline_load",
                                   "api_lm", "api_codec", "server_main", "benchmark",
                                   "mimi_codec", "load_mimi_params", "random_mimi",
                                   "pipeline_load_dual_ar", "finetune", "serving_dryrun",
                                   "server_dryrun", "train_dryrun"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    """With no device argument the entry points ask for CUDA, and raise
    where it is missing instead of falling back to the CPU: the engine,
    the codecs, the checkpoint loaders, each CLI's main (finetune's too)
    without --device, TTSPipeline.load (Fish and dual_ar), the API's LM
    and FireflyCodec, the server's main without --device, and the dry
    runs of parallel/ (serving, server, train) before they start a rank."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    from fish_speech_tpu_torch import api
    from fish_speech_tpu_torch.cli import benchmark, encoder, finetune, llama_generate, vocoder
    from fish_speech_tpu_torch.io.checkpoint import load_firefly_params, load_lm_params
    from fish_speech_tpu_torch.models.codec import mimi
    from fish_speech_tpu_torch.parallel import dryrun
    from fish_speech_tpu_torch.pipeline import TTSPipeline
    from fish_speech_tpu_torch.server import main as server_main

    cfg, tok = _tiny()
    ckpt = ["--checkpoint", str(tmp_path)]
    calls = {
        "engine": lambda: LMEngine(init_dual_ar_params(cfg, 0, torch.float32, "cpu"), cfg, tok,
                                   tcfg.WhichLM.FISH_1_5),
        "codec": lambda: FireflyCodec({}, tcfg.FireflyConfig()),
        "load_lm_params": lambda: load_lm_params(tmp_path, cfg),
        "load_firefly_params": lambda: load_firefly_params(tmp_path, tcfg.FireflyConfig()),
        "llama_generate": lambda: llama_generate.main(ckpt + ["--text", "hi"]),
        "vocoder": lambda: vocoder.main(ckpt),
        "encoder": lambda: encoder.main(ckpt + ["--input", str(tmp_path / "x.wav")]),
        "pipeline_load": lambda: TTSPipeline.load(tmp_path, tcfg.WhichModel.FISH_1_5),
        "api_lm": lambda: api.LM(tmp_path),
        "api_codec": lambda: api.FireflyCodec(tmp_path),
        "server_main": lambda: server_main.main(ckpt),
        "benchmark": lambda: benchmark.main([]),
        "mimi_codec": lambda: mimi.MimiCodec({}, mimi.MimiConfig()),
        "load_mimi_params": lambda: mimi.load_mimi_params(tmp_path / "m.safetensors",
                                                          mimi.MimiConfig()),
        "random_mimi": lambda: mimi.random_mimi_state_dict(mimi.MimiConfig()),
        "pipeline_load_dual_ar": lambda: TTSPipeline.load(tmp_path, tcfg.WhichModel.DUAL_AR),
        "finetune": lambda: finetune.main(ckpt + ["--data", str(tmp_path), "--out",
                                                  str(tmp_path / "out")]),
        "serving_dryrun": lambda: dryrun.serving_dryrun(1, 2, {}),
        "server_dryrun": lambda: dryrun.server_dryrun(2, 2, [], []),
        "train_dryrun": lambda: dryrun.train_dryrun(1, 2, {}),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_server_main_builds_on_the_cpu_when_asked(tmp_path, monkeypatch):
    """`--device cpu` takes the server's main past the device check: a
    checkpoint directory (a stand-in tokenizer where the tokenizers
    package would read tokenizer.json) and a voices directory become the
    served state, with a 2-row batcher, warmed; serve is not entered."""
    import json
    import re
    import types

    from fish_speech_tpu_torch.cli import llama_generate
    from fish_speech_tpu_torch.io.checkpoint import save_firefly_params, save_lm_params
    from fish_speech_tpu_torch.models.codec.firefly import init_firefly_params
    from fish_speech_tpu_torch.server import app, main as server_main

    cfg, tok = _tiny()
    cfg = dataclasses.replace(cfg, max_seq_len=64)
    vocab = {"<|im_start|>": 3, "<|im_end|>": 1, "<|semantic|>": 2, "<|voice|>": 4,
             **{f"<|semantic:{i}|>": 10 + i for i in range(8)}}
    stand_in = types.SimpleNamespace(
        token_to_id=vocab.get,
        encode=lambda text, add_special_tokens=False: types.SimpleNamespace(ids=[
            vocab.get(w, 20 + len(w)) for w in re.findall(r"<\|[^|]*\|>|\w+|[^\w\s]", text)]))
    monkeypatch.setattr(llama_generate, "load_tokenizer", lambda path: stand_in)
    fc = _tiny_codec_cfg()
    monkeypatch.setattr(tcfg.FireflyConfig, "for_version", staticmethod(lambda v: fc))
    save_lm_params(tmp_path / "model.safetensors", init_dual_ar_params(cfg, 0, torch.float32,
                                                                       "cpu"), cfg)
    (tmp_path / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    save_firefly_params(tmp_path / "firefly-gan-vq-fsq-8x1024-21hz-generator.safetensors",
                        init_firefly_params(fc, 1, torch.float32, "cpu"), fc)
    voices = tmp_path / "voices"
    voices.mkdir()
    np.save(voices / "default.npy", np.zeros((2, 3), np.uint32))
    (voices / "index.json").write_text(json.dumps({"speakers": {"default": "hi"}}))
    served = []
    monkeypatch.setattr(app, "serve", lambda state, port: served.append(state))
    server_main.main(["--checkpoint", str(tmp_path), "--voice-dir", str(voices), "--device",
                      "cpu", "--continuous-batch", "2", "--warmup", "--no-quantize-int8",
                      "--max-new-tokens", "3", "--temp", "0"])
    (state,) = served
    try:
        assert state.pipeline.engine.device.type == "cpu" and state.batcher is not None
        assert sorted(state.voices) == ["default"] and state.pipeline.default_sampling.temp == 0
        t0 = time.perf_counter()  # the warm-up request's row is released by the scheduler
        while not all(s is None for s in state.batcher.rows):
            assert time.perf_counter() - t0 < 60
            time.sleep(0.01)
    finally:
        state.batcher.shutdown()


def test_packages_the_port_does_not_need():
    """The port imports neither safetensors nor ml_dtypes, and tokenizers
    only inside the CLI's tokenizer-file loader: it runs where none of
    the three is installed."""
    import ast

    def imports(node, fn=None):
        """(top-level package, enclosing function name) of every import."""
        if isinstance(node, ast.Import):
            yield from ((a.name.split(".")[0], fn) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], fn
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(child, ast.FunctionDef) else fn
            yield from imports(child, inner)

    for f in (REPO / "fish_speech_tpu_torch").rglob("*.py"):
        for top, fn in imports(ast.parse(f.read_text())):
            assert top not in ("safetensors", "ml_dtypes"), f"{f}: {top}"
            if top == "tokenizers":
                assert (f.name, fn) == ("llama_generate.py", "load_tokenizer"), f"{f}: {fn}"


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


@pytest.mark.cuda
def test_cuda_stream_equals_batch_in_float32():
    """On the card, with TF32 off (PyTorch runs float32 cuDNN convolutions
    in TF32 on Hopper by default, and cuDNN picks its algorithm by
    length, so a chunked decode would drift from the batch decode by
    TF32's rounding): the float32 Firefly stream equals the batch decode
    within 1e-4 absolute for several chunkings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fish_speech_tpu_torch.models.codec.firefly import init_firefly_params

    cfg = tcfg.FireflyConfig.for_version(tcfg.FishVersion.V1_5)
    params = init_firefly_params(cfg, seed=1, dtype=torch.float32, device="cuda")
    params = {k: (v if k != "head" else {**v, "conv_post": {
        "w": v["conv_post"]["w"] * 1000.0, "b": v["conv_post"]["b"]}})
              for k, v in params.items()}  # PCM of order 1e-3, not 1e-6
    codec = FireflyCodec(params, cfg)
    codes = np.random.default_rng(0).integers(
        0, 1000, size=(cfg.quantizer.n_groups * cfg.quantizer.n_codebooks, 64))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = codec.decode(codes)
        for chunking in ([64], [5, 16, 16, 27], [1] * 8 + [56]):
            sess, got, s = codec.start_stream(max_step_frames=32), [], 0
            for n in chunking:
                got.append(sess.feed(codes[:, s:s + n]))
                s += n
            err = float(np.abs(np.concatenate(got, axis=-1) - ref).max())
            assert err <= 1e-4 * max(1.0, float(np.abs(ref).max())), (chunking, err)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _full_width_on_the_card():
    """The `auto` batch-1 engine at full Fish-1.5 width (random bf16
    weights, im_end never drawn), the Firefly-1.5 codec (seed 1), a
    40-token prompt and the serving sampling knobs."""
    from fish_speech_tpu_torch.models.codec.firefly import init_firefly_params
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    cfg = tcfg.DualARConfig.fish_speech_1_5()
    tok = tcfg.TokenConfig(im_end_id=100011, pad_id=5, semantic_start_id=100012,
                           semantic_end_id=100012 + cfg.codebook_size - 1)
    params = init_dual_ar_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    params["output"][:, tok.im_end_id] = 0
    engine = LMEngine(params, cfg, tok, tcfg.WhichLM.FISH_1_5, max_frames=64,
                      prompt_buckets=(64,))
    ccfg = tcfg.FireflyConfig.for_version(tcfg.FishVersion.V1_5)
    codec = FireflyCodec(init_firefly_params(ccfg, seed=1), ccfg)
    rng = np.random.default_rng(0)
    prompt = np.concatenate([rng.integers(1000, 90000, size=(1, 40)),
                             np.zeros((cfg.num_codebooks, 40), np.int64)]).astype(np.int32)
    sampling = SamplingArgs(temp=0.7, top_p=0.8, top_k=256, repetition_penalty=1.4)
    return engine, codec, prompt, sampling


@pytest.mark.cuda
def test_cuda_overlapped_tokens_equal_generate():
    """On the card at full Fish-1.5 width (random bf16 weights, the `auto`
    fused path): the overlapped driver's tokens are generate's for the
    same seed, and its PCM has the batch decode's shape and is finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fish_speech_tpu_torch.generate.overlap import generate_vocode_overlapped

    engine, codec, prompt, sampling = _full_width_on_the_card()
    ref, _ = engine.generate(prompt, max_new_tokens=48, sampling=sampling, seed=3)
    pcm, res, _ = generate_vocode_overlapped(engine, codec, prompt, sampling=sampling,
                                             max_new_tokens=48, seed=3, chunk=16)
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    np.testing.assert_array_equal(res.semantic, ref.semantic)
    assert pcm.shape == (res.frames * codec.samples_per_frame,) and np.isfinite(pcm).all()


@pytest.mark.cuda
def test_cuda_launches_between_reads_do_not_wait():
    """On the card, what the overlapped driver and the central vocoder
    launch between two reads queues behind the card's work: a decode
    chunk, a feed of host codes, and a central-vocoder tick (a lane reset,
    a lane sitting the tick out, the int16 conversion and the copy to the
    host) run under PyTorch's sync debug mode set to raise, which raises
    on a copy from pageable memory; the tick's PCM still arrives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import types

    from fish_speech_tpu_torch.generate.continuous import (
        BatchedRequest, _CentralVocoder, _PartialPCM, _RowState)

    engine, codec, prompt, sampling = _full_width_on_the_card()
    n = engine.cfg.num_codebooks
    codes = np.random.default_rng(2).integers(0, 1000, size=(n + 1, 32)).astype(np.int32)
    fake = types.SimpleNamespace(horizon=8, engine=types.SimpleNamespace(
        batch_size=3, cfg=types.SimpleNamespace(num_codebooks=n)))
    vocoder = _CentralVocoder(fake, codec, None)
    slots = [_RowState(BatchedRequest([None], 0, 64, deliver_pcm=True), r) for r in range(3)]
    held = []
    try:
        state, _, _ = engine.prefill(engine.init_state(0), prompt, sampling)
        session = codec.start_stream(max_step_frames=16)
        for slot in slots:
            vocoder.enable_row(slot)
            vocoder.push(slot, codes[:, :8])
        vocoder.tick()  # warm, outside the mode
        engine.decode_chunk(state, sampling, 16)
        session.feed_async(codes[1:, :16], pad_to=16)
        vocoder.enable_row(slots[0])
        for slot in (slots[0], slots[2]):  # slots[1] sits the next tick out
            vocoder.push(slot, codes[:, 8:16])
        torch.cuda.synchronize()
        vocoder._put = lambda fetch, meta: held.append((fetch, meta))
        torch.cuda.set_sync_debug_mode("error")
        try:
            with pytest.raises(RuntimeError):
                torch.from_numpy(codes).to("cuda")
            engine.decode_chunk(state, sampling, 16)
            session.feed_async(codes[1:, :16], pad_to=16)
            vocoder.tick()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        del vocoder._put
        for fetch, meta in held:
            vocoder._put(fetch, meta)
        vocoder.drain(timeout=60)
    finally:
        vocoder.shutdown()
    frames = []
    for slot in slots:
        events = []
        while not slot.req.results.empty():
            events.append(slot.req.results.get_nowait())
        frames.append([ev.frames for ev in events if isinstance(ev, _PartialPCM)])
    assert frames == [[8, 8], [8], [8, 8]]


@pytest.mark.cuda
def test_cuda_float32_encode_without_tf32():
    """On the card, the float32 encode of the full-width Firefly-1.5 codec
    (seed 1, each FSQ group's project_in standardised on the audio so
    that the codes spread over the grid, as chip_smoke.py's cli phase
    does) with TF32 allowed process-wide: the encode turns TF32 off for
    itself, so its codes equal the CPU encode's wherever the CPU's value
    before rounding lies at least 1e-3 from a tie, and on at least 99.5%
    in all; with TF32 allowed in the encode (cuDNN's float32 convolutions
    then move the features by ~1e-3 relative) strictly fewer agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import importlib.util

    from fish_speech_tpu_torch.models.codec.firefly import init_firefly_params
    from fish_speech_tpu_torch.device import tree_to

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = tcfg.FireflyConfig.for_version(tcfg.FishVersion.V1_5)
    t = np.arange(4 * 44100) / 44100.0
    rng = np.random.default_rng(0)
    audio = (0.1 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.sin(2 * np.pi * 660 * t)
             + 0.02 * rng.normal(size=t.shape)).astype(np.float32)
    params = init_firefly_params(cfg, seed=1, dtype=torch.float32, device="cuda")
    switches = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        smoke.spread_encoder(torch, FireflyCodec(params, cfg), audio)
        card = FireflyCodec(params, cfg)
        cpu = FireflyCodec(tree_to(params, "cpu"), cfg, device="cpu")
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        got = card.encode(audio)
        got_tf32 = card.encode(audio, allow_tf32=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = switches
    ref = cpu.encode(audio)
    values = smoke.encode_values(torch, cpu, audio)
    assert np.array_equal(smoke.codes_of_values(np, values, cfg.quantizer.levels), ref[0])
    tie = smoke.near_ties(np, values, cfg.quantizer.n_codebooks)[None]
    differ = got != ref
    off, on = float(1 - differ.mean()), float((got_tf32 == ref).mean())
    print(f"codes equal to the CPU encode: TF32 off {off:.5f} ({int(differ.sum())} differ, "
          f"{int(tie.sum())} of {tie.size} near a tie), TF32 on {on:.5f}; "
          f"{len(np.unique(ref))} distinct codes")
    assert ref.shape == (1, 8, card.frames_for_samples(audio.shape[0]))
    assert not (differ & ~tie).any()
    assert off >= 0.995 and on < off
