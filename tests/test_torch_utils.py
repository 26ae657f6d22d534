"""The port's utilities (fish_speech_tpu_torch/utils/{timing,profiling,
cache}.py), after tests/test_utils.py: the Timer as the JAX package's,
a trace written by `device_trace` that holds an `annotate` region, the
per-device memory statistics, and $FISH_TPU_CACHE_DIR moving the kernel
library's build directory. No JAX here: the `cuda` cases run on the
card (the trace's kernels, the peak memory, a train step's bits)."""

import json
import time

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.ops import _cuda_build
from fish_speech_tpu_torch.utils.cache import setup_compilation_cache
from fish_speech_tpu_torch.utils.profiling import annotate, device_trace, memory_stats
from fish_speech_tpu_torch.utils.timing import Timer


class TestTimer:
    def test_spans_accumulate_by_name(self):
        t = Timer()
        with t.span("a"):
            time.sleep(0.01)
        with t.span("b"):
            pass
        with t.span("a"):
            time.sleep(0.01)
        rep = t.report()
        assert set(rep) == {"a", "b"}
        assert rep["a"] >= 0.02
        assert t.total("a") == rep["a"]
        assert t.total("missing") == 0.0

    def test_span_recorded_on_exception(self):
        t = Timer()
        try:
            with t.span("x"):
                raise RuntimeError("boom")
        except RuntimeError:
            pass
        assert t.total("x") >= 0.0 and len(t.spans) == 1


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_device_trace_holds_the_region(tmp_path):
    x = torch.ones((64, 64))
    with device_trace(tmp_path / "traces") as trace:
        with annotate("tiny-matmul"):
            (x @ x).sum().item()
    assert trace.path is not None and trace.path.parent == tmp_path / "traces"
    names = {e.get("name") for e in _events(trace.path)}
    assert "tiny-matmul" in names
    assert any(n and "mm" in n for n in names), sorted(n for n in names if n)[:20]
    assert any(e.key == "tiny-matmul" for e in trace.prof.key_averages())


def test_device_trace_written_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with device_trace(tmp_path) as trace:
            with annotate("failing"):
                raise RuntimeError("boom")
    assert "failing" in {e.get("name") for e in _events(trace.path)}


def test_memory_stats_covers_every_device():
    stats = memory_stats()
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())] if torch.cuda.is_available() \
        else []
    assert set(stats) == {"cpu", *cards}
    assert stats["cpu"] is None  # the CPU keeps none, as a JAX device without them gives None
    for card in cards:
        assert "allocated_bytes.all.peak" in stats[card]


def test_cache_dir_moves_the_kernel_build(tmp_path, monkeypatch):
    """$FISH_TPU_CACHE_DIR (or the argument) is where the kernel library
    is built and found: a library already in <dir>/<hash>/ is what
    build() returns, without nvcc."""
    monkeypatch.setattr(_cuda_build, "BUILD_ROOT", _cuda_build.BUILD_ROOT)
    monkeypatch.delenv("FISH_TPU_CACHE_DIR", raising=False)
    assert setup_compilation_cache() == str(_cuda_build.DEFAULT_BUILD_ROOT)
    assert _cuda_build.BUILD_ROOT == _cuda_build.DEFAULT_BUILD_ROOT
    monkeypatch.setenv("FISH_TPU_CACHE_DIR", str(tmp_path / "env"))
    assert setup_compilation_cache() == str(tmp_path / "env")
    lib = tmp_path / "env" / _cuda_build._digest() / _cuda_build.LIB_NAME
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    assert _cuda_build.build() == lib
    assert setup_compilation_cache(tmp_path / "arg") == str(tmp_path / "arg")
    assert _cuda_build.BUILD_ROOT == tmp_path / "arg"


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_cuda_trace_holds_kernels_and_the_region(tmp_path):
    _need_card()
    x = torch.ones((256, 256), device="cuda")
    with device_trace(tmp_path) as trace:
        with annotate("card-matmul"):
            x @ x
        torch.cuda.synchronize()
    events = _events(trace.path)
    assert "card-matmul" in {e.get("name") for e in events}
    assert any(e.get("cat") == "kernel" for e in events)


@pytest.mark.cuda
def test_cuda_memory_stats_peak():
    _need_card()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    x = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    peak = memory_stats()["cuda:0"]["allocated_bytes.all.peak"]
    assert peak >= x.numel()


@pytest.mark.cuda
def test_cuda_train_steps_are_deterministic():
    """Two runs of three train steps from the same weights and batches
    give the same parameters and moments bit for bit on the card (the
    gathers' backward is F.embedding's, which sums in a fixed order)."""
    _need_card()
    from fish_speech_tpu_torch import config as tcfg
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params
    from fish_speech_tpu_torch.train import TrainConfig, init_train_state, make_train_step
    from fish_speech_tpu_torch.train.step import tree_leaves

    cfg = tcfg.DualARConfig(vocab_size=4096, n_layer=2, n_fast_layer=2, n_head=4, dim=128,
                            intermediate_size=256, n_local_heads=2, head_dim=32, rope_base=1e4,
                            norm_eps=1e-6, max_seq_len=256, codebook_size=64, num_codebooks=4)
    tok = tcfg.TokenConfig(im_end_id=9, pad_id=5, semantic_start_id=1000, semantic_end_id=1063)
    rng = np.random.default_rng(0)
    tokens = np.zeros((4, 5, 192), np.int32)
    tokens[:, 0] = rng.integers(1000, 1064, size=(4, 192))
    tokens[:, 1:] = rng.integers(0, 64, size=(4, 4, 192))
    batch = {"tokens": torch.from_numpy(tokens).cuda(),
             "seq_lens": torch.tensor([192, 150, 100, 191], dtype=torch.int32).cuda()}
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    runs = []
    for _ in range(2):
        params, state = init_train_state(init_dual_ar_params(cfg, 0, torch.float32, "cuda"), tc)
        step = make_train_step(cfg, tok, tc)
        for _ in range(3):
            params, state, _ = step(params, state, batch)
        runs.append(tree_leaves(params) + tree_leaves(state))
    for (path, a), (_, b) in zip(*runs):
        assert torch.equal(a, b), path
