"""One whole fast (codebook) frame at batch 1: the persistent CUDA kernel
(`csrc/fast_frame.cu`: for each codebook step one cooperative launch of
`csrc/decode_stack.cuh`, then one launch of its sampler) and its plain
PyTorch version.

Counterpart of the TPU kernel `fish_speech_tpu/ops/fast_frame_pallas.py::
fused_fast_frame`: C codebook steps of the fast layers, each followed by
the repetition penalty, the top-k/top-p draw with the given Gumbel noise,
the EOS rule and the next step's embedding. The head product is float32
and unrounded, and silu sees the unrounded float32 w1 product, as in the
TPU kernel (fast_frame_pallas.py:283-301); the unfused codebook loop of
`generate/frame.py` rounds both to bf16. An int8-quantized fast stack
takes the TPU kernel's int8 body (fast_frame_pallas.py:127-151, 174-186,
284-294): each stack product is bf16(bf16(x @ q) * s), and silu sees
that rescaled bf16 w1 product.
"""

from __future__ import annotations

import torch

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.models.dual_ar import fast_embed, fast_hist_init, fast_step
from fish_speech_tpu_torch.ops import _cuda_build, decode_stack, launch_count
from fish_speech_tpu_torch.ops.quant import is_quantized
from fish_speech_tpu_torch.ops.sampling import (
    RepPenWindow, SamplingArgs, sample_top_k_top_p, top_k_width)
from fish_speech_tpu_torch.ops.slow_step import (
    HEAD_DIM, _grid, check_stack, stack_dtypes_ok, stack_pointers, stack_shapes_bad,
    stack_weight, stack_widths_ok)

launches = 0  # kernel launches since the last reset (set to 0 to reset)
int8_launches = 0  # those of them on int8 stacks (the int8 kernel body)

MAX_VOCAB = 4096  # codebook entries the sampler block takes
MAX_WINDOW = decode_stack.MAX_WINDOW  # rep-pen window length the sampler takes


def fused_fast_frame_plain(params, cfg: DualARConfig, sampling: SamplingArgs, hidden,
                           rp_tokens, gumbel, is_eos, rope, *, rep_enabled: bool,
                           return_logits: bool = False):
    """hidden (1, D) slow hidden; rp_tokens (C, W) int32 rep-pen windows
    (after this frame's push); gumbel (C, k_eff) float32, None in argmax
    mode; is_eos (1,) bool. Returns the frame's codebook tokens (C,)
    int32, all 0 when is_eos; with return_logits, also each step's head
    logits (C, codebook_size) float32 before the penalty."""
    n_cb = cfg.num_codebooks
    hist = fast_hist_init(cfg, 1, hidden.dtype, hidden.device)
    x = hidden[:, None, :]
    toks, step_logits = [], []
    for cb in range(n_cb):
        logits, hist = fast_step(params, cfg, x, hist, cb, rope, unrounded=True)
        step_logits.append(logits)
        if rep_enabled:
            window = RepPenWindow(tokens=rp_tokens[cb:cb + 1], ptr=0)
            logits = window.penalize(logits, sampling.repetition_penalty)
        tok = sample_top_k_top_p(
            logits, temp=sampling.temp, top_p=sampling.top_p, top_k=sampling.top_k,
            gumbel=None if gumbel is None else gumbel[cb:cb + 1])
        tok = torch.where(is_eos, torch.zeros_like(tok), tok)
        if cb + 1 < n_cb:
            x = fast_embed(params, cfg, tok, cb)
        toks.append(tok)
    tokens = torch.cat(toks).to(torch.int32)
    return (tokens, torch.cat(step_logits)) if return_logits else tokens


def fused_fast_frame(params, cfg: DualARConfig, sampling: SamplingArgs, hidden,
                     rp_tokens, gumbel, is_eos, rope, *, rep_enabled: bool,
                     return_logits: bool = False, sync=None):
    """Same contract as `fused_fast_frame_plain`. CPU tensors run the
    plain version; CUDA tensors launch the kernel (a persistent launch and
    a sampler launch a codebook step) or raise. sync: the persistent
    kernel's grid sync state (an engine's own); by default that of the
    current (device, stream)."""
    if hidden.device.type == "cpu":
        return fused_fast_frame_plain(params, cfg, sampling, hidden, rp_tokens, gumbel,
                                      is_eos, rope, rep_enabled=rep_enabled,
                                      return_logits=return_logits)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_fast_frame: unsupported device {hidden.device}")
    stack = params["fast"]
    cos_t, sin_t = rope
    n_cb, vocab = cfg.num_codebooks, cfg.codebook_size
    k_eff = top_k_width(sampling.top_k, vocab)
    _check(params, cfg, sampling, hidden, rp_tokens, gumbel, is_eos, cos_t, sin_t, k_eff)
    n_layer, d, _ = stack_weight(stack["wqkv"]).shape
    f = stack_weight(stack["w1"]).shape[2]
    kv = cfg.n_local_heads
    weights, scales = stack_pointers(stack)
    plan = fast_plan(cfg, scales[0] is not None, decode_stack.grid_of(hidden.device))
    lib = _cuda_build.load_library()
    dev = hidden.device
    dt = hidden.dtype
    tokens = torch.empty((n_cb,), dtype=torch.int32, device=dev)
    logits_buf = torch.empty((n_cb, vocab), dtype=torch.float32, device=dev)
    k_hist = torch.empty((n_layer, 1, kv, n_cb, HEAD_DIM), dtype=dt, device=dev)
    v_hist = torch.empty_like(k_hist)
    scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8, device=dev)
    head = params["fast_output"]
    rc = lib.fs_fast_frame(
        hidden.data_ptr(), stack["attention_norm"].data_ptr(), stack["ffn_norm"].data_ptr(),
        *weights, *scales, params["fast_norm"].data_ptr(),
        head.data_ptr(), params["fast_embeddings"].data_ptr(),
        cos_t.data_ptr(), sin_t.data_ptr(), rp_tokens.data_ptr(),
        None if gumbel is None else gumbel.data_ptr(), is_eos.data_ptr(),
        tokens.data_ptr(), logits_buf.data_ptr(), k_hist.data_ptr(), v_hist.data_ptr(),
        scratch.data_ptr(), (decode_stack.sync_state(dev) if sync is None else sync).data_ptr(),
        n_layer, d, cfg.n_head, kv, f, n_cb, vocab, head.shape[1],
        int(cfg.depthwise_output), int(cfg.depthwise_wte), rp_tokens.shape[1], k_eff,
        int(rep_enabled), plan.scratch_bytes, float(sampling.temp), float(sampling.top_p),
        float(sampling.repetition_penalty), float(cfg.norm_eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda_build.check(rc, "fs_fast_frame")
    launch_count.add(__name__, launches=1, int8_launches=int(scales[0] is not None))
    return (tokens, logits_buf) if return_logits else tokens


def fast_plan(cfg: DualARConfig, int8: bool, grid: int):
    """The persistent kernel's plan for this model's fast stack
    (`ops/decode_stack.py::stack_plan`), or None when it does not take
    the shapes."""
    return decode_stack.stack_plan(
        decode_stack.FAST, cfg.dim, cfg.n_head, cfg.n_local_heads, cfg.intermediate_size,
        cfg.codebook_size, cfg.num_codebooks, int8, grid)


def fused_fast_frame_supported(cfg: DualARConfig, params, batch: int) -> bool:
    """Whether `fused_fast_frame` takes these parameters: one row and an
    even head dim; on CUDA also the persistent kernel's limits: bf16
    stacks or int8 ones with bf16 scales and out % 16 == 0, head dim 64,
    H * hd == D with D one of `decode_stack.DIMS`, an ffn width that is a
    multiple of 64, a codebook of at most 4096 entries, and a plan
    (`decode_stack.stack_plan`) that fits one block on an SM."""
    if batch != 1 or cfg.head_dim % 2:
        return False
    stack = params["fast"]
    weight = stack_weight(stack["wqkv"])
    if weight.device.type != "cuda":
        return True
    return (
        stack_dtypes_ok(stack) and stack_widths_ok(stack)
        and cfg.head_dim == HEAD_DIM
        and cfg.codebook_size <= MAX_VOCAB
        and fast_plan(cfg, is_quantized(stack["wqkv"]), _grid(weight.device)) is not None
    )


def _check(params, cfg, sampling, hidden, rp_tokens, gumbel, is_eos, cos_t, sin_t, k_eff):
    stack = params["fast"]
    check_stack(stack, "fused_fast_frame", "fast", hidden.device)
    bf16 = {"hidden": hidden, "fast_norm": params["fast_norm"],
            "fast_output": params["fast_output"],
            "fast_embeddings": params["fast_embeddings"]}
    for name, t in bf16.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused_fast_frame: {name} must be bfloat16, got {t.dtype}")
    others = {"rp_tokens": rp_tokens, "is_eos": is_eos, "cos": cos_t, "sin": sin_t}
    if gumbel is not None:
        others["gumbel"] = gumbel
    for name, t in {**bf16, **others}.items():
        if t.device != hidden.device:
            raise ValueError(f"fused_fast_frame: {name} is on {t.device}, hidden on {hidden.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_fast_frame: {name} must be contiguous")
    if rp_tokens.dtype != torch.int32 or is_eos.dtype != torch.bool:
        raise TypeError("fused_fast_frame: rp_tokens must be int32 and is_eos bool")
    if cos_t.dtype != torch.float32 or sin_t.dtype != torch.float32:
        raise TypeError("fused_fast_frame: rope tables must be float32")
    if not fused_fast_frame_supported(cfg, params, hidden.shape[0]):
        raise ValueError(
            f"fused_fast_frame: the kernel does not take batch {hidden.shape[0]}, dim "
            f"{cfg.dim}, heads {cfg.n_head}x{cfg.head_dim}, codebook {cfg.codebook_size}")
    n_cb, vocab, d = cfg.num_codebooks, cfg.codebook_size, cfg.dim
    qkv = (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim
    bad = stack_shapes_bad(stack, cfg.n_fast_layer, d, qkv, cfg.intermediate_size)
    if (bad or tuple(hidden.shape) != (1, d)
            or tuple(params["fast_output"].shape) != (d, cfg.fast_output_size)
            or params["fast_embeddings"].shape[0] < cfg.fast_vocab_size
            or params["fast_embeddings"].shape[1] != d
            or rp_tokens.dim() != 2 or rp_tokens.shape[0] != n_cb
            or not 1 <= rp_tokens.shape[1] <= MAX_WINDOW or tuple(is_eos.shape) != (1,)
            or cos_t.shape[0] < n_cb or tuple(cos_t.shape[1:]) != (HEAD_DIM // 2,)
            or cos_t.shape != sin_t.shape):
        raise ValueError(
            f"fused_fast_frame: shapes hidden {tuple(hidden.shape)}, fast_output "
            f"{tuple(params['fast_output'].shape)}, fast_embeddings "
            f"{tuple(params['fast_embeddings'].shape)}, rp_tokens {tuple(rp_tokens.shape)}, "
            f"is_eos {tuple(is_eos.shape)}, rope {tuple(cos_t.shape)}, stack {bad or 'ok'}")
    if sampling.is_argmax:
        return
    if gumbel is None or tuple(gumbel.shape) != (n_cb, k_eff) or gumbel.dtype != torch.float32:
        raise ValueError(
            f"fused_fast_frame: sampling needs float32 gumbel noise ({n_cb}, {k_eff}), got "
            f"{None if gumbel is None else (tuple(gumbel.shape), gumbel.dtype)}")
