"""The whole slow-stack decode step: the CUDA kernel sequence
(`csrc/slow_step.cu`) and its plain PyTorch version.

Counterpart of the TPU kernel `fish_speech_tpu/ops/slow_step_pallas.py::
fused_slow_step`: from the embedded input x0 (B, D) at per-row positions
pos, all slow layers with the in-place K/V write at pos[b] and attention
over rows 0..pos[b], then the final norm and the gathered head. The head
product is float32 and unrounded, and silu sees the unrounded float32
w1 product, as in the TPU kernel (slow_step_pallas.py:317-334); the
unfused `models/dual_ar.py::slow_decode_step` rounds both to bf16.
Unlike the JAX function, which returns new caches, both versions here
update ck/cv in place and return (logits, hidden).
"""

from __future__ import annotations

import torch

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.models.dual_ar import _attn_out_ffn, _layer, _project_qkv
from fish_speech_tpu_torch.ops import _cuda_build
from fish_speech_tpu_torch.ops.decode_attention import decode_attention_plain
from fish_speech_tpu_torch.ops.norms import rms_norm
from fish_speech_tpu_torch.ops.rope import apply_rope_interleaved

launches = 0  # kernel-sequence launches since the last reset (set to 0 to reset)

HEAD_DIM = 64  # the attention kernel's head dim
MAX_BATCH = 4  # rows the kernel's GEMVs take
GEMV_SMEM = 40960  # bytes of staged input rows a GEMV block may hold
ATTN_SMEM = 232448  # bytes of shared memory one block may use on sm_90
STACK_KEYS = ("wqkv", "wo", "w1", "w3", "w2", "attention_norm", "ffn_norm")


def is_dense(params, stack: str) -> bool:
    """False for int8-quantized stacks (a dict per weight), not ported yet."""
    return not any(isinstance(params[stack][k], dict) for k in STACK_KEYS)


def check_dense(params, stack: str, who: str) -> None:
    if not is_dense(params, stack):
        raise TypeError(f"{who}: int8-quantized {stack} stacks are not supported")


def fused_slow_step_plain(params, cfg: DualARConfig, x0, pos, ck, cv, rope):
    """x0 (B, D), pos (B,) int, ck/cv (L, B, KV, S, hd), rope (cos, sin)
    tables. Writes each layer's new K/V at row pos[b] in place and
    returns (logits (B, W) float32, hidden (B, D))."""
    check_dense(params, "slow", "fused_slow_step")
    cos_t, sin_t = rope
    cos = cos_t[pos.long()][:, None, None, :]
    sin = sin_t[pos.long()][:, None, None, :]
    x = x0[:, None, :]
    for l in range(cfg.n_layer):
        lp = _layer(params["slow"], l)
        h = rms_norm(x, lp["attention_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(h, lp, cfg)  # (B, heads, 1, hd)
        q = apply_rope_interleaved(q, cos, sin)
        k = apply_rope_interleaved(k, cos, sin)
        attn = decode_attention_plain(
            q[:, :, 0].contiguous(),
            k[:, :, 0].to(ck.dtype).contiguous(),
            v[:, :, 0].to(cv.dtype).contiguous(),
            pos, ck, cv, l,
        )
        x = _attn_out_ffn(x, attn[:, :, None, :], lp, cfg, unrounded=True)
    hidden = x[:, 0, :]
    normed = rms_norm(hidden, params["norm"], cfg.norm_eps)
    return normed.float() @ params["output"].float(), hidden


def fused_slow_step(params, cfg: DualARConfig, x0, pos, ck, cv, rope):
    """Same contract as `fused_slow_step_plain`. CPU tensors run the
    plain version; CUDA tensors launch the kernel sequence or raise."""
    if x0.device.type == "cpu":
        return fused_slow_step_plain(params, cfg, x0, pos, ck, cv, rope)
    if x0.device.type != "cuda":
        raise ValueError(f"fused_slow_step: unsupported device {x0.device}")
    check_dense(params, "slow", "fused_slow_step")
    stack = params["slow"]
    head = params["output"]
    cos_t, sin_t = rope
    bsz, d = x0.shape
    n_layer, _, kv, s, _ = ck.shape
    f = stack["w1"].shape[2]
    w = head.shape[1]
    _check(cfg, x0, pos, ck, cv, stack, params["norm"], head, cos_t, sin_t)
    lib = _cuda_build.load_library()
    qkv = (cfg.n_head + 2 * kv) * HEAD_DIM
    dev = x0.device
    logits = torch.empty((bsz, w), dtype=torch.float32, device=dev)
    hidden = torch.empty_like(x0)
    qkv_buf = torch.empty((bsz, qkv), dtype=x0.dtype, device=dev)
    attn_buf = torch.empty((bsz, d), dtype=x0.dtype, device=dev)
    ffn_buf = torch.empty((bsz, f), dtype=x0.dtype, device=dev)
    rc = lib.fs_slow_step(
        x0.data_ptr(), pos.data_ptr(),
        stack["attention_norm"].data_ptr(), stack["wqkv"].data_ptr(),
        stack["wo"].data_ptr(), stack["ffn_norm"].data_ptr(),
        stack["w1"].data_ptr(), stack["w3"].data_ptr(), stack["w2"].data_ptr(),
        params["norm"].data_ptr(), head.data_ptr(),
        cos_t.data_ptr(), sin_t.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        logits.data_ptr(), hidden.data_ptr(),
        qkv_buf.data_ptr(), attn_buf.data_ptr(), ffn_buf.data_ptr(),
        bsz, n_layer, d, cfg.n_head, kv, f, w, s, float(cfg.norm_eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda_build.check(rc, "fs_slow_step")
    global launches
    launches += 1
    return logits, hidden


def fused_slow_step_supported(cfg: DualARConfig, params, batch: int,
                              cache_len: int = 0) -> bool:
    """Whether `fused_slow_step` takes these parameters at this batch and
    cache length: dense (not int8) stacks and an even head dim; on CUDA
    also the kernels' limits (bf16, head dim 64, H * hd == D, widths that
    are multiples of 8, batch <= 4, the GEMV's staged rows and the
    attention scores within shared memory). CPU tensors run the plain
    version, which takes any batch and dtype."""
    if not is_dense(params, "slow") or cfg.head_dim % 2:
        return False
    stack = params["slow"]
    if stack["wqkv"].device.type != "cuda":
        return True
    s = cache_len or cfg.max_seq_len
    return (
        all(stack[k].dtype == torch.bfloat16 for k in STACK_KEYS)
        and cfg.head_dim == HEAD_DIM
        and cfg.n_head * cfg.head_dim == cfg.dim
        and cfg.dim % 8 == 0 and cfg.intermediate_size % 8 == 0
        and 1 <= batch <= MAX_BATCH
        and batch * max(cfg.dim, cfg.intermediate_size) * 2 <= GEMV_SMEM
        and (s + 8 * HEAD_DIM) * 4 <= ATTN_SMEM
    )


def _check(cfg, x0, pos, ck, cv, stack, norm, head, cos_t, sin_t):
    bf16 = {"x0": x0, "ck": ck, "cv": cv, "norm": norm, "output": head,
            **{f"slow.{k}": stack[k] for k in STACK_KEYS}}
    for name, t in bf16.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused_slow_step: {name} must be bfloat16, got {t.dtype}")
    for name, t in {**bf16, "pos": pos, "cos": cos_t, "sin": sin_t}.items():
        if t.device != x0.device:
            raise ValueError(f"fused_slow_step: {name} is on {t.device}, x0 on {x0.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_slow_step: {name} must be contiguous and 16-byte aligned")
    if pos.dtype != torch.int32:
        raise TypeError(f"fused_slow_step: pos must be int32, got {pos.dtype}")
    if cos_t.dtype != torch.float32 or sin_t.dtype != torch.float32:
        raise TypeError("fused_slow_step: rope tables must be float32")
    bsz, d = x0.shape
    n_layer, cb, kv, s, hd = ck.shape
    if not fused_slow_step_supported(cfg, {"slow": stack}, bsz, s):
        raise ValueError(
            f"fused_slow_step: the kernel does not take batch {bsz}, cache {s}, "
            f"dim {cfg.dim}, heads {cfg.n_head}/{cfg.n_local_heads}x{cfg.head_dim}, "
            f"ffn {cfg.intermediate_size}")
    qkv = (cfg.n_head + 2 * kv) * hd
    f = cfg.intermediate_size
    want = {"wqkv": (n_layer, d, qkv), "wo": (n_layer, d, d), "w1": (n_layer, d, f),
            "w3": (n_layer, d, f), "w2": (n_layer, f, d),
            "attention_norm": (n_layer, d), "ffn_norm": (n_layer, d)}
    bad = {k: tuple(stack[k].shape) for k, v in want.items() if tuple(stack[k].shape) != v}
    if (bad or d != cfg.dim or n_layer != cfg.n_layer or kv != cfg.n_local_heads
            or hd != HEAD_DIM or cb != bsz or ck.shape != cv.shape
            or tuple(pos.shape) != (bsz,) or tuple(norm.shape) != (d,)
            or head.dim() != 2 or head.shape[0] != d
            or tuple(cos_t.shape[1:]) != (hd // 2,) or cos_t.shape != sin_t.shape):
        raise ValueError(
            f"fused_slow_step: shapes x0 {tuple(x0.shape)}, pos {tuple(pos.shape)}, cache "
            f"{tuple(ck.shape)}/{tuple(cv.shape)}, head {tuple(head.shape)}, rope "
            f"{tuple(cos_t.shape)}, stack {bad or 'ok'}")
