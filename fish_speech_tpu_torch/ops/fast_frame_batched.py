"""One whole fast (codebook) frame for B <= 32 rows with per-row sampling:
the persistent CUDA kernel (`csrc/fast_frame_batched.cu`, one cooperative
launch a frame) and its plain PyTorch version.

Counterpart of the TPU kernel `fish_speech_tpu/ops/fast_frame_pallas.py::
fused_fast_frame_batched`: C codebook steps of the fast layers for all
rows, each followed by the row's repetition penalty, the top-k/top-p
draw with the row's temp/top_p/top_k/penalty and Gumbel draws indexed by
rank, the EOS rule and the next step's embedding. As in the batch-1
frame (`ops/fast_frame.py`), the head product is float32 and unrounded
and silu sees the unrounded float32 w1 product; the unfused codebook
loop of `generate/frame.py` rounds both to bf16. An int8-quantized fast
stack takes the TPU kernel's int8 body (fast_frame_pallas.py:532,
569-573, 595-604, 706-712): each stack product is bf16(bf16(x @ q) * s),
and silu sees that rescaled bf16 w1 product.

`rows_gemm` is one GEMM of the launch sequence that kernel replaced, on
its own (the C entry `fs_rows_gemm`), with its plain version
`rows_gemm_plain` and its launch plan `rows_plan`, for the card's checks
and timings of each GEMM; no path of the port calls it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.models.dual_ar import fast_embed, fast_hist_init, fast_step
from fish_speech_tpu_torch.ops import _cuda_build, decode_stack, launch_count
from fish_speech_tpu_torch.ops.fast_frame import MAX_WINDOW
from fish_speech_tpu_torch.ops.norms import rms_norm
from fish_speech_tpu_torch.ops.quant import is_quantized
from fish_speech_tpu_torch.ops.sampling import (
    RepPenWindow, RowSampling, sample_top_k_top_p_dynamic)
from fish_speech_tpu_torch.ops.slow_step import (
    HEAD_DIM, _grid, check_stack, stack_dtypes_ok, stack_pointers, stack_shapes_bad,
    stack_weight, stack_widths_ok)

launches = 0  # kernel launches since the last reset (set to 0 to reset)
int8_launches = 0  # those of them on int8 stacks (the int8 kernel body)

rows_gemm_launches = 0  # fs_rows_gemm launches (set to 0 to reset)

MAX_ROWS = 32  # rows the JAX kernel and this one take

# rows_gemm's modes, in the C entry's order, and its plan's constants
# (csrc/fast_frame_batched.cu)
ROWS_MODES = ("qkv", "residual", "swiglu", "head")
_RG_TILE_N = 64
_RG_BK = 64
_RG_STAGES = 8  # 4 where 8 do not fit
_RG_MAX_SPLITS = 8
_RG_MIN_BLOCKS = 128
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_RG_SMEM_BUDGET = SMEM_LIMIT - 1024  # for the dynamic part, less a margin for the static
_RG_HALF_SM = 113 * 1024  # two such blocks fit on one SM


@dataclasses.dataclass(frozen=True)
class RowsPlan:
    """The launch of one rows_gemm: clusters of `splits` blocks own
    `tile_n` output columns each, a block `k_per_split` rows of K through
    a ring of `stages` chunks. A function of (K, N, mode, weight type)
    only, never of the number of rows: a row's sums run in one order
    whatever its co-tenants."""

    tile_n: int
    splits: int
    k_per_split: int
    stages: int
    smem: int  # dynamic shared memory of one block, bytes
    blocks: int


def rows_plan(k: int, n: int, mode: str, int8: bool) -> RowsPlan:
    """The plan csrc/fast_frame_batched.cu::rows_plan computes: 64-column
    tiles; K split in two until the grid has 128 blocks, 8 splits (the
    portable cluster size) at most, 64 rows of K a split at least; a ring
    of 8 chunks of 64 rows where it fits in shared memory (in half an SM's
    for clusters of 4-8), else 4."""
    tiles = math.ceil(n / _RG_TILE_N)
    splits = 1
    while splits < _RG_MAX_SPLITS and tiles * splits < _RG_MIN_BLOCKS \
            and k >= 2 * splits * _RG_BK:
        splits *= 2
    kb = math.ceil(math.ceil(k / splits) / 16) * 16
    n_w = 2 if mode == "swiglu" else 1
    pitch = _RG_TILE_N * (1 if int8 else 2) + 16

    def smem(stages):
        slots = min(math.ceil(kb / _RG_BK), stages)
        return (slots * n_w * _RG_BK * pitch + MAX_ROWS * (2 * kb + 16) + 2 * kb + 16
                + n_w * MAX_ROWS * _RG_TILE_N * 4)

    # a cluster of 4-8 blocks fits its GPC only if every block leaves room
    # for a second on its SM
    budget = _RG_HALF_SM if splits >= 4 else _RG_SMEM_BUDGET
    stages = _RG_STAGES if smem(_RG_STAGES) <= budget else _RG_STAGES // 2
    return RowsPlan(tile_n=_RG_TILE_N, splits=splits, k_per_split=kb, stages=stages,
                    smem=smem(stages), blocks=tiles * splits)


def _stack_product(h, w):
    """The f32 sum of h @ w; for an int8 w, bf16(bf16(sum) * s) (the TPU
    kernels' _wdot)."""
    if is_quantized(w):
        y = (h.float() @ w["q"].float()).to(torch.bfloat16)
        return (y.float() * w["s"].float()).to(torch.bfloat16).float()
    return h.float() @ w.float()


def rows_gemm_plain(mode: str, x, w, norm_w=None, w_b=None, eps: float = 1e-6, out=None):
    """One GEMM of the batched frame on rows x (nb, K) bf16 with w (K, N)
    bf16 or int8 {"q", "s"}:
      qkv:      bf16(p(RMSNorm(x) @ w))
      residual: out += bf16(p(x @ w)), in place; returns out
      swiglu:   bf16(bf16(silu(p(h @ w))) * bf16(p(h @ w_b))), h = RMSNorm(x)
      head:     RMSNorm(x) @ w in float32, unrounded
    where RMSNorm rounds to bf16 and p is the f32 sum (rescaled for int8)."""
    h = x if mode == "residual" else rms_norm(x, norm_w, eps)
    y = _stack_product(h, w)
    if mode == "qkv":
        return y.to(x.dtype)
    if mode == "residual":
        out.copy_(out + y.to(out.dtype))
        return out
    if mode == "swiglu":
        return F.silu(y).to(x.dtype) * _stack_product(h, w_b).to(x.dtype)
    if mode == "head":
        return y
    raise ValueError(f"rows_gemm: unknown mode {mode!r}")


def rows_gemm(mode: str, x, w, norm_w=None, w_b=None, eps: float = 1e-6, out=None):
    """Same contract as `rows_gemm_plain`. CPU tensors run the plain
    version; CUDA tensors launch the kernel (one fs_rows_gemm) or raise."""
    if x.device.type == "cpu":
        return rows_gemm_plain(mode, x, w, norm_w, w_b, eps, out)
    if x.device.type != "cuda":
        raise ValueError(f"rows_gemm: unsupported device {x.device}")
    if mode not in ROWS_MODES:
        raise ValueError(f"rows_gemm: unknown mode {mode!r}")
    int8 = is_quantized(w)
    weight = w["q"] if int8 else w
    nb, k = x.shape
    n = weight.shape[1]
    if (x.dtype != torch.bfloat16 or not x.is_contiguous() or not 1 <= nb <= MAX_ROWS
            or weight.shape[0] != k or weight.stride(1) != 1
            or weight.dtype != (torch.int8 if int8 else torch.bfloat16)
            or (mode == "swiglu") != (w_b is not None) or (mode == "head" and int8)
            or (mode != "residual" and (norm_w is None or tuple(norm_w.shape) != (k,)))):
        raise ValueError(f"rows_gemm {mode}: x {tuple(x.shape)} {x.dtype}, weight "
                         f"{tuple(weight.shape)} {weight.dtype}")
    lib = _cuda_build.load_library()
    if mode == "head":
        out = torch.empty((nb, n), dtype=torch.float32, device=x.device)
    elif mode == "residual":
        if out is None or tuple(out.shape) != (nb, n) or out.dtype != torch.bfloat16 \
                or not out.is_contiguous():
            raise ValueError(f"rows_gemm residual: out must be a contiguous ({nb}, {n}) bf16")
    else:
        out = torch.empty((nb, n), dtype=torch.bfloat16, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    wb = None if w_b is None else (w_b["q"] if int8 else w_b)
    rc = lib.fs_rows_gemm(
        ROWS_MODES.index(mode), x.data_ptr(), ptr(norm_w), weight.data_ptr(), ptr(wb),
        ptr(w["s"]) if int8 else None, ptr(w_b["s"]) if int8 and w_b is not None else None,
        nb, k, n, weight.stride(0), float(eps),
        None if mode == "head" else out.data_ptr(), out.data_ptr() if mode == "head" else None,
        torch.cuda.current_stream(x.device).cuda_stream)
    _cuda_build.check(rc, "fs_rows_gemm")
    launch_count.add(__name__, rows_gemm_launches=1)
    return out


def rows_plan_on_card(k: int, n: int, mode: str, int8: bool) -> RowsPlan:
    """The plan as the built kernel computes it (fs_rows_gemm_plan), to
    hold `rows_plan` to it."""
    buf = (ctypes.c_int * 6)()
    rc = _cuda_build.load_library().fs_rows_gemm_plan(k, n, ROWS_MODES.index(mode), int(int8),
                                                       ctypes.cast(buf, ctypes.c_void_p))
    _cuda_build.check(rc, "fs_rows_gemm_plan")
    return RowsPlan(tile_n=buf[0], splits=buf[1], k_per_split=buf[2], stages=buf[3],
                    smem=buf[4], blocks=buf[5])


def fused_fast_frame_batched_plain(params, cfg: DualARConfig, samp: RowSampling, hidden,
                                   rp_tokens, gumbel, is_eos, rope, *, rep_enabled: bool,
                                   return_logits: bool = False):
    """hidden (B, D) slow hiddens; samp: the rows' knobs; rp_tokens
    (B, C, W) int32 rep-pen windows (after this frame's push); gumbel
    (B, C, k_dyn) float32, used by rank; is_eos (B,) bool. Returns the
    frame's codebook tokens (B, C) int32, all 0 on EOS rows; with
    return_logits, also each step's head logits (C, B, codebook_size)
    float32 before the penalty."""
    b, n_cb = hidden.shape[0], cfg.num_codebooks
    k_dyn = gumbel.shape[-1]
    hist = fast_hist_init(cfg, b, hidden.dtype, hidden.device)
    x = hidden[:, None, :]
    toks, step_logits = [], []
    for cb in range(n_cb):
        logits, hist = fast_step(params, cfg, x, hist, cb, rope, unrounded=True)
        step_logits.append(logits)
        if rep_enabled:
            window = RepPenWindow(tokens=rp_tokens[:, cb], ptr=0)
            logits = window.penalize_rows(logits, samp.rep_pen)
        tok = sample_top_k_top_p_dynamic(logits, gumbel[:, cb], temp=samp.temp,
                                         top_p=samp.top_p, top_k=samp.top_k, k_max=k_dyn)
        tok = torch.where(is_eos, torch.zeros_like(tok), tok)
        if cb + 1 < n_cb:
            x = fast_embed(params, cfg, tok, cb)
        toks.append(tok)
    tokens = torch.stack(toks, dim=1).to(torch.int32)
    return (tokens, torch.stack(step_logits)) if return_logits else tokens


def fused_fast_frame_batched(params, cfg: DualARConfig, samp: RowSampling, hidden,
                             rp_tokens, gumbel, is_eos, rope, *, rep_enabled: bool,
                             return_logits: bool = False, sync=None):
    """Same contract as `fused_fast_frame_batched_plain`. CPU tensors run
    the plain version; CUDA tensors launch the kernel (one launch a frame)
    or raise. sync: the kernel's grid sync state (an engine's own), with
    which its scratch is kept (`decode_stack.frame_scratch`); by default
    that of the current (device, stream)."""
    if hidden.device.type == "cpu":
        return fused_fast_frame_batched_plain(params, cfg, samp, hidden, rp_tokens, gumbel,
                                              is_eos, rope, rep_enabled=rep_enabled,
                                              return_logits=return_logits)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_fast_frame_batched: unsupported device {hidden.device}")
    cos_t, sin_t = rope
    _check(params, cfg, samp, hidden, rp_tokens, gumbel, is_eos, cos_t, sin_t)
    stack = params["fast"]
    n_layer, d, _ = stack_weight(stack["wqkv"]).shape
    f = stack_weight(stack["w1"]).shape[2]
    weights, scales = stack_pointers(stack)
    b, n_cb, vocab, kv = hidden.shape[0], cfg.num_codebooks, cfg.codebook_size, cfg.n_local_heads
    k_dyn = gumbel.shape[2]
    dev = hidden.device
    plan = frame_plan(cfg, k_dyn, scales[0] is not None, decode_stack.grid_of(dev))
    lib = _cuda_build.load_library()
    state = decode_stack.sync_state(dev) if sync is None else sync
    scratch = decode_stack.frame_scratch(state, plan.rows.scratch_bytes)
    tokens = torch.empty((b, n_cb), dtype=torch.int32, device=dev)
    logits_buf = torch.empty((n_cb, b, vocab), dtype=torch.float32, device=dev)
    head = params["fast_output"]
    rc = lib.fs_fast_frame_batched(
        hidden.data_ptr(), stack["attention_norm"].data_ptr(), stack["ffn_norm"].data_ptr(),
        *weights, *scales, params["fast_norm"].data_ptr(),
        head.data_ptr(), params["fast_embeddings"].data_ptr(),
        cos_t.data_ptr(), sin_t.data_ptr(), rp_tokens.data_ptr(), gumbel.data_ptr(),
        samp.temp.data_ptr(), samp.top_p.data_ptr(), samp.top_k.data_ptr(),
        samp.rep_pen.data_ptr(), is_eos.data_ptr(), tokens.data_ptr(), logits_buf.data_ptr(),
        scratch.data_ptr(), state.data_ptr(),
        b, n_layer, d, cfg.n_head, kv, f, n_cb, vocab, head.shape[1],
        int(cfg.depthwise_output), int(cfg.depthwise_wte), rp_tokens.shape[2], k_dyn,
        int(rep_enabled), scratch.numel(), float(cfg.norm_eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda_build.check(rc, "fs_fast_frame_batched")
    launch_count.add(__name__, launches=1, int8_launches=int(scales[0] is not None))
    return (tokens, logits_buf) if return_logits else tokens


def frame_plan(cfg: DualARConfig, k_dyn: int, int8: bool, grid: int):
    """The kernel's plan for this model's fast stack and a top-k cap of
    k_dyn (`ops/decode_stack.py::frame_plan`, cached): a function of the
    shapes alone, never of the batch; None when the kernel does not take
    them."""
    return decode_stack.frame_plan(cfg.n_fast_layer, cfg.dim, cfg.n_head, cfg.n_local_heads,
                                   cfg.intermediate_size, cfg.num_codebooks, cfg.codebook_size,
                                   k_dyn, int8, grid)


def fused_fast_frame_batched_supported(cfg: DualARConfig, params, batch: int,
                                       dyn_top_k_cap: int = 256) -> bool:
    """Whether `fused_fast_frame_batched` takes these parameters: the JAX
    kernel's bounds (1 <= batch <= 32, an even head dim, codebook tiles
    and depthwise blocks that divide, a top-k cap that is a multiple of
    128 or covers the codebook); on CUDA also the kernel's limits (bf16
    stacks or int8 ones with bf16 scales and out % 16 == 0, head dim 64,
    and a plan (`frame_plan`: H * hd == D with D one of
    `decode_stack.DIMS`, whole 128-column slices of F, a codebook of at
    most 4096 entries, a multiple of 8) that fits one block on an SM)."""
    vocab = cfg.codebook_size
    if (not 1 <= batch <= MAX_ROWS or cfg.head_dim % 2 or vocab % min(128, vocab)
            or (dyn_top_k_cap % 128 and dyn_top_k_cap < vocab)):
        return False
    if cfg.num_codebooks > 1 and ((cfg.depthwise_output and vocab % 128)
                                  or (cfg.depthwise_wte and vocab % 8)):
        return False
    stack = params["fast"]
    weight = stack_weight(stack["wqkv"])
    if weight.device.type != "cuda":
        return True
    return (
        stack_dtypes_ok(stack) and stack_widths_ok(stack)
        and cfg.head_dim == HEAD_DIM
        and frame_plan(cfg, min(dyn_top_k_cap, vocab), is_quantized(stack["wqkv"]),
                       _grid(weight.device)) is not None
    )


def _check(params, cfg, samp, hidden, rp_tokens, gumbel, is_eos, cos_t, sin_t):
    stack = params["fast"]
    who = "fused_fast_frame_batched"
    check_stack(stack, who, "fast", hidden.device)
    bf16 = {"hidden": hidden, "fast_norm": params["fast_norm"],
            "fast_output": params["fast_output"],
            "fast_embeddings": params["fast_embeddings"]}
    for name, t in bf16.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{who}: {name} must be bfloat16, got {t.dtype}")
    typed = {"rp_tokens": (rp_tokens, torch.int32), "gumbel": (gumbel, torch.float32),
             "is_eos": (is_eos, torch.bool), "cos": (cos_t, torch.float32),
             "sin": (sin_t, torch.float32), "temp": (samp.temp, torch.float32),
             "top_p": (samp.top_p, torch.float32), "top_k": (samp.top_k, torch.int32),
             "rep_pen": (samp.rep_pen, torch.float32)}
    for name, (t, dtype) in typed.items():
        if t.dtype != dtype:
            raise TypeError(f"{who}: {name} must be {dtype}, got {t.dtype}")
    for name, t in {**bf16, **{k: v[0] for k, v in typed.items()}}.items():
        if t.device != hidden.device:
            raise ValueError(f"{who}: {name} is on {t.device}, hidden on {hidden.device}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    b = hidden.shape[0]
    if not fused_fast_frame_batched_supported(cfg, params, b, gumbel.shape[-1]):
        raise ValueError(
            f"{who}: the kernel does not take batch {b}, dim {cfg.dim}, heads "
            f"{cfg.n_head}x{cfg.head_dim}, codebook {cfg.codebook_size}")
    n_cb, vocab, d = cfg.num_codebooks, cfg.codebook_size, cfg.dim
    qkv = (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim
    bad = stack_shapes_bad(stack, cfg.n_fast_layer, d, qkv, cfg.intermediate_size)
    if (bad or tuple(hidden.shape) != (b, d)
            or tuple(params["fast_output"].shape) != (d, cfg.fast_output_size)
            or params["fast_embeddings"].shape[0] < cfg.fast_vocab_size
            or params["fast_embeddings"].shape[1] != d
            or rp_tokens.dim() != 3 or tuple(rp_tokens.shape[:2]) != (b, n_cb)
            or not 1 <= rp_tokens.shape[2] <= MAX_WINDOW
            or gumbel.dim() != 3 or tuple(gumbel.shape[:2]) != (b, n_cb)
            or not 1 <= gumbel.shape[2] <= vocab
            or tuple(is_eos.shape) != (b,)
            or any(tuple(t.shape) != (b,) for t in samp)
            or cos_t.shape[0] < n_cb or tuple(cos_t.shape[1:]) != (HEAD_DIM // 2,)
            or cos_t.shape != sin_t.shape):
        raise ValueError(
            f"{who}: shapes hidden {tuple(hidden.shape)}, fast_output "
            f"{tuple(params['fast_output'].shape)}, fast_embeddings "
            f"{tuple(params['fast_embeddings'].shape)}, rp_tokens {tuple(rp_tokens.shape)}, "
            f"gumbel {tuple(gumbel.shape)}, is_eos {tuple(is_eos.shape)}, sampling "
            f"{[tuple(t.shape) for t in samp]}, rope {tuple(cos_t.shape)}, stack {bad or 'ok'}")
