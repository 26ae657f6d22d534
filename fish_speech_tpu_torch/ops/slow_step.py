"""The whole slow-stack decode step: two CUDA routes and their one plain
PyTorch version.

* 1-4 rows: the persistent kernel (`csrc/slow_step.cu`, one cooperative
  launch of `csrc/decode_stack.cuh`).
* 5 rows and more: the row kernel (`csrc/slow_step_rows.cu`), one
  cooperative persistent launch for each group of at most 32 rows, every
  layer and the head on the tensor cores, its weights streamed ahead
  through a ring (plan `ops/decode_stack.py::rows_plan`).
The route is chosen by the row count alone, so an engine keeps one.

Counterpart of the TPU kernel `fish_speech_tpu/ops/slow_step_pallas.py::
fused_slow_step`: from the embedded input x0 (B, D) at per-row positions
pos, all slow layers with the in-place K/V write at pos[b] and attention
over rows 0..pos[b], then the final norm and the gathered head. The head
product is float32 and unrounded, and silu sees the unrounded float32
w1 product, as in the TPU kernel (slow_step_pallas.py:317-334); the
unfused `models/dual_ar.py::slow_decode_step` rounds both to bf16.
Unlike the JAX function, which returns new caches, both versions here
update ck/cv in place and return (logits, hidden).

An int8-quantized stack (`ops/quant.py`) takes the TPU kernel's int8
body (slow_step_pallas.py:152-174, 198-207, 313-323): each stack product
is bf16(bf16(x @ q) * s), and silu sees that rescaled bf16 w1 product.
The head stays bf16 and its product float32.

The domain is the JAX kernel's (`fused_slow_step_supported` there): any
batch whose cache windows fit 48 MiB with B * S <= 16384, batch 1 always.
"""

from __future__ import annotations

import ctypes

import torch

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.models.dual_ar import _attn_out_ffn, _layer, _project_qkv
from fish_speech_tpu_torch.ops import _cuda_build, decode_stack, launch_count
from fish_speech_tpu_torch.ops.decode_attention import decode_attention_plain
from fish_speech_tpu_torch.ops.norms import rms_norm
from fish_speech_tpu_torch.ops.quant import is_quantized
from fish_speech_tpu_torch.ops.rope import apply_rope_interleaved

launches = 0  # persistent kernel launches since the last reset (set to 0 to reset)
int8_launches = 0  # those of them on int8 stacks (the int8 kernel body)
rows_launches = 0  # the row kernel's launches, as its C entry counts them
rows_int8_launches = 0  # those of them on int8 stacks

HEAD_DIM = decode_stack.HEAD_DIM  # the attention's head dim
MAX_BATCH = decode_stack.MAX_ROWS  # rows the persistent kernel takes; more take the row kernel
ROWS_GROUP = decode_stack.ROWS_GROUP  # rows one launch of the row kernel takes
HEAD_PIECE = 8  # bf16 head columns one 16-byte copy reads
# the JAX kernel's batched bounds (slow_step_pallas.py:488-497)
JAX_WINDOW_BYTES = 48 * 1024 * 1024
JAX_MAX_ROWS_X_CACHE = 16384
MATMUL_KEYS = ("wqkv", "wo", "w1", "w3", "w2")  # order of the C entries' weights and scales
NORM_KEYS = ("attention_norm", "ffn_norm")
INT8_COLS = 16  # int8 weights are read 16 columns (16 bytes) at a time


def stack_weight(w) -> torch.Tensor:
    """The tensor a stack entry streams: the weight, or its int8 q."""
    return w["q"] if is_quantized(w) else w


def stack_dtypes_ok(stack) -> bool:
    """Whether the CUDA kernels take the stack's types: bf16 norms, and
    bf16 matmul weights or int8 ones (all five) with bf16 scales."""
    if any(stack[k].dtype != torch.bfloat16 for k in NORM_KEYS):
        return False
    ws = [stack[k] for k in MATMUL_KEYS]
    if all(is_quantized(w) for w in ws):
        return all(w["q"].dtype == torch.int8 and w["s"].dtype == torch.bfloat16 for w in ws)
    return all(not is_quantized(w) and w.dtype == torch.bfloat16 for w in ws)


def stack_widths_ok(stack) -> bool:
    """int8 weight rows must be whole 16-byte loads."""
    return all(not is_quantized(stack[k]) or stack[k]["q"].shape[-1] % INT8_COLS == 0
               for k in MATMUL_KEYS)


def check_stack(stack, who: str, prefix: str, device) -> None:
    """Raise unless the kernels take the stack: its types, its int8 row
    widths, and every tensor on `device`, contiguous and 16-byte aligned
    (so are the (L, in, out) layer slices, since out % 16 == 0)."""
    if not stack_dtypes_ok(stack):
        got = {k: (str(v["q"].dtype), str(v["s"].dtype)) if is_quantized(v) else str(v.dtype)
               for k, v in stack.items()}
        raise TypeError(f"{who}: {prefix} must be bfloat16, or int8 q with bfloat16 s for all "
                        f"of {MATMUL_KEYS} and bfloat16 norms; got {got}")
    if not stack_widths_ok(stack):
        raise ValueError(f"{who}: int8 {prefix} weights need a multiple of {INT8_COLS} "
                         "output columns")
    for k, v in stack.items():
        for name, t in ({f"{k}.q": v["q"], f"{k}.s": v["s"]} if is_quantized(v) else {k: v}).items():
            if t.device != device:
                raise ValueError(f"{who}: {prefix}.{name} is on {t.device}, not {device}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{who}: {prefix}.{name} must be contiguous and 16-byte aligned")
    for k in MATMUL_KEYS:
        v = stack[k]
        if is_quantized(v) and tuple(v["s"].shape) != (v["q"].shape[0], 1, v["q"].shape[2]):
            raise ValueError(f"{who}: {prefix}.{k}.s has shape {tuple(v['s'].shape)} for q "
                             f"{tuple(v['q'].shape)}")


def stack_pointers(stack):
    """The five matmul weights' pointers in MATMUL_KEYS order and their
    scales' (None for a bf16 stack)."""
    ws = [stack[k] for k in MATMUL_KEYS]
    if is_quantized(ws[0]):
        return [w["q"].data_ptr() for w in ws], [w["s"].data_ptr() for w in ws]
    return [w.data_ptr() for w in ws], [None] * len(ws)


def stack_shapes_bad(stack, n_layer: int, d: int, qkv: int, f: int) -> dict:
    """{key: shape} of the entries whose (weight or q) shape is wrong."""
    want = {"wqkv": (n_layer, d, qkv), "wo": (n_layer, d, d), "w1": (n_layer, d, f),
            "w3": (n_layer, d, f), "w2": (n_layer, f, d),
            "attention_norm": (n_layer, d), "ffn_norm": (n_layer, d)}
    return {k: tuple(stack_weight(stack[k]).shape) for k, v in want.items()
            if tuple(stack_weight(stack[k]).shape) != v}


def fused_slow_step_plain(params, cfg: DualARConfig, x0, pos, ck, cv, rope):
    """x0 (B, D), pos (B,) int, ck/cv (L, B, KV, S, hd), rope (cos, sin)
    tables. Writes each layer's new K/V at row pos[b] in place and
    returns (logits (B, W) float32, hidden (B, D))."""
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


def rows_launches_per_step(n_layer: int, batch: int) -> int:
    """Launches of the row kernel for one step of `batch` rows: one for
    each group of at most 32 rows, whatever the depth (every layer and
    the head run inside the launch)."""
    del n_layer  # the whole stack is one launch
    return -(-batch // ROWS_GROUP)


def rows_plan(cfg: DualARConfig, head_cols: int, cache_len: int, int8: bool, grid: int):
    """The row kernel's plan for this model's slow stack
    (`ops/decode_stack.py::rows_plan`, cached): a function of the shapes
    alone, never of the batch, so a row's bits cannot depend on its
    co-tenants; None when the kernel does not take the shapes."""
    return decode_stack.rows_plan(cfg.dim, cfg.n_head, cfg.n_local_heads, cfg.intermediate_size,
                                  head_cols, cache_len, int8, grid)


def head_stride(width: int) -> int:
    """Columns of the row kernel's head copy: the gathered width (1025 at
    Fish-1.5, 2 at Fish <= 1.4) padded to whole 16-byte pieces."""
    return -(-width // HEAD_PIECE) * HEAD_PIECE


def padded_head(head: torch.Tensor) -> torch.Tensor:
    """The (D, W) head with zero columns up to `head_stride(W)`, for the
    row kernel (whose weight ring copies 16-byte pieces and which writes
    only the W real columns); the head itself when W is a whole number of
    pieces. The engine makes it once; `params["output"]` stays as it is."""
    d, w = head.shape
    if head_stride(w) == w:
        return head
    out = head.new_zeros((d, head_stride(w)))
    out[:, :w] = head
    return out


def fused_slow_step(params, cfg: DualARConfig, x0, pos, ck, cv, rope, *, head_rows=None,
                    sync=None):
    """Same contract as `fused_slow_step_plain`. CPU tensors run the
    plain version; CUDA tensors launch the persistent kernel (1-4 rows,
    one cooperative launch) or the row kernel (5 rows and more, one
    cooperative launch a group of 32 rows), or raise. head_rows: the row
    kernel's padded head (`padded_head` of params["output"]), made here
    when not given. sync: the kernels' grid sync state (an engine's own);
    by default that of the current (device, stream)."""
    if x0.device.type == "cpu":
        return fused_slow_step_plain(params, cfg, x0, pos, ck, cv, rope)
    if x0.device.type != "cuda":
        raise ValueError(f"fused_slow_step: unsupported device {x0.device}")
    stack = params["slow"]
    head = params["output"]
    cos_t, sin_t = rope
    bsz, d = x0.shape
    n_layer, _, kv, s, _ = ck.shape
    f = stack_weight(stack["w1"]).shape[2]
    w = head.shape[1]
    _check(cfg, x0, pos, ck, cv, stack, params["norm"], head, cos_t, sin_t)
    weights, scales = stack_pointers(stack)
    if bsz > MAX_BATCH:
        return _rows_step(params, cfg, x0, pos, ck, cv, cos_t, sin_t, weights, scales,
                          padded_head(head) if head_rows is None else head_rows, sync)
    plan = slow_plan(cfg, w, s, scales[0] is not None, decode_stack.grid_of(x0.device))
    lib = _cuda_build.load_library()
    dev = x0.device
    logits = torch.empty((bsz, w), dtype=torch.float32, device=dev)
    hidden = torch.empty_like(x0)
    scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8, device=dev)
    rc = lib.fs_slow_step(
        x0.data_ptr(), pos.data_ptr(), stack["attention_norm"].data_ptr(),
        stack["ffn_norm"].data_ptr(), *weights, *scales,
        params["norm"].data_ptr(), head.data_ptr(),
        cos_t.data_ptr(), sin_t.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        logits.data_ptr(), hidden.data_ptr(), scratch.data_ptr(),
        (decode_stack.sync_state(dev) if sync is None else sync).data_ptr(),
        bsz, n_layer, d, cfg.n_head, kv, f, w, s, plan.scratch_bytes, float(cfg.norm_eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda_build.check(rc, "fs_slow_step")
    launch_count.add(__name__, launches=1, int8_launches=int(scales[0] is not None))
    return logits, hidden


def rows_step(params, cfg: DualARConfig, x0, pos, ck, cv, rope, *, head_rows=None, sync=None):
    """The row kernel alone, at any batch of at most the JAX bounds
    (`fused_slow_step` takes it from 5 rows): the same contract and plain
    version; for the card's checks of a row alone against the same row
    among its co-tenants."""
    if x0.device.type == "cpu":
        return fused_slow_step_plain(params, cfg, x0, pos, ck, cv, rope)
    cos_t, sin_t = rope
    head = params["output"]
    _check(cfg, x0, pos, ck, cv, params["slow"], params["norm"], head, cos_t, sin_t,
           route_rows=True)
    weights, scales = stack_pointers(params["slow"])
    return _rows_step(params, cfg, x0, pos, ck, cv, cos_t, sin_t, weights, scales,
                      padded_head(head) if head_rows is None else head_rows, sync)


def _rows_step(params, cfg, x0, pos, ck, cv, cos_t, sin_t, weights, scales, head_rows, sync):
    """The row kernel (csrc/slow_step_rows.cu) on checked inputs."""
    stack = params["slow"]
    bsz, d = x0.shape
    n_layer, _, kv, s, _ = ck.shape
    f = stack_weight(stack["w1"]).shape[2]
    w = params["output"].shape[1]
    dev = x0.device
    if (head_rows.dtype != torch.bfloat16 or head_rows.device != dev
            or tuple(head_rows.shape) != (d, head_stride(w)) or not head_rows.is_contiguous()
            or head_rows.data_ptr() % 16):
        raise ValueError(f"fused_slow_step: head_rows must be a contiguous bfloat16 "
                         f"({d}, {head_stride(w)}) on {dev}, the padded head; got "
                         f"{tuple(head_rows.shape)} {head_rows.dtype} on {head_rows.device}")
    plan = rows_plan(cfg, w, s, scales[0] is not None, decode_stack.grid_of(dev))
    logits = torch.empty((bsz, w), dtype=torch.float32, device=dev)
    hidden = torch.empty_like(x0)
    scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8, device=dev)
    launched = ctypes.c_int(0)
    rc = _cuda_build.load_library().fs_slow_step_rows(
        x0.data_ptr(), pos.data_ptr(), stack["attention_norm"].data_ptr(),
        stack["ffn_norm"].data_ptr(), *weights, *scales,
        params["norm"].data_ptr(), head_rows.data_ptr(),
        cos_t.data_ptr(), sin_t.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        logits.data_ptr(), hidden.data_ptr(), scratch.data_ptr(),
        (decode_stack.sync_state(dev) if sync is None else sync).data_ptr(),
        bsz, n_layer, d, cfg.n_head, kv, f, w, head_rows.shape[1], s, plan.scratch_bytes,
        float(cfg.norm_eps), torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launched),
    )
    launch_count.add(__name__, rows_launches=launched.value,
                     rows_int8_launches=launched.value if scales[0] is not None else 0)
    _cuda_build.check(rc, "fs_slow_step_rows")
    return logits, hidden


def slow_plan(cfg: DualARConfig, head_cols: int, cache_len: int, int8: bool, grid: int):
    """The persistent kernel's plan for this model's slow stack
    (`ops/decode_stack.py::stack_plan`), or None when it does not take
    the shapes."""
    return decode_stack.stack_plan(
        decode_stack.SLOW, cfg.dim, cfg.n_head, cfg.n_local_heads, cfg.intermediate_size,
        head_cols, cache_len, int8, grid)


def jax_bounds_ok(cfg: DualARConfig, batch: int, cache_len: int) -> bool:
    """The JAX kernel's domain (slow_step_pallas.py::
    fused_slow_step_supported): batch 1 always; more rows when their cache
    windows, 4 B KV S hd x 2 bytes, fit 48 MiB and B * S <= 16384."""
    if batch <= 1:
        return batch == 1
    window = 4 * batch * cfg.n_local_heads * cache_len * cfg.head_dim * 2
    return window <= JAX_WINDOW_BYTES and batch * cache_len <= JAX_MAX_ROWS_X_CACHE


def fused_slow_step_supported(cfg: DualARConfig, params, batch: int,
                              cache_len: int = 0) -> bool:
    """Whether `fused_slow_step` takes these parameters at this batch and
    cache length: the JAX kernel's domain (an even head dim and
    `jax_bounds_ok`); on CUDA also bf16 stacks or int8 ones with bf16
    scales and out % 16 == 0, head dim 64 with H * hd == D and D one of
    `decode_stack.DIMS`, and each route's limits. The persistent kernel
    (1-4 rows): an ffn width that is a multiple of 64 and a plan
    (`decode_stack.stack_plan`) whose shared memory, with the attention
    scores of the whole cache, fits one block on an SM. The row kernel
    (5 rows and more): an ffn width that is a multiple of 128, a cache of
    at most 4096 and a plan (`decode_stack.rows_plan`) that fits shared
    memory. CPU tensors run the plain version, which takes any dtype."""
    if batch > MAX_BATCH:
        return rows_supported(cfg, params, batch, cache_len)
    s = cache_len or cfg.max_seq_len
    if not _card_ok(cfg, params, batch, s):
        return False
    weight = stack_weight(params["slow"]["wqkv"])
    return weight.device.type != "cuda" or slow_plan(
        cfg, _head_cols(cfg, params), s, is_quantized(params["slow"]["wqkv"]),
        _grid(weight.device)) is not None


def rows_supported(cfg: DualARConfig, params, batch: int, cache_len: int = 0) -> bool:
    """Whether the row kernel (`rows_step`) takes these parameters at this
    batch: as `fused_slow_step_supported` at 5 rows and more."""
    s = cache_len or cfg.max_seq_len
    if not _card_ok(cfg, params, batch, s):
        return False
    stack = params["slow"]
    return (stack_weight(stack["wqkv"]).device.type != "cuda"
            or rows_plan(cfg, _head_cols(cfg, params), s, is_quantized(stack["wqkv"]),
                         _grid(stack_weight(stack["wqkv"]).device)) is not None)


def _card_ok(cfg: DualARConfig, params, batch: int, cache_len: int) -> bool:
    """The JAX domain, and on CUDA the limits both routes share."""
    if cfg.head_dim % 2 or not jax_bounds_ok(cfg, batch, cache_len):
        return False
    stack = params["slow"]
    if stack_weight(stack["wqkv"]).device.type != "cuda":
        return True
    return (stack_dtypes_ok(stack) and stack_widths_ok(stack) and cfg.head_dim == HEAD_DIM
            and cfg.n_head * HEAD_DIM == cfg.dim and cfg.dim in decode_stack.DIMS)


def _head_cols(cfg: DualARConfig, params) -> int:
    return params["output"].shape[1] if "output" in params else cfg.codebook_size + 1


def _grid(device) -> int:
    """The card's SM count; the H100's 132 for a tensor that only looks
    like a CUDA one (the CPU tests)."""
    try:
        return decode_stack.grid_of(device)
    except (AssertionError, RuntimeError):
        return decode_stack.H100_SMS


def _check(cfg, x0, pos, ck, cv, stack, norm, head, cos_t, sin_t, route_rows=False):
    check_stack(stack, "fused_slow_step", "slow", x0.device)
    bf16 = {"x0": x0, "ck": ck, "cv": cv, "norm": norm, "output": head}
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
    supported = rows_supported if route_rows else fused_slow_step_supported
    if not supported(cfg, {"slow": stack, "output": head}, bsz, s):
        raise ValueError(
            f"fused_slow_step: the kernels do not take batch {bsz}, cache {s}, "
            f"dim {cfg.dim}, heads {cfg.n_head}/{cfg.n_local_heads}x{cfg.head_dim}, "
            f"ffn {cfg.intermediate_size}")
    qkv = (cfg.n_head + 2 * kv) * hd
    bad = stack_shapes_bad(stack, n_layer, d, qkv, cfg.intermediate_size)
    if (bad or d != cfg.dim or n_layer != cfg.n_layer or kv != cfg.n_local_heads
            or hd != HEAD_DIM or cb != bsz or ck.shape != cv.shape
            or tuple(pos.shape) != (bsz,) or tuple(norm.shape) != (d,)
            or head.dim() != 2 or head.shape[0] != d
            or tuple(cos_t.shape[1:]) != (hd // 2,) or cos_t.shape != sin_t.shape):
        raise ValueError(
            f"fused_slow_step: shapes x0 {tuple(x0.shape)}, pos {tuple(pos.shape)}, cache "
            f"{tuple(ck.shape)}/{tuple(cv.shape)}, head {tuple(head.shape)}, rope "
            f"{tuple(cos_t.shape)}, stack {bad or 'ok'}")
