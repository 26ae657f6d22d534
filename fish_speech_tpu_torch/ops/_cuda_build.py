"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by its own plain `nvcc -c` call, all
started together, and one more `nvcc` call links the objects into a
shared library with a C interface, `libfstorch.so`, which is loaded with
`ctypes`. Sources include no PyTorch header, so the build takes seconds
and needs neither `ninja` nor `torch.utils.cpp_extension`. The library
lands in `build/torch_kernels/<hash of the sources and flags>/` beside
the package (or under $FISH_TPU_CACHE_DIR: `utils/cache.py`), so a
changed source builds anew and an unchanged one is loaded from disk.

Nothing is built at import: `load_library()` builds on first use, and
raises (with nvcc's stderr) when nvcc is missing or fails. There is no
CPU fallback here; the wrappers run their plain PyTorch versions only
for CPU tensors and never reach this module for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
BUILD_ROOT = DEFAULT_BUILD_ROOT  # utils/cache.py::setup_compilation_cache sets it
LIB_NAME = "libfstorch.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes. Every pointer and the stream are
# c_void_p (a bare Python int would be cut to 32 bits), ints are c_int.
SIGNATURES = {
    # q, k_new, v_new, pos, ck, cv, out,
    # B, H, KV, S, L, layer, cluster, scale, stream
    "fs_decode_attention": [_P] * 7 + [_I] * 7 + [_F, _P],
    # q, k, v, seq_lens, out, scratch, B, H, KV, S_pad, E, k_sb, k_skv,
    # offset, window, scale, sms, stream, launched (1 int out)
    "fs_prefill_attention": [_P] * 6 + [_I] * 9 + [_F, _I, _P, _P],
    # S_pad, E, H, KV, sms, plan (11 ints out)
    "fs_prefill_plan": [_I] * 5 + [_P],
    # S_pad, E, H, KV, sms, B, offset, window, seq_lens (B ints in),
    # work (8 ints a CTA out)
    "fs_prefill_cta_work": [_I] * 8 + [_P, _P],
    # The three stack entries take the layer stacks as attn_norm,
    # ffn_norm, then the five weights wqkv, wo, w1, w3, w2 (bf16, or int8
    # q) and their five scales (bf16 s; all null for a bf16 stack).
    # x0, pos, attn_norm, ffn_norm, 5 weights, 5 scales, norm, head,
    # cos, sin, ck, cv, logits, hidden, scratch, state,
    # B, L, D, H, KV, F, W, S, scratch_bytes, eps, stream
    "fs_slow_step": [_P] * 24 + [_I] * 9 + [_F, _P],
    # x0, pos, attn_norm, ffn_norm, 5 weights, 5 scales, norm, head (padded),
    # cos, sin, ck, cv, logits, hidden, scratch, state,
    # B, L, D, H, KV, F, W, head_ld, S, scratch_bytes, eps, stream,
    # launched (1 int out)
    "fs_slow_step_rows": [_P] * 24 + [_I] * 10 + [_F, _P, _P],
    # D, H, KV, F, W, S, int8, plan (25 ints out)
    "fs_slow_step_rows_plan": [_I] * 7 + [_P],
    # hidden, attn_norm, ffn_norm, 5 weights, 5 scales, fast_norm, head,
    # emb, cos, sin, window, gumbel, is_eos, tokens, logits, k_hist,
    # v_hist, scratch, state,
    # L, D, H, KV, F, C, V, head_ld, depthwise_output, depthwise_wte,
    # window_len, k_eff, rep_enabled, scratch_bytes, temp, top_p, penalty,
    # eps, stream
    "fs_fast_frame": [_P] * 27 + [_I] * 14 + [_F] * 4 + [_P],
    # fast, D, H, KV, F, head_n, S, int8, plan (24 ints out)
    "fs_decode_stack_plan": [_I] * 8 + [_P],
    # hidden, attn_norm, ffn_norm, 5 weights, 5 scales, fast_norm, head,
    # emb, cos, sin, window, gumbel, temp, top_p, top_k, penalty, is_eos,
    # tokens, logits, scratch, state,
    # B, L, D, H, KV, F, C, V, head_ld, depthwise_output, depthwise_wte,
    # window_len, k_dyn, rep_enabled, scratch_bytes, eps, stream
    "fs_fast_frame_batched": [_P] * 29 + [_I] * 15 + [_F, _P],
    # L, D, H, KV, F, C, V, k_dyn, int8, plan (28 ints out)
    "fs_fast_frame_batched_plan": [_I] * 9 + [_P],
    # mode, in, norm_w, w, w_b, scale, scale_b, nb, K, N, ldw, eps, out,
    # out_f32, stream
    "fs_rows_gemm": [_I] + [_P] * 6 + [_I] * 4 + [_F] + [_P] * 3,
    # K, N, mode, int8, plan (6 ints out)
    "fs_rows_gemm_plan": [_I] * 4 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the build, if one ran
nvcc_log: str = ""  # nvcc's stderr of the last build (ptxas register report)


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot "
        "be built, and CUDA tensors have no fallback"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into <BUILD_ROOT>/<hash>/libfstorch.so
    unless that file exists: one `nvcc -c` per source, all running at
    once, then one link. Returns the library's path."""
    global build_seconds, nvcc_log
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"  # nvcc goes by the suffix
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((src, obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs = []
    failed = None
    for src, _, cmd, proc in jobs:
        _, err = proc.communicate()
        logs.append(f"== {src.name}\n{err}")
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd, err)
    if failed is not None:
        rc, cmd, err = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")
    tmp = out_dir / f"{tag}.{LIB_NAME}"
    cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp)] + [str(j[1]) for j in jobs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for _, obj, _, _ in jobs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file
    build_seconds = time.perf_counter() - t0
    nvcc_log = "\n".join(logs)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def load_variant(name: str, defines) -> ctypes.CDLL:
    """The kernels built on the side with extra `-D` defines (an
    instrumented or variant copy, for the timing and trace scripts) into
    build/<name>/, loaded in place of the library: the wrappers launch
    them from then on. Built anew on every call; not for the port's own
    paths."""
    global _lib
    out = DEFAULT_BUILD_ROOT.parent / name
    out.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    flags = [*NVCC_FLAGS[:-2], *(f"-D{d}" for d in defines)]
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out / f"{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *flags, "-c", "-o", str(obj), str(src)],
                                      stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(err)
    lib_path = out / f"lib{name}.so"
    subprocess.run([nvcc, *flags[:2], "-shared", "-o", str(lib_path), *map(str, objs)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn_name, argtypes in SIGNATURES.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaGetLastError() code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
