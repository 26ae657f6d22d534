"""The native audio runtime (`libfishaudio.so`): find it, or build it once.

The library is `native/fishaudio.cpp`: the streaming Ogg/Opus encoder and
the MP3 / Ogg Vorbis / Ogg Opus / FLAC decoders, linked against libopus,
libmpg123 and libvorbisfile. It is looked for, in order, at

- the path in `FISH_TORCH_NATIVE_LIB`;
- `fish_speech_tpu_torch/_native/libfishaudio.so` (an installed package);
- `build/native/<key>/libfishaudio.so` of a checkout, where `<key>` hashes
  the source and the flags.

In a checkout where none exists, the first `load()` compiles
`native/fishaudio.cpp` with the flags of `native/Makefile` (its `?=`
variables, which the environment may override as make lets it) into that
`build/` directory; nothing is written into `native/`. When the compiler
fails, its stderr is kept (`build_error()`), `load()` returns None and
`available()` is False, and the callers say so: the server answers 501
to an Opus request.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger(__name__)

ENV_VAR = "FISH_TORCH_NATIVE_LIB"
LIB_NAME = "libfishaudio.so"
_PACKAGE = Path(__file__).resolve().parents[1]
_REPO = _PACKAGE.parent

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


def native_source_dir() -> Path:
    """The checkout's `native/` (source and Makefile), read only."""
    return _REPO / "native"


def makefile_vars() -> Dict[str, str]:
    """The `NAME ?= value` lines of native/Makefile, each overridden by
    the environment variable of that name, as make does."""
    text = (native_source_dir() / "Makefile").read_text()
    found = dict(re.findall(r"^([A-Z]+)\s*\?=\s*(.*?)\s*$", text, flags=re.M))
    return {k: os.environ.get(k, v) for k, v in found.items()}


def _build_dir() -> Path:
    src = native_source_dir() / "fishaudio.cpp"
    flags = makefile_vars()
    key = hashlib.sha1(src.read_bytes() + repr(sorted(flags.items())).encode()).hexdigest()
    return _REPO / "build" / "native" / key[:12]


def find_lib() -> Optional[Path]:
    """The first library that exists, or None. Does not build."""
    override = os.environ.get(ENV_VAR)
    if override:
        if Path(override).exists():
            return Path(override)
        logger.warning("%s=%s does not exist; looking in the package and build/", ENV_VAR,
                       override)
    packaged = _PACKAGE / "_native" / LIB_NAME
    if packaged.exists():
        return packaged
    if (native_source_dir() / "fishaudio.cpp").exists():
        built = _build_dir() / LIB_NAME
        if built.exists():
            return built
    return None


def build_lib(timeout: float = 120.0) -> Optional[Path]:
    """Compile native/fishaudio.cpp into build/native/<key>/. Returns the
    library's path, or None with the compiler's stderr in build_error().
    The output is written to a file of this process's own and renamed into
    place, so that processes building at once do not see a partial file."""
    global _error
    src = native_source_dir() / "fishaudio.cpp"
    if not src.exists():
        _error = f"{src} is missing (not a checkout)"
        return None
    flags = makefile_vars()
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.{threading.get_ident()}"
    cmd = [flags.get("CXX", "g++"), *flags.get("CXXFLAGS", "").split(), str(src), "-o",
           str(tmp), *flags.get("LDFLAGS", "").split()]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as exc:
        _error = f"{' '.join(cmd)}: {exc}"
        return None
    if proc.returncode != 0:
        _error = f"{' '.join(cmd)} exited {proc.returncode}: {proc.stderr.strip()}"
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out_dir / LIB_NAME)
    return out_dir / LIB_NAME


def _declare(lib: ctypes.CDLL) -> None:
    """The C signatures of every entry point the port calls."""
    c_float_p = ctypes.POINTER(ctypes.c_float)
    lib.fa_ogg_opus_create.restype = ctypes.c_void_p
    lib.fa_ogg_opus_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fa_ogg_opus_encode.restype = ctypes.c_int
    lib.fa_ogg_opus_encode.argtypes = [ctypes.c_void_p, c_float_p, ctypes.c_int, ctypes.c_int]
    lib.fa_ogg_opus_pending.restype = ctypes.c_int
    lib.fa_ogg_opus_pending.argtypes = [ctypes.c_void_p]
    lib.fa_ogg_opus_read.restype = ctypes.c_int
    lib.fa_ogg_opus_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
                                     ctypes.c_int]
    lib.fa_ogg_opus_destroy.restype = None
    lib.fa_ogg_opus_destroy.argtypes = [ctypes.c_void_p]
    lib.fa_decode_auto.restype = ctypes.c_int
    lib.fa_decode_auto.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.POINTER(c_float_p),
                                   ctypes.POINTER(ctypes.c_longlong),
                                   ctypes.POINTER(ctypes.c_int)]
    for name in ("fa_decode_opus_packets", "fa_decode_vorbis_packets"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                       ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                       ctypes.POINTER(c_float_p), ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_int)]
    lib.fa_free.restype = None
    lib.fa_free.argtypes = [ctypes.c_void_p]


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, found or built at the first call; None where
    it cannot be had (the reason in build_error())."""
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = find_lib() or build_lib()
        if path is None:
            logger.warning("native audio runtime unavailable: %s", _error)
            return None
        try:
            lib = ctypes.CDLL(str(path))
            _declare(lib)
        except (OSError, AttributeError) as exc:
            _error = f"{path}: {exc}"
            logger.warning("native audio runtime unavailable: %s", _error)
            return None
        _lib = lib
        return lib


def available() -> bool:
    return load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be had, or None."""
    return _error
