"""Where the port keeps its compiled kernels: the counterpart of the JAX
package's `utils/cache.py`.

The JAX package points XLA's persistent compilation cache at
$FISH_TPU_CACHE_DIR so that a restart skips its compiles. The port's
only compile artifact is the kernel library that `ops/_cuda_build.py`
builds (one nvcc a source) into `<dir>/<hash of the sources and
flags>/libfstorch.so`; a process that finds it there loads it instead of
building. The default directory is `build/torch_kernels/` beside the
package; $FISH_TPU_CACHE_DIR overrides it. Nothing is seeded: the repo
commits no binaries.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def setup_compilation_cache(cache_dir: Optional[str | Path] = None) -> str:
    """Build and find the kernel library under cache_dir (default:
    $FISH_TPU_CACHE_DIR, else build/torch_kernels/ beside the package).
    Call it before the first kernel launch: a library already loaded in
    this process stays loaded. Returns the directory."""
    from fish_speech_tpu_torch.ops import _cuda_build

    path = Path(cache_dir or os.environ.get("FISH_TPU_CACHE_DIR")
                or _cuda_build.DEFAULT_BUILD_ROOT)
    _cuda_build.BUILD_ROOT = path
    return str(path)
