"""Linear-interpolation resampler, the port's own copy of the JAX
package's `audio/resample.py` (numpy only): `resample` for a whole
signal, with the exact integer output length, and `StreamingResampler`,
whose chunked output concatenates to `resample`'s bit for bit."""

from __future__ import annotations

import numpy as np


def resample(pcm: np.ndarray, from_rate: int, to_rate: int) -> np.ndarray:
    """pcm: (C, T) or (T,) float32 -> the same layout at to_rate, by
    linear interpolation between the two neighbouring input samples."""
    if from_rate == to_rate:
        return pcm
    squeeze = pcm.ndim == 1
    x = np.atleast_2d(np.asarray(pcm, dtype=np.float32))
    c, n = x.shape
    ratio = to_rate / from_rate
    # exact integer ceil (a float64 ceil can overshoot by one sample on
    # exact ratios)
    out_len = (n * to_rate + from_rate - 1) // from_rate
    pos = np.arange(out_len, dtype=np.float64) / ratio
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(np.ceil(pos).astype(np.int64), n - 1)
    t = (pos - lo).astype(np.float32)
    out = x[:, lo] * (1.0 - t) + x[:, hi] * t
    return out[0] if squeeze else out


class StreamingResampler:
    """Chunked linear-interpolation resampler whose concatenated output
    equals `resample()` over the whole signal.

    Resampling each chunk on its own would restart the interpolation
    phase at every boundary (a click at a non-integer rate ratio); this
    carries the read position and the input it still needs across
    chunks. Output lags until an output sample's right neighbour has
    arrived; `process(..., final=True)` flushes the clamped tail as the
    whole-signal path computes it.
    """

    def __init__(self, from_rate: int, to_rate: int) -> None:
        self.from_rate = from_rate
        self.to_rate = to_rate
        self._ratio = to_rate / from_rate
        self._buf = np.zeros(0, np.float32)
        self._buf_start = 0  # absolute input index of _buf[0]
        self._n_out = 0  # absolute output samples emitted

    def process(self, pcm: np.ndarray, *, final: bool = False) -> np.ndarray:
        pcm = np.asarray(pcm, dtype=np.float32).ravel()
        if self.from_rate == self.to_rate:
            return pcm
        if pcm.size:
            self._buf = np.concatenate([self._buf, pcm])
        f, t = self.from_rate, self.to_rate
        total_in = self._buf_start + len(self._buf)
        if total_in == 0:
            return np.zeros(0, np.float32)
        if final:
            j_end = (total_in * t + f - 1) // f  # whole-signal out_len
        else:
            # emit j only when its ceil-neighbor is already buffered:
            # conservative integer bound floor(j*f/t) + 1 <= total_in - 1
            # (the final flush emits the <=1-sample remainder exactly)
            j_end = max(((total_in - 2) * t) // f, 0)
            while (j_end * f) // t + 1 <= total_in - 2:
                j_end += 1
        j_end = max(j_end, self._n_out)
        js = np.arange(self._n_out, j_end, dtype=np.int64)
        # same float expression as resample() -> bitwise-identical output
        pos = js.astype(np.float64) / self._ratio
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(np.ceil(pos).astype(np.int64), total_in - 1)
        frac = (pos - lo).astype(np.float32)
        b = self._buf_start
        # f64 floor(j/ratio) can land one BELOW the integer floor
        # (j*f)//t (e.g. j=240 at 44100->24000); the left-margin sample
        # kept by `keep_from - 1` below makes lo - b >= 0 in that case.
        # Clamp anyway so pathological drift can never wrap to -1 and
        # read the newest sample instead of the oldest.
        out = (self._buf[np.maximum(lo - b, 0)] * (1.0 - frac)
               + self._buf[hi - b] * frac)
        self._n_out = j_end
        # drop input no future output can read (next j reads floor pos;
        # minus 1 sample of left margin for the f64-vs-integer floor skew)
        keep_from = max((self._n_out * f) // t - 1, 0)
        drop = min(max(keep_from - b, 0), len(self._buf))
        if drop:
            self._buf = self._buf[drop:]
            self._buf_start += drop
        return out
