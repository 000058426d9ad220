"""Float64 NumPy reference of the polyphase analysis bank.

Written from the bank's definition, not from its implementation: channel
k is the wideband signal mixed down by k * spacing, low-pass filtered by
the prototype and kept every hop (P = M/2 samples),

    y_k[n] = sum_m h[m] x[nP + L-1 - m] exp(-j 2 pi k (nP + L-1 - m) / M)

with x preceded by L - P zero samples (a fresh analyzer's history).  The
sum is evaluated as a polyphase fold followed by an M-point FFT, in
float64 — no matmul, no precision setting, no shared code with
dsp/channelizer.py except the prototype taps.
"""

from __future__ import annotations

import numpy as np


def analyze_ref(x: np.ndarray, taps: np.ndarray, M: int) -> np.ndarray:
    """x: (N, 2) riq with N a multiple of M/2; taps: (L,) prototype, L a
    multiple of M.  Returns complex128 (M, N // (M/2)) channel-major."""
    taps = np.asarray(taps, np.float64)
    L, P = len(taps), M // 2
    xc = np.asarray(x, np.float64) @ np.array([1.0, 1j])
    xe = np.concatenate([np.zeros(L - P, np.complex128), xc])
    nh = len(xc) // P
    # window of hop n covers xe[nP : nP + L]; sample nP + i carries
    # h[L-1-i] and the mixer phase exp(-j 2 pi k (nP + i) / M)
    idx = np.arange(nh)[:, None] * P + np.arange(L)[None, :]
    win = xe[idx] * taps[::-1][None, :]                       # (nh, L)
    folded = win.reshape(nh, L // M, M).sum(axis=1)           # (nh, M)
    y = np.fft.fft(folded, axis=1)                            # e^{-j2pi k i/M}
    k = np.arange(M)[None, :]
    n = np.arange(nh)[:, None]
    y = y * np.exp(-2j * np.pi * k * (n * P % M) / M)
    return y.T
