"""Ratio-2 oversampled polyphase channelizers (analysis + synthesis).

This is the array-native replacement for the reference's manual per-channel
mixer bank (analog_sig_source + multiply + add at 60/90/120 kHz,
grc/ampsbs.grc:841-904 and grc/ampsbs_rvc.grc) and the scalability path to
1000+ simultaneous AMPS channels (BASELINE.json): one wideband stream at
M x 30 kHz <-> M channel streams at 60 ksps (2x oversampled so the 30 kHz
channel shape fits without aliasing).

Design notes (ROADMAP S6 re-measures each on the GPU):
* The channel transform is a DENSE DFT-as-matmul with precomputed
  cos/sin matrices — a matrix unit runs it faster than scattered FFT
  butterflies for M up to a few hundred, and it keeps the whole
  pipeline real-valued (riq float32 (..., 2)); no complex dtypes, no
  jnp.fft.
* The polyphase fold is a windowed gather + reshape + sum — XLA fuses it
  with the matmuls.
* Hop size P = M/2 (2x oversampling) makes the per-hop phase correction
  a ±1 sign pattern ((-1)^(k·n)), carried across blocks via a hop index
  in the streaming state.

Math (weighted overlap-add form; h = prototype lowpass, L = M*T taps):
  analysis   y_k[n] = (-1)^{k n} * sum_r E+[k,r] v_n[r],
             v_n[r] = fold mod M of h[m] x[nP-m] over the hop-n window
  synthesis  x[s]   = sum_n g[s-nP] * u_n[(s-nP) mod M],
             u_n[m] = sum_k (-1)^{k n} Y_k[n] E+[k,m]
Channel k sits at center frequency +k*Δf (k mod M; k>M/2 => negative).
Both transforms share one symmetric (M, M) cos/sin matrix pair.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from amps_tpu.dsp.windows import _window


@dataclasses.dataclass(frozen=True)
class ChannelizerSpec:
    num_channels: int          # M (even)
    taps_per_phase: int = 8    # T
    spacing_hz: float = 30_000.0

    @property
    def hop(self) -> int:
        return self.num_channels // 2

    @property
    def ntaps(self) -> int:
        return self.num_channels * self.taps_per_phase

    @property
    def fs(self) -> float:
        """Wideband sample rate."""
        return self.num_channels * self.spacing_hz

    @property
    def channel_rate(self) -> float:
        """Per-channel output rate (2x oversampled)."""
        return 2 * self.spacing_hz


@functools.cache
def prototype_taps(M: int, T: int) -> np.ndarray:
    """Prototype lowpass: cutoff Δf/2, length exactly M*T, unity DC gain.

    Windowed sinc at normalized cutoff 0.5/M cycles/sample (= 15 kHz at
    Δf = 30 kHz), Blackman-Harris window for >90 dB stopband so adjacent
    30 kHz channels don't leak.
    """
    n = M * T
    mid = (n - 1) / 2
    t = np.arange(n) - mid
    fc = 0.5 / M
    x = 2 * np.pi * fc * t
    safe = np.where(t == 0, 1.0, x)
    sinc = np.where(t == 0, 2 * np.pi * fc, np.sin(safe) / safe * 2 * np.pi * fc) \
        / (2 * np.pi * fc)
    w = _window("blackman_harris", n)
    taps = sinc * w
    taps = taps / taps.sum()
    return taps.astype(np.float32)


@functools.cache
def _dft_mats(M: int) -> Tuple[np.ndarray, np.ndarray]:
    """E+[k,m] = exp(+j 2π k m / M) as (cos, sin) float32 matrices
    (symmetric, shared by analysis and synthesis)."""
    k = np.arange(M)
    km = np.outer(k, k) % M
    ang = 2.0 * np.pi * km / M
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.cache
def _dft_split_mats(M: int, M2: int):
    """Two-stage Cooley-Tukey factors of E+ for M = M1*M2.

    With r = m1 + M1*m2 and k = k2 + M2*k1:
      E+[k,r] = E1+[k1,m1] * tw[k2,m1] * E2+[k2,m2],
      tw[k2,m1] = exp(+j 2π k2 m1 / M).
    Cuts the transform from M^2 to M*(M1+M2) MACs per hop — 8x fewer at
    M=1024 (M2=128), with a 128-deep contraction in stage 1.
    Returns (C2, S2, C1, S1, twc, tws) float32.
    """
    assert M % M2 == 0
    M1 = M // M2
    C2, S2 = _dft_mats(M2)
    C1, S1 = _dft_mats(M1)
    ang = 2.0 * np.pi * np.outer(np.arange(M2), np.arange(M1)) / M
    return (C2, S2, C1, S1,
            np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@functools.cache
def _dft_mats_folded(M: int):
    """Transform matrices with the polyphase permutation absorbed.

    The fold produces two banks fo/fe (odd/even q_w phases); the
    classic path materializes v[r] = {fo[P-1-r], fe[M-1-r]} (flip +
    concat + transpose) before the (M, M) matmul.  Absorbing the
    permutation into the matrix columns instead,
      y[k,n] = sum_q Eo[k,q] fo[n,q] + Ee[k,q] fe[n,q],
      Eo[k,q] = E+[k, P-1-q],  Ee[k,q] = E+[k, M-1-q],
    the banks feed the matmul directly in their natural (Nh, P) layout —
    no flip, no concat, no transpose materialization.
    Returns (Co, So, Ce, Se), each (M, P) float32.
    """
    P = M // 2
    k = np.arange(M)[:, None]
    q = np.arange(P)[None, :]
    ang_o = 2.0 * np.pi * ((k * (P - 1 - q)) % M) / M
    ang_e = 2.0 * np.pi * ((k * (M - 1 - q)) % M) / M
    return (np.cos(ang_o).astype(np.float32),
            np.sin(ang_o).astype(np.float32),
            np.cos(ang_e).astype(np.float32),
            np.sin(ang_e).astype(np.float32))


@functools.cache
def _dft_mats_folded_fused(M: int) -> np.ndarray:
    """One (2M, 4P) matrix computing BOTH derotated output planes from
    the concatenated fold banks in a single matmul.

    With v_cat = [or | oi | er | ei] (the odd/even bank I/Q planes along
    the contraction axis) and the per-channel derotation e^{+j 2π k / M}
    (rc, rs) absorbed into the rows,
        out[:M]  = yr2 = Re{ e^{+j2πk/M} (Eo (or + j oi) + Ee (er + j ei)) }
        out[M:]  = yi2 = Im{ ... }
    Versus four (M, P) matrices applied twice each (8 dots), the fused
    operand is read ONCE — half the dominant HBM traffic of the analyze
    stage — at identical FLOPs, and the derotation costs nothing."""
    P = M // 2
    Co, So, Ce, Se = _dft_mats_folded(M)
    ang = 2.0 * np.pi * np.arange(M) / M
    rc = np.cos(ang).astype(np.float32)[:, None]
    rs = np.sin(ang).astype(np.float32)[:, None]
    A = np.zeros((2 * M, 4 * P), np.float32)
    A[:M, 0 * P:1 * P] = rc * Co - rs * So
    A[:M, 1 * P:2 * P] = -(rc * So + rs * Co)
    A[:M, 2 * P:3 * P] = rc * Ce - rs * Se
    A[:M, 3 * P:4 * P] = -(rc * Se + rs * Ce)
    A[M:, 0 * P:1 * P] = rs * Co + rc * So
    A[M:, 1 * P:2 * P] = rc * Co - rs * So
    A[M:, 2 * P:3 * P] = rs * Ce + rc * Se
    A[M:, 3 * P:4 * P] = rc * Ce - rs * Se
    return A


def default_split(M: int) -> int:
    """Auto split factor M2 for the channel transform: 0, the dense
    (M, M) matmul pair, at every M.  On an H100 the dense form
    synthesizes the bench's 1024-channel TX block in 0.580 ms against
    0.618 ms for the two-stage split=128 (tools/profile_rx_block.py);
    tensor cores make the split's 8x FLOP saving worth less than its
    extra passes.  The RX bank fold ("bank") takes no split; synthesis
    and the conv/shift folds do."""
    return 0


def _transform_chmajor(vr, vi, M: int, bf16: bool, split: int):
    """y[k,n] = sum_r E+[k,r] v[r,n] on channel-major (..., M, Nh) planes.
    split=0: dense (M, M) matmul pair; split=M2: two-stage Cooley-Tukey.
    bf16: matmuls in bfloat16 with f32 accumulation."""
    if bf16:
        def dot(expr, A, b):
            return jnp.einsum(expr, A.astype(jnp.bfloat16),
                              b.astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32)
    else:
        dot = jnp.einsum
    if not split:
        C, S = (jnp.asarray(a) for a in _dft_mats(M))
        yr = dot("kr,...rn->...kn", C, vr) - dot("kr,...rn->...kn", S, vi)
        yi = dot("kr,...rn->...kn", S, vr) + dot("kr,...rn->...kn", C, vi)
        return yr, yi
    M2 = split
    M1 = M // M2
    C2, S2, C1, S1, twc, tws = (jnp.asarray(a)
                                for a in _dft_split_mats(M, M2))
    shp = vr.shape[:-2]
    Nh = vr.shape[-1]
    v2r = vr.reshape(shp + (M2, M1, Nh))     # [m2, m1] = r = m1 + M1*m2
    v2i = vi.reshape(shp + (M2, M1, Nh))
    # stage 1: contract m2 (depth M2)
    Ar = dot("ab,...bmn->...amn", C2, v2r) - dot("ab,...bmn->...amn", S2, v2i)
    Ai = dot("ab,...bmn->...amn", S2, v2r) + dot("ab,...bmn->...amn", C2, v2i)
    # twiddle (elementwise)
    tc = twc[:, :, None]
    ts = tws[:, :, None]
    Br = tc * Ar - ts * Ai
    Bi = ts * Ar + tc * Ai
    # stage 2: contract m1; output index [k1, k2] flattens to k = k2+M2*k1
    yr = dot("km,...amn->...kan", C1, Br) - dot("km,...amn->...kan", S1, Bi)
    yi = dot("km,...amn->...kan", S1, Br) + dot("km,...amn->...kan", C1, Bi)
    return (yr.reshape(shp + (M, Nh)), yi.reshape(shp + (M, Nh)))


def _transform_hopmajor(yr, yi, M: int, bf16: bool, split: int):
    """u[n, m] = sum_k y[n, k] E+[k, m] on hop-major (..., Nh, M) planes
    (the synthesis-side dual of _transform_chmajor; E+ is symmetric so
    the same Cooley-Tukey factors apply with k and m roles swapped).
    split=0: dense (M, M) matmul pair; split=M2: two-stage (M*(M1+M2)
    MACs instead of M^2 — 8x fewer at M=1024)."""
    if bf16:
        def dot(expr, A, b):
            return jnp.einsum(expr, A.astype(jnp.bfloat16),
                              b.astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32)
    else:
        dot = jnp.einsum
    if not split:
        C, S = (jnp.asarray(a) for a in _dft_mats(M))
        ur = dot("...nk,km->...nm", yr, C) - dot("...nk,km->...nm", yi, S)
        ui = dot("...nk,km->...nm", yr, S) + dot("...nk,km->...nm", yi, C)
        return ur, ui
    M2 = split
    M1 = M // M2
    C2, S2, C1, S1, twc, tws = (jnp.asarray(a)
                                for a in _dft_split_mats(M, M2))
    shp = yr.shape[:-1]
    # k = k2 + M2*k1 -> reshape to [k1 major, k2 minor]
    y2r = yr.reshape(shp + (M1, M2))
    y2i = yi.reshape(shp + (M1, M2))
    # stage 1: contract k1 with E1+[k1, m1] -> A[..., k2, m1]
    Ar = dot("ka,...kc->...ca", C1, y2r) - dot("ka,...kc->...ca", S1, y2i)
    Ai = dot("ka,...kc->...ca", S1, y2r) + dot("ka,...kc->...ca", C1, y2i)
    # twiddle tw[k2, m1] (elementwise)
    Br = twc * Ar - tws * Ai
    Bi = tws * Ar + twc * Ai
    # stage 2: contract k2 with E2+[k2, m2] -> U[..., m2, m1];
    # m = m1 + M1*m2 flattens with m2 major
    ur = dot("km,...kq->...mq", C2, Br) - dot("km,...kq->...mq", S2, Bi)
    ui = dot("km,...kq->...mq", S2, Br) + dot("km,...kq->...mq", C2, Bi)
    return ur.reshape(shp + (M,)), ui.reshape(shp + (M,))


def _hop_sign(M: int, Nh: int, hop0_parity):
    """(Nh, M) matrix of (-1)^{k n}.  hop0_parity may be a traced int32
    scalar (inside shard_map the absolute hop index depends on the shard
    position)."""
    k_odd = jnp.asarray((np.arange(M) % 2).astype(np.float32))
    n_odd = ((jnp.arange(Nh) + hop0_parity) % 2).astype(jnp.float32)
    return 1.0 - 2.0 * jnp.outer(n_odd, k_odd)


@dataclasses.dataclass
class AnalyzerState:
    history: jax.Array   # (..., L-P, 2) last input samples
    hop_idx: int = 0


@dataclasses.dataclass
class SynthesizerState:
    carry: jax.Array     # (..., L-P, 2) overlap-add tail
    hop_idx: int = 0


def analyzer_init(spec: ChannelizerSpec, batch: Tuple[int, ...] = (),
                  planar_in: bool = False):
    L, P = spec.ntaps, spec.hop
    shape = batch + ((2, L - P) if planar_in else (L - P, 2))
    return AnalyzerState(jnp.zeros(shape, jnp.float32), 0)


def synthesizer_init(spec: ChannelizerSpec, batch: Tuple[int, ...] = ()):
    L, P = spec.ntaps, spec.hop
    return SynthesizerState(jnp.zeros(batch + (L - P, 2), jnp.float32), 0)


@functools.partial(jax.jit,
                   static_argnames=("M", "T", "bf16", "split", "fold",
                                    "planar", "planar_in"))
def _analyze_block_chmajor(x_ext, h, M: int, T: int, hop0_parity=0,
                           bf16: bool = False, split: int = 0,
                           fold: str = "conv", planar: bool = False,
                           planar_in: bool = False):
    """x_ext: (..., L-P+N, 2) riq with history prepended (N = Nh*P),
    or (..., 2, L-P+N) planar planes when ``planar_in`` (bank fold only
    — skips the on-device (N, 2) -> (2, N) deinterleave transpose).
    Returns Y (..., M, Nh, 2) CHANNEL-major — the layout the per-channel
    demod/correlator stages consume with zero transposes.

    bf16=True runs the channel-transform matmuls with bfloat16 inputs
    (f32 accumulation) — 53 dB output SNR against float64 at M=1024,
    plenty for FM demod; keep f32 (default) for bit-parity test paths.
    f32 runs at default matmul precision, which is TF32 on an H100's
    tensor cores (72 dB at M=1024; chip_smoke.py measures both).
    split=M2 (>0) uses the two-stage Cooley-Tukey transform (see
    _dft_split_mats); fold="shift" computes the polyphase fold as T
    unrolled shifted multiply-adds (pure elementwise, no grouped
    conv) — same numerics up to f32 summation order.
    planar=True returns (..., 2, M, Nh) — I/Q as separate planes
    instead of a (..., 2)-minor axis, which would make every
    elementwise op work on rows of two; downstream per-channel stages
    (demod, correlation) should consume planes."""
    L = M * T
    P = M // 2
    n_ext = x_ext.shape[-1 if planar_in else -2]
    Nh = (n_ext - (L - P)) // P
    # Polyphase fold as DEPTHWISE convs over hop blocks.  The hop-n
    # window covers samples nP + m', m' = tM + q_w (t < T, q_w < M), and
    # in P-sized block coordinates sample nP + tM + q_w lives in block
    # n + 2t (+1 if q_w >= P) at phase p = q_w mod P.  So the fold
    #   folded[n, q_w] = sum_t h[L-1-(tM+q_w)] x[nP + tM + q_w]
    # splits into two dilation-2 depthwise convs over the block axis
    # (even/odd block parity), P channels each, kernel length T — with
    # NO (Nh, L) window materialization (2T x less HBM traffic).
    nblk = n_ext // P                                            # Nh + 2T - 1
    assert not planar_in or fold in ("bank", "bank2", "bankp"), \
        "planar_in needs a bank fold"
    batch = x_ext.shape[:-2]
    coef = jnp.asarray(h)[::-1].reshape(T, M)                    # coef[t, q_w]
    k_even = coef[:, :P]                                         # q_w <  P
    k_odd = coef[:, P:]                                          # q_w >= P
    if fold == "bank2":
        # Single-matmul variant of "bank": fold straight into one
        # (..., Nh, 4P) operand [or | oi | er | ei] (the concatenate
        # fuses into the fold's multiply-add producers) and apply the
        # fused (2M, 4P) transform+derotation matrix once — the operand
        # is read ONCE by the matmul instead of four (Nh, P) planes twice
        # each, and out IS the planar (2, M, Nh) result up to a reshape.
        fold_t = jnp.bfloat16 if bf16 else jnp.float32
        if planar_in:
            xpl = x_ext[..., : nblk * P]                         # (..., 2, n)
        else:
            xpl = jnp.swapaxes(x_ext[..., : nblk * P, :], -1, -2)
        bl = xpl.reshape(batch + (2, nblk, P)).astype(jnp.float32)
        acc_e = k_even[0] * bl[..., 0:Nh, :]
        acc_o = k_odd[0] * bl[..., 1:1 + Nh, :]
        for t in range(1, T):
            acc_e = acc_e + k_even[t] * bl[..., 2 * t: 2 * t + Nh, :]
            acc_o = acc_o + k_odd[t] * bl[..., 2 * t + 1: 2 * t + 1 + Nh, :]
        vcat = jnp.concatenate(
            [acc_o[..., 0, :, :], acc_o[..., 1, :, :],
             acc_e[..., 0, :, :], acc_e[..., 1, :, :]],
            axis=-1).astype(fold_t)                              # (..., Nh, 4P)
        A = jnp.asarray(_dft_mats_folded_fused(M)).astype(vcat.dtype)
        out = jnp.einsum("kq,...nq->...kn", A, vcat,
                         preferred_element_type=jnp.float32)     # (..., 2M, Nh)
        y2 = out.reshape(batch + (2, M, Nh))
        sgn = jnp.swapaxes(_hop_sign(M, Nh, hop0_parity), -1, -2)
        y2 = y2 * sgn
        if planar:
            return y2
        return jnp.stack([y2[..., 0, :, :], y2[..., 1, :, :]], axis=-1)
    if fold == "bankp":
        # PAIRED variant of "bank": four einsums with (2M, P) column
        # blocks of the fused transform+derotation matrix — each folded
        # bank is read ONCE by the matmul (the plain bank path reads every
        # bank twice, once per cos/sin matrix: the dominant analyze
        # traffic), with NO data concatenation (bank2's loss was the
        # materialized (Nh, 4P) operand copy; here only the CONSTANT
        # matrices stack).  FLOPs identical; derotation rides the
        # matrix rows for free.  Numerics differ from "bank" only in
        # f32 rounding order (derotation folded before vs after the
        # contraction).
        fold_t = jnp.bfloat16 if bf16 else jnp.float32
        if planar_in:
            xpl = x_ext[..., : nblk * P]                         # (..., 2, n)
        else:
            xpl = jnp.swapaxes(x_ext[..., : nblk * P, :], -1, -2)
        bl = xpl.reshape(batch + (2, nblk, P)).astype(jnp.float32)
        acc_e = k_even[0] * bl[..., 0:Nh, :]
        acc_o = k_odd[0] * bl[..., 1:1 + Nh, :]
        for t in range(1, T):
            acc_e = acc_e + k_even[t] * bl[..., 2 * t: 2 * t + Nh, :]
            acc_o = acc_o + k_odd[t] * bl[..., 2 * t + 1: 2 * t + 1 + Nh, :]
        acc_e = acc_e.astype(fold_t)
        acc_o = acc_o.astype(fold_t)
        or_, oi = acc_o[..., 0, :, :], acc_o[..., 1, :, :]
        er, ei = acc_e[..., 0, :, :], acc_e[..., 1, :, :]
        A = _dft_mats_folded_fused(M)                            # (2M, 4P)

        def dotp(cols, v):
            Ab = jnp.asarray(cols).astype(v.dtype)
            return jnp.einsum("kq,...nq->...kn", Ab, v,
                              preferred_element_type=jnp.float32)

        y2 = (dotp(A[:, 0 * P:1 * P], or_)
              + dotp(A[:, 1 * P:2 * P], oi)
              + dotp(A[:, 2 * P:3 * P], er)
              + dotp(A[:, 3 * P:4 * P], ei))                     # (..., 2M, Nh)
        y2 = y2.reshape(batch + (2, M, Nh))
        sgn = jnp.swapaxes(_hop_sign(M, Nh, hop0_parity), -1, -2)
        y2 = y2 * sgn
        if planar:
            return y2
        return jnp.stack([y2[..., 0, :, :], y2[..., 1, :, :]], axis=-1)
    if not planar_in:
        blocks = x_ext[..., : nblk * P, :].reshape(
            x_ext.shape[:-2] + (nblk, P, 2))
    if fold == "bank":
        # Fully planar path: deinterleave once, fold both banks as
        # shifted multiply-adds on (2, nblk, P) planes, and apply the
        # permutation-absorbed transform matrices straight to the banks
        # (no flip/concat/transpose between fold and matmul).
        # bf16: fold COMPUTE stays f32 (the shifted multiply-adds fuse
        # into one elementwise pass over the f32 input), but the folded
        # banks — matmul operands that must materialize in device memory
        # (2x (2, Nh, P) planes, the analyze stage's dominant traffic) —
        # are written in bfloat16, halving the bytes the transform
        # matmuls re-read.  (Folding IN bf16 would add an input-cast
        # pass.)
        fold_t = jnp.bfloat16 if bf16 else jnp.float32
        if planar_in:
            xpl = x_ext[..., : nblk * P]                         # (..., 2, n)
        else:
            xpl = jnp.swapaxes(x_ext[..., : nblk * P, :], -1, -2)
        bl = xpl.reshape(batch + (2, nblk, P)).astype(jnp.float32)
        ke = k_even                                              # (T, P)
        ko = k_odd
        acc_e = ke[0] * bl[..., 0:Nh, :]
        acc_o = ko[0] * bl[..., 1:1 + Nh, :]
        for t in range(1, T):
            acc_e = acc_e + ke[t] * bl[..., 2 * t: 2 * t + Nh, :]
            acc_o = acc_o + ko[t] * bl[..., 2 * t + 1: 2 * t + 1 + Nh, :]
        acc_e = acc_e.astype(fold_t)
        acc_o = acc_o.astype(fold_t)
        # acc_* : (..., 2, Nh, P); fe[n, q] = acc_e[n, q] etc.
        er, ei = acc_e[..., 0, :, :], acc_e[..., 1, :, :]
        or_, oi = acc_o[..., 0, :, :], acc_o[..., 1, :, :]
        Co, So, Ce, Se = (jnp.asarray(a) for a in _dft_mats_folded(M))
        if bf16:
            def dot(A, v):
                return jnp.einsum("kq,...nq->...kn",
                                  A.astype(jnp.bfloat16),
                                  v.astype(jnp.bfloat16),
                                  preferred_element_type=jnp.float32)
        else:
            def dot(A, v):
                return jnp.einsum("kq,...nq->...kn", A, v)
        yr = dot(Co, or_) - dot(So, oi) + dot(Ce, er) - dot(Se, ei)
        yi = dot(So, or_) + dot(Co, oi) + dot(Se, er) + dot(Ce, ei)
        ang = 2.0 * np.pi * np.arange(M) / M
        rc = jnp.asarray(np.cos(ang), jnp.float32)[:, None]
        rs = jnp.asarray(np.sin(ang), jnp.float32)[:, None]
        yr2 = yr * rc - yi * rs
        yi2 = yr * rs + yi * rc
        sgn = jnp.swapaxes(_hop_sign(M, Nh, hop0_parity), -1, -2)
        if planar:
            return jnp.stack([yr2 * sgn, yi2 * sgn], axis=-3)
        return jnp.stack([yr2 * sgn, yi2 * sgn], axis=-1)
    if fold == "shift":
        # T unrolled shifted multiply-adds over the (nblk, P, 2) block
        # view — one fused elementwise loop, no grouped conv, no input
        # transpose
        bl32 = blocks.astype(jnp.float32)
        ke = k_even[:, :, None]                                  # (T, P, 1)
        ko = k_odd[:, :, None]
        acc_e = ke[0] * bl32[..., 0:Nh, :, :]
        acc_o = ko[0] * bl32[..., 1:1 + Nh, :, :]
        for t in range(1, T):
            acc_e = acc_e + ke[t] * bl32[..., 2 * t: 2 * t + Nh, :, :]
            acc_o = acc_o + ko[t] * bl32[..., 2 * t + 1: 2 * t + 1 + Nh, :, :]
        fe = jnp.swapaxes(acc_e, -3, -2)                         # (..., P, Nh, 2)
        fo = jnp.swapaxes(acc_o, -3, -2)
    else:
        # (N, C, W) = (batch*2, P, nblk): phases to channels, iq to batch
        xin = jnp.moveaxis(blocks, -1, -3)                       # (..., 2, nblk, P)
        xin = jnp.swapaxes(xin, -1, -2)                          # (..., 2, P, nblk)
        flat = xin.reshape((-1, P, nblk)).astype(jnp.float32)

        def dconv(x_in, kern_tp):
            rhs = kern_tp.T[:, None, :].astype(jnp.float32)      # (P, 1, T)
            return lax.conv_general_dilated(
                x_in, rhs, window_strides=(1,), padding=[(0, 0)],
                rhs_dilation=(2,), feature_group_count=P,
                dimension_numbers=("NCH", "OIH", "NCH"))

        out_e = dconv(flat, k_even)[..., :Nh]                    # (N, P, Nh)
        out_o = dconv(flat[..., 1:], k_odd)[..., :Nh]

        def to_pnc(a):  # channel-major: (..., P, Nh, 2)
            a = a.reshape(batch + (2, P, Nh))
            return jnp.moveaxis(a, -3, -1)

        fe, fo = to_pnc(out_e), to_pnc(out_o)
    # v[r] = folded[M-1-r]: r < P comes from the odd bank (flipped),
    # r >= P from the even bank (flipped)
    v = jnp.concatenate([fo[..., ::-1, :, :], fe[..., ::-1, :, :]], axis=-3)
    vr, vi = v[..., 0], v[..., 1]                                # (..., M, Nh)
    # y[k, n] = sum_r E+[k,r] v[r, n] — contract on the channel axis so
    # the result stays channel-major (no transposes before the
    # per-channel demod/correlator stages)
    yr, yi = _transform_chmajor(vr, vi, M, bf16, split)
    # constant derotation e^{+j 2π k / M}: the hop-n window is evaluated at
    # absolute time nP+L-1, and e^{-j2πk(L-1)/M} = e^{+j2πk/M} for L ≡ 0 (M)
    ang = 2.0 * np.pi * np.arange(M) / M
    rc = jnp.asarray(np.cos(ang), jnp.float32)[:, None]
    rs = jnp.asarray(np.sin(ang), jnp.float32)[:, None]
    yr2 = yr * rc - yi * rs
    yi2 = yr * rs + yi * rc
    sgn = jnp.swapaxes(_hop_sign(M, Nh, hop0_parity), -1, -2)    # (M, Nh)
    if planar:
        return jnp.stack([yr2 * sgn, yi2 * sgn], axis=-3)        # (..., 2, M, Nh)
    return jnp.stack([yr2 * sgn, yi2 * sgn], axis=-1)            # (..., M, Nh, 2)


@functools.partial(jax.jit, static_argnames=("M", "T", "bf16", "split",
                                             "fold"))
def _analyze_block(x_ext, h, M: int, T: int, hop0_parity=0,
                   bf16: bool = False, split: int = 0, fold: str = "conv"):
    """Hop-major variant: Y (..., Nh, M, 2) (synthesis-compatible)."""
    y = _analyze_block_chmajor(x_ext, h, M, T, hop0_parity, bf16, split,
                               fold)
    return jnp.swapaxes(y, -3, -2)


@functools.partial(jax.jit, static_argnames=("M", "T", "bf16", "split"))
def _synthesize_block(Y, g, M: int, T: int, hop0_parity, carry,
                      bf16: bool = False, split: int = 0):
    """Y: (..., Nh, M, 2) channel basebands -> (..., Nh*P, 2) wideband +
    new overlap-add carry (..., L-P, 2).

    Overlap-add in P-sample block coordinates: output block b sample p
    receives sum_j g[jP+p] * u_{b-j}[(j&1)P + p] — the exact dual of
    the analysis fold, as 2T shifted multiply-adds on (Nh, P) PLANES.
    (The earlier form materialized an (Nh, T, M, 2) tensor — T x the
    output size — and summed 2T full-length padded copies.)
    bf16/split: channel-transform options (see _transform_hopmajor).
    """
    L = M * T
    P = M // 2
    Nh = Y.shape[-3]
    sgn = _hop_sign(M, Nh, hop0_parity)
    yr = Y[..., 0] * sgn
    yi = Y[..., 1] * sgn
    ur, ui = _transform_hopmajor(yr, yi, M, bf16, split)         # (..., Nh, M)
    gm = jnp.asarray(g).reshape(T, M) * jnp.float32(P)           # gain P -> unit roundtrip
    LP = L // P  # frames overlap factor (2T)
    batch = Y.shape[:-3]
    nb_out = Nh + LP - 1
    total = nb_out * P                                           # Nh*P + L - P

    def overlap_add(uplane):
        # uplane: (..., Nh, M); halves A = [:P], B = [P:].
        # out[b] = sum_j g_j * u[b - j, half_j]: pad u ONCE by LP-1
        # blocks on both ends and accumulate LP shifted SLICES — the
        # slices are views XLA fuses into one multiply-add loop, where
        # the earlier per-term jnp.pad forms materialized LP full-size
        # (nb_out, P) arrays (the TX synth stage's dominant cost).
        pad = [(0, 0)] * len(batch) + [(LP - 1, LP - 1), (0, 0)]
        upad = jnp.pad(uplane, pad)                      # (..., Nh+2LP-2, M)
        out = None
        for j in range(LP):
            gj = gm[j // 2, (j & 1) * P: (j & 1) * P + P]
            half = upad[..., LP - 1 - j: LP - 1 - j + nb_out,
                        (j & 1) * P: (j & 1) * P + P]    # (..., nb_out, P)
            term = gj * half
            out = term if out is None else out + term
        return out.reshape(batch + (total,))

    outr = overlap_add(ur)
    outi = overlap_add(ui)
    out = jnp.stack([outr, outi], axis=-1)                       # (..., total, 2)
    out = out.at[..., : L - P, :].add(carry)
    return out[..., : Nh * P, :], out[..., Nh * P:, :]


def analyze(x, spec: ChannelizerSpec, state: AnalyzerState,
            chmajor: bool = False, bf16: bool = False,
            split: int = -1, fold: str = "conv", planar: bool = False,
            planar_in: bool = False):
    """Streaming analysis: x (..., N, 2), N a multiple of spec.hop —
    or planar planes (..., 2, N) when ``planar_in`` (bank fold only;
    state from analyzer_init(..., planar_in=True)).
    Returns (Y, new state); Y is (..., N/P, M, 2) hop-major,
    (..., M, N/P, 2) channel-major when ``chmajor``, or
    (..., 2, M, N/P) planar channel-major when also ``planar``.
    split=-1 auto-selects the two-stage transform for large M (see
    default_split); pass 0 to force the dense matmul."""
    P = spec.hop
    n = x.shape[-1] if planar_in else x.shape[-2]
    assert n % P == 0, f"block length {n} not a multiple of hop {P}"
    assert chmajor or not planar, "planar output requires chmajor"
    if split < 0:
        split = default_split(spec.num_channels)
    cat_axis = -1 if planar_in else -2
    x_ext = jnp.concatenate([state.history, jnp.asarray(x, jnp.float32)],
                            axis=cat_axis)
    if chmajor:
        Y = _analyze_block_chmajor(
            x_ext, prototype_taps(spec.num_channels, spec.taps_per_phase),
            spec.num_channels, spec.taps_per_phase,
            jnp.int32(state.hop_idx % 2), bf16, split, fold, planar,
            planar_in)
    else:
        assert not planar_in
        Y = _analyze_block(
            x_ext, prototype_taps(spec.num_channels, spec.taps_per_phase),
            spec.num_channels, spec.taps_per_phase,
            jnp.int32(state.hop_idx % 2), bf16, split, fold)
    if planar_in:
        new_hist = x_ext[..., -(spec.ntaps - P):]
    else:
        new_hist = x_ext[..., -(spec.ntaps - P):, :]
    return Y, AnalyzerState(new_hist, state.hop_idx + n // P)


def synthesize(Y, spec: ChannelizerSpec, state: SynthesizerState,
               bf16: bool = False, split: int = -1):
    """Streaming synthesis: Y (..., Nh, M, 2) -> (x (..., Nh*P, 2), state).
    split=-1 auto-selects the two-stage transform for large M (see
    default_split); pass 0 to force the dense matmul."""
    Nh = Y.shape[-3]
    if split < 0:
        split = default_split(spec.num_channels)
    x, carry = _synthesize_block(
        jnp.asarray(Y, jnp.float32),
        prototype_taps(spec.num_channels, spec.taps_per_phase),
        spec.num_channels, spec.taps_per_phase,
        jnp.int32(state.hop_idx % 2), state.carry, bf16, split)
    return x, SynthesizerState(carry, state.hop_idx + Nh)


def channel_index(offset_channels: int, M: int) -> int:
    """Signed channel offset (e.g. -3..+3 around the band center) to the
    k index used by the bank."""
    return offset_channels % M
