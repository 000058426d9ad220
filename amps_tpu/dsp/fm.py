"""FM/FSK primitives on the real-pair (riq) IQ representation.

* ``fm_modulate_symbols``: the reference's char_to_float ->
  frequency_modulator_fc chain (sensitivity 2π·max_deviation/symrate,
  grc/ampsbs.grc:613) as one fused op.  For ±1 integer symbol streams the
  phase accumulator is an exact int32 cumsum scaled once — Manchester data
  is DC-balanced per bit, so the integer accumulator stays tiny and there
  is no float drift even over unbounded streams.
* ``fm_modulate``: float-input variant (voice/NBFM) with carried phase.
* ``quadrature_demod``: GR quadrature_demod_cf — gain * arg(x·conj(x[-1])).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from amps_tpu.dsp import iq as riq


def fast_atan2(y, x):
    """Polynomial atan2, |error| < 1e-4 rad.

    GR's quadrature_demod uses gr::fast_atan2f (a table/poly
    approximation), so an approximated arg() is MORE reference-faithful
    than the exact transcendental — and cheaper.  Octant reduction +
    odd minimax polynomial in z on
    [0, 1], one divide total.
    """
    y = jnp.asarray(y, jnp.float32)
    x = jnp.asarray(x, jnp.float32)
    ax = jnp.abs(x)
    ay = jnp.abs(y)
    hi = jnp.maximum(ax, ay)
    lo = jnp.minimum(ax, ay)
    z = lo / jnp.maximum(hi, 1e-30)
    z2 = z * z
    # minimax atan(z) on [0,1] (Estrin; ~1e-5 max error)
    a = jnp.float32(0.999866)
    b = jnp.float32(-0.3302995)
    c = jnp.float32(0.180141)
    d = jnp.float32(-0.085133)
    base = z * (a + z2 * (b + z2 * (c + z2 * d)))
    base = jnp.where(ay > ax, jnp.float32(np.pi / 2) - base, base)
    base = jnp.where(x < 0, jnp.float32(np.pi) - base, base)
    return jnp.where(y < 0, -base, base)


def fm_modulate_symbols(symbols, sensitivity: float, phase_accum0=0):
    """FSK-modulate an integer symbol stream.

    symbols: (..., n) int8/int32 (±1); phase[n] = sens * cumsum(symbols).
    Returns (iq riq (..., n, 2), accum_end (...,) int32) so streaming
    callers carry the accumulator across blocks exactly.

    Matches gr frequency_modulator_fc, which accumulates THEN emits
    exp(j*phase) of the post-increment value.
    """
    s = jnp.asarray(symbols)
    carry = jnp.asarray(phase_accum0, jnp.int32)[..., None]
    accum = jnp.cumsum(s.astype(jnp.int32), axis=-1) + carry
    phase = accum.astype(jnp.float32) * jnp.float32(sensitivity)
    return riq.expj(phase), accum[..., -1]


def fsk_manchester_baseband(bits, sps: int, sensitivity: float,
                            phase_accum0=0):
    """FSK baseband of a Manchester-coded bit stream as a 2-template map.

    Manchester bits are DC-balanced: each bit's 2*sps ±1 samples sum to
    zero, so the integer phase accumulator of fm_modulate_symbols returns
    to its start after EVERY bit.  The modulated waveform of a bit is
    therefore one of exactly two fixed (2*sps, 2) IQ templates — the whole
    char_to_float -> frequency_modulator_fc chain collapses to a select +
    broadcast (one write pass over the output; no cumsum, no sin/cos).
    Bit-exact vs fm_modulate_symbols(manchester_encode_symbols(bits)):
    the templates are evaluated with the same f32 phase and expj ops.

    bits: (..., n) 0/1.  Returns (iq riq (..., n*2*sps, 2), accum_end
    (unchanged phase_accum0, kept for interface parity with
    fm_modulate_symbols)).
    """
    bits = jnp.asarray(bits)
    # per-bit cumsum ramps: bit 0 encodes to (+1 x sps, -1 x sps), bit 1
    # to the negation (codec.manchester.manchester_encode_symbols)
    half = np.concatenate([np.arange(1, sps + 1),
                           np.arange(sps - 1, -1, -1)])  # 1..sps..0
    ramp = np.stack([half, -half]).astype(np.int32)      # (2, 2*sps)
    accum = jnp.asarray(ramp) + jnp.asarray(phase_accum0, jnp.int32)
    table = riq.expj(accum.astype(jnp.float32)
                     * jnp.float32(sensitivity))         # (2, 2*sps, 2)
    sel = bits[..., None, None] != 0
    out = jnp.where(sel, table[1], table[0])             # (..., n, 2*sps, 2)
    out = out.reshape(bits.shape[:-1] + (-1, 2))
    accum_end = jnp.broadcast_to(jnp.asarray(phase_accum0, jnp.int32),
                                 bits.shape[:-1])
    return out, accum_end


def fm_modulate(x, sensitivity: float, phase0=0.0):
    """FM-modulate a float signal; returns (iq riq, final unwrapped phase).

    Callers streaming long signals should wrap phase0 mod 2π between
    blocks to bound float32 error.
    """
    x = jnp.asarray(x, jnp.float32)
    phase = jnp.cumsum(x, axis=-1) * jnp.float32(sensitivity) + phase0
    return riq.expj(phase), phase[..., -1]


def quadrature_demod_planar(xr, xi, gain: float = 1.0, prev=None,
                            return_power: bool = False):
    """quadrature_demod on planar I/Q planes (a (..., 2)-minor axis
    would make every elementwise op work on rows of two).

    xr, xi: (..., n) float32 planes.  ``prev``: (pr, pi) arrays of
    shape (...,) — the previous block's last sample — or None.
    Returns (demod (..., n), (last_r, last_i)); with ``return_power``
    also a (...,) mean band power per stream, estimated from the SAME
    conjugate product the discriminator computes: |x[n]·conj(x[n-1])| is
    |x[n]||x[n-1]| = the instantaneous power of a constant-envelope (FM)
    signal, so sqrt(mean(re²+im²)) ≈ mean |x|² with zero extra HBM reads
    (a separate mean(xr²+xi²) pass over 1024-channel planes measured
    ~0.5 ms — a full re-read of the analysis output)."""
    xr = jnp.asarray(xr, jnp.float32)
    xi = jnp.asarray(xi, jnp.float32)
    if prev is None:
        pr = jnp.zeros_like(xr[..., :1])
        pi = jnp.zeros_like(xi[..., :1])
    else:
        pr = jnp.asarray(prev[0], jnp.float32)[..., None]
        pi = jnp.asarray(prev[1], jnp.float32)[..., None]
    sr = jnp.concatenate([pr, xr[..., :-1]], axis=-1)
    si = jnp.concatenate([pi, xi[..., :-1]], axis=-1)
    re = xr * sr + xi * si
    im = xi * sr - xr * si
    demod = fast_atan2(im, re) * jnp.float32(gain)
    if return_power == "series":
        # per-sample |x[n]|^2|x[n-1]|^2 series, aligned with demod —
        # callers reduce it per burst extent (correlator.burst_rssi)
        return demod, (xr[..., -1], xi[..., -1]), re * re + im * im
    if return_power:
        power = jnp.sqrt(jnp.mean(re * re + im * im, axis=-1))
        return demod, (xr[..., -1], xi[..., -1]), power
    return demod, (xr[..., -1], xi[..., -1])


def quadrature_demod(x, gain: float = 1.0, prev=None):
    """GR analog_quadrature_demod_cf: y[n] = gain*arg(x[n] conj(x[n-1])).

    x: riq (..., n, 2).  ``prev``: last sample of the previous block
    ((..., 2)) or None (GR zero-initializes history -> first output 0).
    Returns (demod (..., n) float32, last sample (..., 2)).
    """
    x = jnp.asarray(x)
    if prev is None:
        prev_s = jnp.zeros_like(x[..., :1, :])
    else:
        prev_s = jnp.asarray(prev)[..., None, :]
    shifted = jnp.concatenate([prev_s, x[..., :-1, :]], axis=-2)
    prod = riq.mul_conj(x, shifted)
    demod = fast_atan2(prod[..., 1], prod[..., 0]) * jnp.float32(gain)
    return demod, x[..., -1, :]
