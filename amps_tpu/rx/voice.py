"""Reverse-voice-channel (RVC) monitor: NBFM demod + deemphasis + SAT.

The reference's ampsbs_rvc.grc variant taps a reverse voice channel
(second freq_xlating_fir at -100 kHz -> NBFM RX -> re-broadcast,
SURVEY.md §2 'RVC monitor variant').  Here a channelizer slot's riq
baseband at 60 ksps demodulates to audio at 16 kHz (matching the
reference's audio rate) with the SAT tone measured and stripped.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from amps_tpu.config import PipelineConfig, SystemConfig
from amps_tpu.dsp.fm import quadrature_demod
from amps_tpu.dsp.windows import firdes_low_pass


def deemphasis(audio, fs: float, tau: float = 75e-6, state=0.0):
    """Single-pole FM deemphasis (inverse of tx.voice.preemphasis's
    shelf in the audio band): y[n] = a*x[n] + (1-a)*y[n-1]."""
    audio = jnp.asarray(audio, jnp.float32)
    a = jnp.float32(1.0 - np.exp(-1.0 / (fs * tau)))

    def scan_fn(y_prev, xn):
        y = a * xn + (1.0 - a) * y_prev
        return y, y

    yl, out = lax.scan(scan_fn, jnp.asarray(state, jnp.float32), audio)
    return out, yl


def nbfm_demod_audio(iq, system: Optional[SystemConfig] = None,
                     pipe: Optional[PipelineConfig] = None):
    """riq (n, 2) at chan_rate -> (audio (n*audio/chan,), sat_power dict).

    audio is deemphasized, lowpassed to 3 kHz and decimated to
    audio_rate; SAT measured before the audio lowpass.
    """
    system = system or SystemConfig()
    pipe = pipe or PipelineConfig()
    demod, _ = quadrature_demod(jnp.asarray(iq))
    sens = 2.0 * np.pi * pipe.deviation_hz / pipe.chan_rate
    demod = demod / jnp.float32(sens)        # normalize to modulating signal
    sat = sat_levels(demod, pipe.chan_rate)
    # audio LPF 3 kHz then decimate chan_rate -> audio_rate
    from math import gcd
    g = gcd(pipe.chan_rate, pipe.audio_rate)
    down = pipe.chan_rate // g               # 15
    up = pipe.audio_rate // g                # 4
    taps = firdes_low_pass(1.0, pipe.chan_rate * up, 3000.0, 1000.0,
                           "hamming")
    from amps_tpu.dsp.fir import polyphase_interpolate
    y, _ = polyphase_interpolate(demod, taps * up, up)
    audio = y[..., ::down]
    audio, _ = deemphasis(audio, pipe.audio_rate)
    return audio, sat


def sat_levels(demod, fs: float, block: Optional[int] = None):
    """Goertzel-style SAT detection: projection of the FM-demodulated
    signal onto the three SAT frequencies (5970/6000/6030 Hz).

    Returns dict scc -> amplitude estimate.  Implemented as two dot
    products per tone (cos/sin) — one fused matvec on device.
    """
    demod = jnp.asarray(demod, jnp.float32)
    n = demod.shape[-1]
    t = jnp.arange(n) / fs
    freqs = {0: 5970.0, 1: 6000.0, 2: 6030.0}
    out = {}
    for scc, f in freqs.items():
        c = jnp.cos(2.0 * np.pi * f * t)
        s = jnp.sin(2.0 * np.pi * f * t)
        re = jnp.sum(demod * c, axis=-1) * (2.0 / n)
        im = jnp.sum(demod * s, axis=-1) * (2.0 / n)
        out[scc] = jnp.sqrt(re * re + im * im)
    return out


def detect_scc(demod, fs: float):
    """Pick the SAT color code with the largest projection."""
    levels = sat_levels(demod, fs)
    arr = jnp.stack([levels[0], levels[1], levels[2]], axis=-1)
    return jnp.argmax(arr, axis=-1), arr


SUPERVISION_TONES_HZ = (5970.0, 6000.0, 6030.0, 10_000.0)
ST_INDEX = 3   # 10 kHz signaling tone (TIA/EIA-553 §2.7.1.2)
GUARD_INDEX = 4  # noise-reference column (mean of the guard bins)
# Noise-reference guard bins: empty spectrum away from voice (<= 3 kHz),
# SAT (~6 kHz) and ST (10 kHz).  A REAL signaling tone dominates them by
# orders of magnitude; dead-carrier discriminator noise is spectrally
# white, so its ST-bin level matches the guard bins — the per-frame
# dominance gate (control/supervision.py st_guard_ratio) kills the
# FM-click flash class the voice soak observed on the device.
GUARD_TONES_HZ = (8_200.0, 11_800.0)


@functools.cache
def _supervision_basis(frame_len: int, fs: float) -> np.ndarray:
    """(frame_len, 12) cos/sin basis for the 3 SAT tones + ST + 2 guard
    bins, scaled so the projection of a unit-amplitude tone is ~1."""
    t = np.arange(frame_len) / fs
    cols = []
    for f in SUPERVISION_TONES_HZ + GUARD_TONES_HZ:
        cols.append(np.cos(2.0 * np.pi * f * t))
        cols.append(np.sin(2.0 * np.pi * f * t))
    return (np.stack(cols, axis=1) * (2.0 / frame_len)).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("frame_len", "fs", "sat_agg"))
def supervision_levels(demod, frame_len: int, fs: float, sat_agg: int = 12):
    """Framed supervisory-tone measurement on FM-demod streams.

    demod: (..., n) discriminator output (NOT deviation-normalized);
    amplitudes are in the same units as the input tone amplitude.
    ST and band power use frames of ``frame_len`` samples (600 = 10 ms
    @ 60 ksps) — the time resolution the supervision state machine
    needs (ST flash is 400 ms, release 1.8 s — 553 §2.7.2).  The three
    SAT tones are only 30 Hz apart, far inside a 10 ms frame's 100 Hz
    bin, so SAT is measured over ``sat_agg`` consecutive frames
    (120 ms -> 8.3 Hz bins, 3.6-cycle separation) and edge-held back
    onto the fine frame grid.

    Returns (levels (..., F, 5) amplitudes of [SAT0, SAT1, SAT2, ST,
    GUARD] — GUARD is the mean amplitude of the two empty guard bins
    (GUARD_TONES_HZ), the per-frame noise reference the ST dominance
    gate compares against — and power (..., F) mean demod power per
    frame).  Two matmuls, batched over channels.
    """
    x = jnp.asarray(demod, jnp.float32)
    nf = x.shape[-1] // frame_len
    fr = x[..., : nf * frame_len].reshape(x.shape[:-1] + (nf, frame_len))
    proj = fr @ jnp.asarray(_supervision_basis(frame_len, float(fs)))
    cs = proj.reshape(proj.shape[:-1] + (6, 2))
    amps = jnp.sqrt(jnp.sum(cs * cs, axis=-1))          # (..., F, 6)
    guard = jnp.mean(amps[..., 4:6], axis=-1, keepdims=True)
    levels = jnp.concatenate([amps[..., :4], guard], axis=-1)
    power = jnp.mean(fr * fr, axis=-1)
    clen = frame_len * sat_agg
    nc = x.shape[-1] // clen
    if nc >= 1:
        cfr = x[..., : nc * clen].reshape(x.shape[:-1] + (nc, clen))
        cproj = cfr @ jnp.asarray(_supervision_basis(clen, float(fs)))
        ccs = cproj.reshape(cproj.shape[:-1] + (6, 2))
        sat_c = jnp.sqrt(jnp.sum(ccs * ccs, axis=-1))[..., :3]
        sat = jnp.repeat(sat_c, sat_agg, axis=-2)
        pad = nf - nc * sat_agg
        if pad > 0:
            sat = jnp.concatenate(
                [sat, jnp.repeat(sat[..., -1:, :], pad, axis=-2)], axis=-2)
        levels = jnp.concatenate([sat, levels[..., 3:]], axis=-1)
    return levels, power
