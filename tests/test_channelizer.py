"""Polyphase channelizer tests (small M so compiles stay cheap)."""

import numpy as np
import pytest

from amps_tpu.dsp import channelizer as ch

M, T = 8, 8
SPEC = ch.ChannelizerSpec(num_channels=M, taps_per_phase=T, spacing_hz=30e3)
P = SPEC.hop
FS = SPEC.fs  # 240 kHz


def _tone(freq_hz, n, fs=FS, amp=1.0, phase0=0.0):
    t = np.arange(n) / fs
    ph = 2 * np.pi * freq_hz * t + phase0
    return np.stack([amp * np.cos(ph), amp * np.sin(ph)], -1).astype(np.float32)


def _mag(y):
    return np.hypot(y[..., 0], y[..., 1])


def test_tone_lands_in_its_channel():
    n = 8192
    for k in (0, 1, 3, M - 2):  # M-2 == -2 (negative freq)
        f = (k if k <= M // 2 else k - M) * SPEC.spacing_hz
        x = _tone(f, n)
        Y, _ = ch.analyze(x, SPEC, ch.analyzer_init(SPEC))
        Y = np.asarray(Y)
        steady = Y[T * 4:]  # skip filter transient
        power = (_mag(steady) ** 2).mean(axis=0)
        assert power[k] > 0.9, (k, power)
        others = np.delete(power, k)
        assert others.max() < 2e-4, (k, power)


def test_channel_output_is_baseband_of_offset():
    """Tone 10 kHz above channel 2's center -> channel 2 carries a 10 kHz
    complex tone at the 60 ksps channel rate."""
    n = 8192
    k = 2
    off = 10e3
    x = _tone(k * SPEC.spacing_hz + off, n)
    Y, _ = ch.analyze(x, SPEC, ch.analyzer_init(SPEC))
    yk = np.asarray(Y)[T * 4:, k]
    phase = np.unwrap(np.arctan2(yk[:, 1], yk[:, 0]))
    slope = np.polyfit(np.arange(len(phase)), phase, 1)[0]
    freq = slope * SPEC.channel_rate / (2 * np.pi)
    assert abs(freq - off) < 200.0, freq


def test_streaming_matches_one_shot():
    rng = np.random.default_rng(0)
    n = 4096
    x = rng.normal(0, 1, (n, 2)).astype(np.float32)
    Y1, _ = ch.analyze(x, SPEC, ch.analyzer_init(SPEC))
    st = ch.analyzer_init(SPEC)
    Ya, st = ch.analyze(x[: n // 2], SPEC, st)
    Yb, st = ch.analyze(x[n // 2:], SPEC, st)
    Y2 = np.concatenate([np.asarray(Ya), np.asarray(Yb)])
    assert np.allclose(np.asarray(Y1), Y2, atol=1e-5)


def test_synthesis_places_tone_at_channel_freq():
    Nh = 1024
    k = 3
    Y = np.zeros((Nh, M, 2), np.float32)
    Y[:, k, 0] = 1.0  # DC in channel k
    x, _ = ch.synthesize(Y, SPEC, ch.synthesizer_init(SPEC))
    x = np.asarray(x)[SPEC.ntaps:]
    # instantaneous frequency of the wideband output
    ph = np.unwrap(np.arctan2(x[:, 1], x[:, 0]))
    slope = np.polyfit(np.arange(len(ph)), ph, 1)[0]
    freq = slope * FS / (2 * np.pi)
    assert abs(freq - k * SPEC.spacing_hz) < 300.0, freq
    # near-constant envelope
    env = _mag(x)
    assert env.std() / env.mean() < 0.02


def test_synth_analyze_roundtrip():
    """Per-channel signals survive synthesis -> wideband -> analysis."""
    rng = np.random.default_rng(1)
    Nh = 2048
    Y = np.zeros((Nh, M, 2), np.float32)
    # narrowband random baseband (lowpassed noise) in channels 1 and 5
    for k in (1, 5):
        w = rng.normal(0, 1, (Nh + 64, 2)).astype(np.float32)
        w = np.stack([np.convolve(w[:, 0], np.ones(32) / 32, "valid"),
                      np.convolve(w[:, 1], np.ones(32) / 32, "valid")], -1)
        Y[:, k] = w[:Nh]
    x, _ = ch.synthesize(Y, SPEC, ch.synthesizer_init(SPEC))
    Y2, _ = ch.analyze(np.asarray(x), SPEC, ch.analyzer_init(SPEC))
    Y2 = np.asarray(Y2)
    # bulk delay: analysis+synthesis prototype delays ~ (L-1)/2 each at fs,
    # i.e. ~2*T hops minus alignment; find best lag by correlation
    # complex correlation (a constant per-channel phase between synthesis
    # and analysis is expected; magnitude is what must survive)
    for k in (1, 5):
        a = Y[: Nh - 3 * T * 2, k, 0] + 1j * Y[: Nh - 3 * T * 2, k, 1]
        best = 0, 0.0
        for lag in range(0, 4 * T):
            bb = Y2[lag: lag + len(a), k]
            b = bb[:, 0] + 1j * bb[:, 1]
            c = np.abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))
            if c > best[1]:
                best = lag, c
        assert best[1] > 0.98, (k, best)
    # silent channels stay silent
    assert _mag(Y2[8 * T:, 0]).max() < 0.05
    assert _mag(Y2[8 * T:, 4]).max() < 0.05


def test_split_transform_matches_dense():
    """Two-stage Cooley-Tukey channel transform == dense matmul."""
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    M2 = 256
    spec = ch.ChannelizerSpec(num_channels=M2, taps_per_phase=4)
    n = M2 * 8
    x = rng.normal(0, 1, (n, 2)).astype(np.float32)
    xe = jnp.concatenate(
        [jnp.zeros((spec.ntaps - spec.hop, 2), jnp.float32),
         jnp.asarray(x)], axis=0)
    h = ch.prototype_taps(M2, 4)
    dense = np.asarray(ch._analyze_block_chmajor(xe, h, M2, 4, 0, False, 0))
    split = np.asarray(ch._analyze_block_chmajor(
        xe, h, M2, 4, 0, False, 128))
    scale = np.abs(dense).max()
    assert np.abs(dense - split).max() < 1e-4 * max(scale, 1.0)


def test_shift_fold_matches_conv_fold():
    """Unrolled shifted-multiply fold == grouped-conv fold."""
    import jax.numpy as jnp
    rng = np.random.default_rng(8)
    n = M * 64
    x = rng.normal(0, 1, (n, 2)).astype(np.float32)
    xe = jnp.concatenate(
        [jnp.zeros((SPEC.ntaps - P, 2), jnp.float32), jnp.asarray(x)],
        axis=0)
    h = ch.prototype_taps(M, T)
    conv = np.asarray(ch._analyze_block_chmajor(xe, h, M, T, 0, False, 0,
                                                "conv"))
    shift = np.asarray(ch._analyze_block_chmajor(xe, h, M, T, 0, False, 0,
                                                 "shift"))
    assert np.abs(conv - shift).max() < 1e-5 * max(np.abs(conv).max(), 1.0)


def test_auto_split_streaming_matches_dense():
    """analyze() with the auto split (dense at every M: it beat the
    two-stage split=128 on an H100) == the explicit two-stage split."""
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    spec = ch.ChannelizerSpec(num_channels=512, taps_per_phase=2)
    assert ch.default_split(512) == 0
    n = 512 * 4
    x = rng.normal(0, 1, (n, 2)).astype(np.float32)
    ya, _ = ch.analyze(x, spec, ch.analyzer_init(spec), chmajor=True,
                       split=128)
    yd, _ = ch.analyze(x, spec, ch.analyzer_init(spec), chmajor=True)
    ya, yd = np.asarray(ya), np.asarray(yd)
    assert np.abs(ya - yd).max() < 1e-4 * max(np.abs(yd).max(), 1.0)


def test_bank_fold_matches_conv_fold():
    """Permutation-absorbed two-bank transform == classic path."""
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    for Mt, Tt in ((8, 8), (16, 4)):
        spec = ch.ChannelizerSpec(Mt, Tt)
        n = Mt * 64
        x = rng.normal(0, 1, (n, 2)).astype(np.float32)
        xe = jnp.concatenate(
            [jnp.zeros((spec.ntaps - spec.hop, 2), jnp.float32),
             jnp.asarray(x)], axis=0)
        h = ch.prototype_taps(Mt, Tt)
        for par in (0, 1):
            conv = np.asarray(ch._analyze_block_chmajor(
                xe, h, Mt, Tt, par, False, 0, "conv", True))
            bank = np.asarray(ch._analyze_block_chmajor(
                xe, h, Mt, Tt, par, False, 0, "bank", True))
            assert bank.shape == conv.shape == (2, Mt, n // spec.hop)
            err = np.abs(conv - bank).max()
            assert err < 1e-5 * max(np.abs(conv).max(), 1.0), (Mt, err)


def test_bank2_fold_matches_conv_fold():
    """Single-matmul fused bank transform (derotation absorbed into the
    (2M, 4P) matrix) == classic path, planar and interleaved input."""
    import jax.numpy as jnp
    rng = np.random.default_rng(12)
    for Mt, Tt in ((8, 8), (16, 4)):
        spec = ch.ChannelizerSpec(Mt, Tt)
        n = Mt * 64
        x = rng.normal(0, 1, (n, 2)).astype(np.float32)
        xe = jnp.concatenate(
            [jnp.zeros((spec.ntaps - spec.hop, 2), jnp.float32),
             jnp.asarray(x)], axis=0)
        h = ch.prototype_taps(Mt, Tt)
        for par in (0, 1):
            conv = np.asarray(ch._analyze_block_chmajor(
                xe, h, Mt, Tt, par, False, 0, "conv", True))
            bank2 = np.asarray(ch._analyze_block_chmajor(
                xe, h, Mt, Tt, par, False, 0, "bank2", True))
            assert bank2.shape == conv.shape == (2, Mt, n // spec.hop)
            err = np.abs(conv - bank2).max()
            assert err < 1e-5 * max(np.abs(conv).max(), 1.0), (Mt, err)
            planar = np.asarray(ch._analyze_block_chmajor(
                jnp.asarray(np.asarray(xe).T.copy()), h, Mt, Tt, par,
                False, 0, "bank2", True, planar_in=True))
            assert np.array_equal(planar, bank2)


def test_bankp_fold_matches_conv_fold():
    """Paired bank transform (r4): four (2M, P) column-block einsums —
    each folded bank read ONCE, no data concatenation — must equal the
    classic path (derotation folded into the matrix changes only f32
    rounding order)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(12)
    for Mt, Tt in ((8, 8), (16, 4)):
        spec = ch.ChannelizerSpec(Mt, Tt)
        n = Mt * 64
        x = rng.normal(0, 1, (n, 2)).astype(np.float32)
        xe = jnp.concatenate(
            [jnp.zeros((spec.ntaps - spec.hop, 2), jnp.float32),
             jnp.asarray(x)], axis=0)
        h = ch.prototype_taps(Mt, Tt)
        for par in (0, 1):
            conv = np.asarray(ch._analyze_block_chmajor(
                xe, h, Mt, Tt, par, False, 0, "conv", True))
            bankp = np.asarray(ch._analyze_block_chmajor(
                xe, h, Mt, Tt, par, False, 0, "bankp", True))
            assert bankp.shape == conv.shape == (2, Mt, n // spec.hop)
            err = np.abs(conv - bankp).max()
            assert err < 1e-5 * max(np.abs(conv).max(), 1.0), (Mt, err)
            planar = np.asarray(ch._analyze_block_chmajor(
                jnp.asarray(np.asarray(xe).T.copy()), h, Mt, Tt, par,
                False, 0, "bankp", True, planar_in=True))
            assert np.array_equal(planar, bankp)


def test_filter_mask_production_geometry():
    """SURVEY §7 hard part (e): the analysis bank's per-channel filter
    mask, pinned NUMERICALLY at production geometry (M=1024, T=8) so a
    future taps/window change that degrades flatness or rejection fails
    here.

    Reference chain being replaced: freq_xlating_fir_filter_ccc with a
    Blackman LPF, 10 kHz cutoff / 4.5 kHz transition (grc/ampsbs.grc RX
    front end, SURVEY §3.5) — its passband is the AMPS signal band
    (+-10 kHz); adjacent channels sit at +-30 kHz.  The polyphase
    prototype (cutoff 15 kHz = half the channel spacing, Blackman-
    Harris) passes the same signal band and pushes the adjacent-channel
    CENTER and the 60 ksps alias fold >100 dB down; the observed ghost
    classes came from bf16 transform leakage (-34 dB), NOT this mask —
    the gates here keep it that way.
    """
    M, T = 1024, 8
    h = ch.prototype_taps(M, T).astype(np.float64)
    fs = M * 30e3
    NF = 1 << 20
    Hf = np.fft.rfft(h, NF)
    f = np.fft.rfftfreq(NF, 1 / fs)
    db = 20 * np.log10(np.maximum(np.abs(Hf) / np.abs(Hf[0]), 1e-15))

    def band(f0, f1):
        return db[(f >= f0) & (f <= f1)]

    # 1. passband ripple over the +-10 kHz signal band (measured:
    #    0 .. -1.03 dB monotone rolloff)
    pb = band(0.0, 10e3)
    assert pb.max() <= 0.1 and pb.min() >= -1.5, (pb.min(), pb.max())
    # 2. adjacent-channel CENTER rejection (+-30 kHz): the dominant
    #    energy of a neighboring FM burst (measured: -108.7 dB)
    assert db[int(round(30e3 / (fs / NF)))] <= -100.0
    # 3. adjacent-channel passband leakage: a neighbor's own +-10 kHz
    #    band spans 20-40 kHz offset; worst response there lands OUT of
    #    our signal band in the 60 ksps slot stream but must stay
    #    bounded (measured: -19.1 dB at the 20 kHz edge)
    assert band(20e3, 40e3).max() <= -18.0
    # 4. alias floor of the 2x-oversampled output: content beyond
    #    +-30 kHz folds at the 60 ksps channel rate; the sub-band that
    #    lands INSIDE the +-10 kHz signal band is 50-70 kHz (fold about
    #    60 kHz).  Measured: <= -110 dB
    assert band(30e3, fs / 2).max() <= -105.0          # any fold at all
    assert band(50e3, 70e3).max() <= -110.0            # in-signal-band
    # 5. DC normalization (unity channel gain)
    assert abs(db[0]) < 1e-6

    # -- empirical leg: the REAL bank at production geometry follows the
    # analytic mask (f32 arithmetic floor ~-90 dB on CPU; the bf16
    # transform is the separately-documented -34 dB regime,
    # docs/PARITY.md)
    spec = ch.ChannelizerSpec(num_channels=M, taps_per_phase=T,
                              spacing_hz=30e3)
    Nh = 64
    n = Nh * spec.hop + spec.ntaps
    CH = 100

    def chan_power_db(offset_hz):
        x = _tone(CH * 30e3 + offset_hz, n, fs=fs)
        Y, _ = ch.analyze(x, spec, ch.analyzer_init(spec))
        Y = np.asarray(Y)[2 * T:]           # skip the filter transient
        p = (_mag(Y) ** 2).mean(axis=0)
        return 10 * np.log10(np.maximum(p, 1e-30))

    p0 = chan_power_db(0.0)
    assert p0[CH] > -0.1, p0[CH]                       # unity at center
    assert p0[CH - 1] <= -90.0 and p0[CH + 1] <= -90.0  # adjacent center
    p10 = chan_power_db(10e3)                          # passband edge
    assert -1.5 <= p10[CH] - p0[CH] <= 0.05, p10[CH]
    p25 = chan_power_db(25e3)                          # mid-transition
    # (mean tone power in dB == 20log10|H|, i.e. the analytic db curve)
    ana25 = db[int(round(25e3 / (fs / NF)))]
    # 25 kHz sits 5 kHz inside CH+1's own passband too — check BOTH
    assert abs(p25[CH] - ana25) < 1.0, (p25[CH], ana25)
    ana5 = db[int(round(5e3 / (fs / NF)))]
    assert abs(p25[CH + 1] - ana5) < 0.5, (p25[CH + 1], ana5)


@pytest.mark.parametrize("fold", ["bank", "conv", "shift"])
def test_analysis_matches_float64_reference(fold):
    """The analysis bank against the float64 NumPy reference written
    from the bank's definition (ref/channelizer_ref.py): f32 on the CPU
    agrees to better than 120 dB SNR."""
    from amps_tpu.ref.channelizer_ref import analyze_ref
    M, T = 32, 8
    spec = ch.ChannelizerSpec(num_channels=M, taps_per_phase=T)
    x = np.random.default_rng(4).normal(0, 1, (M // 2 * 48, 2)) \
        .astype(np.float32)
    y, _ = ch.analyze(x, spec, ch.analyzer_init(spec), chmajor=True,
                      planar=True, fold=fold)
    y = np.asarray(y, np.float64)
    ref = analyze_ref(x, ch.prototype_taps(M, T), M)
    err = y[0] + 1j * y[1] - ref
    snr = 10 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(np.abs(err) ** 2))
    assert snr > 120, snr
