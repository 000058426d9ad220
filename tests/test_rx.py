"""RX chain tests: correlator timing recovery + burst decode, from clean
symbol streams up to the full FM loopback."""

import numpy as np

from amps_tpu import PipelineConfig
from amps_tpu.ref import frames_ref, words_ref
from amps_tpu.rx import correlator, decoder
from amps_tpu.rx.frontend import rx_frontend, rx_lpf_taps
from amps_tpu.tx import recc_ms
from amps_tpu.tx.modulator import fm_modulate, tx_interp_taps

PIPE = PipelineConfig()


def _burst_in_stream(words, sps, lead=500, tail=500, rng=None):
    """±1 symbol stream: idle dotting, burst, idle dotting."""
    syms = recc_ms.burst_symbols(words, dcc=0, sps=sps)
    idle = np.tile(np.array([1, -1], np.int8), lead // 2)
    tail_s = np.tile(np.array([1, -1], np.int8), tail // 2)
    return np.concatenate([idle, syms, tail_s]).astype(np.int8)


def test_ms_burst_matches_oracle():
    words = recc_ms.page_response_words("5551234567")
    got = recc_ms.burst_bits(words)
    want = frames_ref.recc_burst_bits(0, words)
    assert np.array_equal(got, want)


def test_find_bursts_on_clean_symbols():
    """Trigger found at the exact memmem position on a clean ±1 stream."""
    words = recc_ms.page_response_words("5551234567")
    sps = 1
    stream = _burst_in_stream(words, sps).astype(np.float32)
    starts, valid, q = correlator.find_bursts(stream, sps, max_bursts=2)
    starts, valid = np.asarray(starts), np.asarray(valid)
    assert valid[0]
    # capture must begin right after the trigger: idle(500) + dotting(8)
    # (30 dotting bits = 60 syms, trigger covers the last 52 + wsync 22)
    syms = recc_ms.burst_symbols(words, 0, sps)
    tmpl = correlator.trigger_template(sps)
    # locate trigger by construction: burst starts at 500; precursor is 82
    # symbols (41 bits); capture begins at 500 + 82
    assert starts[0] == 500 + 82
    assert not valid[1]  # only one burst present

    hard, soft = correlator.extract_burst_symbols(
        np.pad(stream, (0, correlator.CAPTURE_SYMBOLS * sps)), starts, sps)
    dec = decoder.decode_bursts(hard[0])
    assert np.asarray(dec.word_ok)[:2].all()
    worda = np.asarray(dec.words)[0]
    wa = words_ref.parse_recc_word_a(worda)
    assert wa["MIN1"] == words_ref.parse_min("5551234567")[0]
    assert np.asarray(dec.bad_symbols).sum() == 0


def test_two_bursts_in_one_block():
    words1 = recc_ms.page_response_words("5551234567")
    words2 = recc_ms.registration_words("2135551212", esn=0xDEADBEEF)
    sps = 1
    s1 = _burst_in_stream(words1, sps, lead=300, tail=100)
    s2 = _burst_in_stream(words2, sps, lead=200, tail=300)
    stream = np.concatenate([s1, s2]).astype(np.float32)
    starts, valid, q = correlator.find_bursts(stream, sps, max_bursts=4)
    starts, valid = np.asarray(starts), np.asarray(valid)
    assert valid.sum() == 2
    got = np.sort(starts[valid])
    assert got[0] == 300 + 82
    assert got[1] == len(s1) + 200 + 82


def test_full_fm_loopback_decodes_origination():
    """MS burst -> FSK @100k -> x4 interp -> RX front end -> correlator ->
    decoder: all three words recovered bit-exact (the BASELINE.json
    'RECC receiver' config, noiseless)."""
    words = recc_ms.origination_words("5551234567", "16505551234",
                                      esn=0x1234ABCD)
    stream = _burst_in_stream(words, PIPE.sps, lead=1000, tail=3000)
    iq, _ = fm_modulate(stream, PIPE)
    demod, _ = rx_frontend(np.asarray(iq), PIPE, center_freq=0.0)
    demod = np.asarray(demod)

    sps_rx = (PIPE.rx_rate // PIPE.rx_decim) // PIPE.baud  # 10
    starts, valid, q, hard, soft = correlator.find_and_extract(
        demod, sps_rx, max_bursts=2, threshold=0.5)
    valid = np.asarray(valid)
    assert valid[0]
    # double 10 kHz filtering leaves ISI on the word-sync edges; clean
    # signal scores ~0.74 on the min(full, wsync) quality metric
    assert float(np.asarray(q)[0]) > 0.65

    dec = decoder.decode_bursts(np.asarray(hard)[0])
    ok = np.asarray(dec.word_ok)
    assert ok[:5].all()          # A, B, C, called1, called2
    got = np.asarray(dec.words)
    for i, w in enumerate(words):
        assert np.array_equal(got[i], w), f"word {i} mismatch"
    # parse into fields and digits
    wa = words_ref.parse_recc_word_a(got[0])
    assert words_ref.calc_min(wa["MIN1"],
                              words_ref.parse_recc_word_b(got[1])["MIN2"]) \
        == "5551234567"
    d1 = words_ref.parse_recc_word_called(got[3])
    d2 = words_ref.parse_recc_word_called(got[4])
    dialed = words_ref.called_digits(d1["DIGITS"]) + \
        words_ref.called_digits(d2["DIGITS"])
    assert dialed == "16505551234"


def test_loopback_with_noise_and_majority(rng):
    """Moderate AWGN on the IQ: burst still found and decoded (first_ok
    and majority policies)."""
    words = recc_ms.page_response_words("2135551212")
    stream = _burst_in_stream(words, PIPE.sps, lead=800, tail=3000)
    iq, _ = fm_modulate(stream, PIPE)
    iq = np.asarray(iq)
    noise = rng.normal(0, 0.05, iq.shape).astype(np.float32)  # ~14 dB SNR
    demod, _ = rx_frontend(iq + noise, PIPE, center_freq=0.0)
    demod = np.asarray(demod)
    sps_rx = 10
    starts, valid, q, hard, soft = correlator.find_and_extract(
        demod, sps_rx, max_bursts=2, threshold=0.5)
    assert np.asarray(valid)[0]
    for policy in ("first_ok", "majority"):
        dec = decoder.decode_bursts(np.asarray(hard)[0], policy=policy)
        assert np.asarray(dec.word_ok)[:2].all(), policy
        got = np.asarray(dec.words)
        assert np.array_equal(got[0], words[0]), policy
        assert np.array_equal(got[1], words[1]), policy


def test_loopback_with_cfo(rng):
    """Carrier frequency offset at the AMPS mobile tolerance limit
    (+-2.5 ppm at 835 MHz ~ +-2.1 kHz) plus noise: the FM discriminator
    turns CFO into a DC bias (~26% of symbol amplitude at 2 kHz) that
    breaks slicing at 0; the per-burst DC estimate from the Manchester-
    balanced capture head (correlator.DC_EST_SYMBOLS) restores decode
    out to +-4 kHz (tools/cfo_sweep.out)."""
    words = recc_ms.page_response_words("2135551212")
    stream = _burst_in_stream(words, PIPE.sps, lead=800, tail=3000)
    iq, _ = fm_modulate(stream, PIPE)
    iq = np.asarray(iq)
    for cfo_hz in (2500.0, -2500.0):
        ph = 2 * np.pi * cfo_hz * np.arange(iq.shape[0]) / PIPE.tx_rate
        c, s = np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)
        rot = np.stack([iq[:, 0] * c - iq[:, 1] * s,
                        iq[:, 0] * s + iq[:, 1] * c], axis=-1)
        rot += rng.normal(0, 0.05, rot.shape).astype(np.float32)
        demod, _ = rx_frontend(rot, PIPE, center_freq=0.0)
        starts, valid, q, hard, soft = correlator.find_and_extract(
            np.asarray(demod), 10, max_bursts=2, threshold=0.5)
        assert np.asarray(valid)[0], cfo_hz
        dec = decoder.decode_bursts(np.asarray(hard)[0])
        assert np.asarray(dec.word_ok)[:2].all(), cfo_hz
        got = np.asarray(dec.words)
        assert np.array_equal(got[0], words[0]), cfo_hz
        assert np.array_equal(got[1], words[1]), cfo_hz


def test_decoder_repeat_fallback(rng):
    """Corrupt the first repeats badly: decoder falls back to a later
    repeat (lib/recc_decode_impl.cc:100-107 semantics)."""
    words = recc_ms.page_response_words("5551234567")
    syms = recc_ms.burst_symbols(words, 0, 1)
    hard = ((syms > 0)).astype(np.uint8)
    cap = hard[82:82 + correlator.CAPTURE_SYMBOLS]
    # word 0 occupies symbols 14..494 (5 repeats x 96 syms).  Corrupt
    # repeats 0-2 with bit patterns verified UNDECODABLE by the oracle
    # (random garbage aliases into a "correctable" syndrome ~49% of the
    # time — behavior the reference shares, so the test must avoid it).
    from amps_tpu.ref import bch_ref
    cap = cap.copy()
    for r in range(3):
        while True:
            trial = rng.integers(0, 2, 48).astype(np.uint8)
            if not bch_ref.recc_bch_decode(trial)[1]:
                break
        # write the 48 coded bits of repeat r as Manchester symbols
        sym = np.zeros(96, np.uint8)
        sym[0::2] = 1 - trial
        sym[1::2] = trial
        cap[14 + r * 96: 14 + (r + 1) * 96] = sym
    dec = decoder.decode_bursts(cap)
    assert bool(np.asarray(dec.word_ok)[0])
    assert int(np.asarray(dec.repeat_used)[0]) >= 3
    assert np.array_equal(np.asarray(dec.words)[0], words[0])


def test_toeplitz_correlation_matches_numpy_direct(rng):
    """The blocked-Toeplitz matmul correlator == direct correlation."""
    sps = 3
    x = rng.normal(0, 1.0, (3, 4000)).astype(np.float32)
    # plant a clean trigger in row 1 so a real peak exists
    tmpl = correlator.trigger_template(sps)
    x[1, 700:700 + len(tmpl)] = tmpl * 0.4
    starts, valid, quality = correlator.find_bursts(x, sps, 2, 0.55)
    L = len(tmpl)
    ws_off = 2 * 26 * sps
    for c in range(3):
        corr = np.correlate(x[c], tmpl, "valid")
        wcorr = np.correlate(x[c], tmpl[ws_off:], "valid")[ws_off:]
        en = np.convolve(x[c] ** 2, np.ones(L), "valid")
        wen = np.convolve(x[c] ** 2, np.ones(L - ws_off), "valid")[ws_off:]
        qf = corr / (np.sqrt(np.maximum(en, 1e-9)) * np.sqrt((tmpl**2).sum()))
        qw = wcorr / (np.sqrt(np.maximum(wen, 1e-9))
                      * np.sqrt((tmpl[ws_off:] ** 2).sum()))
        qd = np.minimum(qf, qw)
        want = int(np.argmax(qd))
        got = int(np.asarray(starts)[c, 0]) - L
        assert abs(got - want) <= 0, (c, got, want)
        assert abs(float(np.asarray(quality)[c, 0]) - qd[want]) < 2e-3


def test_batched_onehot_extract_matches_slicing(rng):
    """extract_bursts_batched == per-burst dynamic_slice extraction for
    valid (padded) starts."""
    sps = 3
    C, n = 5, 4000
    x = rng.normal(0, 1.0, (C, n)).astype(np.float32)
    pad = np.zeros((C, correlator.CAPTURE_SYMBOLS * sps), np.float32)
    xp = np.concatenate([x, pad], axis=-1)
    starts = rng.integers(0, n, (C, 3)).astype(np.int32)
    hard_b, soft_b = correlator.extract_bursts_batched(xp, starts, sps)
    import jax
    hard_s, soft_s = jax.vmap(
        lambda d, s: correlator.extract_burst_symbols(d, s, sps)
    )(xp, starts)
    assert np.allclose(np.asarray(soft_b), np.asarray(soft_s), atol=1e-5)
    assert np.array_equal(np.asarray(hard_b), np.asarray(hard_s))


def test_decode_select_then_correct_matches_correct_then_select(rng):
    """decode_bursts ranks repeats on packed syndromes and corrects only
    the selected repeat; must equal correcting all 5 repeats first and
    then selecting the first decodable one (the direct formulation),
    including on pure-noise captures (not-ok words pass raw bits)."""
    from amps_tpu.codec.bch import recc_bch_decode
    from amps_tpu.codec.manchester import manchester_decode_bits

    caps = rng.integers(0, 2, (6, correlator.CAPTURE_SYMBOLS)).astype(np.uint8)
    dec = decoder.decode_bursts(caps)

    word_sym = caps[:, 14:].reshape(6, 7, 480)
    bits, _ = manchester_decode_bits(word_sym)
    reps = np.asarray(bits).reshape(6, 7, 5, 48)
    all_dec, all_ok = recc_bch_decode(reps)
    all_dec, all_ok = np.asarray(all_dec), np.asarray(all_ok)
    first = np.argmax(all_ok, axis=-1)
    want = np.take_along_axis(
        all_dec, first[..., None, None], axis=-2)[..., 0, :]
    assert np.array_equal(np.asarray(dec.words), want)
    assert np.array_equal(np.asarray(dec.word_ok), all_ok.any(-1))
    assert np.array_equal(np.asarray(dec.repeat_used), first)


def test_decode_bursts_bf16_input_identical(rng):
    """The symbol-domain decoder consumes bf16 0/1 symbols (straight
    from the extractor's capture matmul) identically to uint8, and its
    dcc/bad outputs match the manchester_decode_bits formulation."""
    import jax.numpy as jnp
    from amps_tpu.codec.manchester import manchester_decode_bits

    caps = rng.integers(0, 2, (5, 2, correlator.CAPTURE_SYMBOLS)) \
        .astype(np.uint8)
    d_u8 = decoder.decode_bursts(caps)
    d_bf = decoder.decode_bursts(jnp.asarray(caps).astype(jnp.bfloat16))
    for a, b in zip(d_u8, d_bf):
        assert np.array_equal(np.asarray(a), np.asarray(b))

    dcc_bits, dcc_bad = manchester_decode_bits(caps[..., :14])
    word_sym = caps[..., 14:].reshape(5, 2, 7, 480)
    _, word_bad = manchester_decode_bits(word_sym)
    assert np.array_equal(np.asarray(d_u8.dcc_bits), np.asarray(dcc_bits))
    want_bad = np.concatenate([np.asarray(dcc_bad)[..., None],
                               np.asarray(word_bad)], axis=-1)
    assert np.array_equal(np.asarray(d_u8.bad_symbols), want_bad)


def test_no_retrigger_inside_active_capture(rng):
    """Random word data inside an active burst can correlate above
    threshold; the NMS suppresses the full capture extent forward of an
    accepted trigger (the reference's memmem search likewise resumes
    only after the capture, lib/recc_impl.cc:118-126) — while a
    legitimate later burst is still found."""
    words = recc_ms.page_response_words("5551234567")
    sps = 1
    s1 = _burst_in_stream(words, sps, lead=300, tail=60)
    # plant a fake trigger template INSIDE burst 1's capture region
    tmpl = correlator.trigger_template(sps)
    fake = s1.copy().astype(np.float32)
    fake[300 + 82 + 1200: 300 + 82 + 1200 + len(tmpl)] = tmpl * 0.9
    s2 = _burst_in_stream(words, sps, lead=200, tail=300)
    stream = np.concatenate([fake, s2.astype(np.float32)])
    starts, valid, q = correlator.find_bursts(stream, sps, max_bursts=4,
                                              threshold=0.6)
    starts, valid = np.asarray(starts), np.asarray(valid)
    got = sorted(starts[valid])
    assert len(got) == 2, (got, np.asarray(q))
    assert got[0] == 300 + 82
    assert got[1] == len(fake) + 200 + 82
    # same discipline on the symbol-domain detector
    phases = correlator.symbol_phase_streams(stream, sps)
    st2, v2, q2 = correlator.find_bursts_phases(phases, sps, 4, 0.6)
    got2 = sorted(np.asarray(st2)[np.asarray(v2)])
    assert list(got) == [int(g) for g in got2]


def test_batched_small_bank_rx_matches_single():
    """rx_multichannel_block_batched (G independent narrow bands in one
    program — the small-bank utilization fix) decodes identically to G
    single-stream calls."""
    import jax
    import jax.numpy as jnp
    from amps_tpu.eval.traffic import MobileEvent, synthesize_reverse_band
    from amps_tpu.parallel.pipeline import (MultichannelSpec,
                                            rx_multichannel_block,
                                            rx_multichannel_block_batched)

    spec = MultichannelSpec(num_channels=16, taps_per_phase=8)
    total_hops = 16384
    evs = [[MobileEvent("origination", 3, 700, "5551234567", "7025551000",
                        esn=g)] for g in range(3)]
    xs = np.stack([np.asarray(synthesize_reverse_band(
        e, spec, total_hops, noise_sigma=0.001, seed=g))
        for g, e in enumerate(evs)])
    out = jax.device_get(rx_multichannel_block_batched(
        jnp.asarray(xs), spec, max_bursts=1, threshold=0.55))
    for g in range(3):
        ref = jax.device_get(rx_multichannel_block(
            jnp.asarray(xs[g]), spec, max_bursts=1, threshold=0.55))
        assert bool(out["valid"][g][3][0]) and bool(ref["valid"][3][0])
        assert np.array_equal(out["words"][g][3][0], ref["words"][3][0])
        want = np.stack(evs[g][0].words())
        assert np.array_equal(
            np.asarray(out["words"][g][3][0])[: len(want)], want)


def test_trigger_verification_gate():
    """Post-capture trigger verification (stream64 triage fix): the
    sliced 74-symbol trigger of a real candidate matches the exact
    pattern (~0 mismatches, memmem-equivalence, lib/recc_impl.cc:118);
    a candidate pointing into pre-burst silence/noise scores ~50%
    mismatches and is gated out of `valid` by apply_trigger_gate."""
    import jax.numpy as jnp
    from amps_tpu.config import PipelineConfig
    from amps_tpu.dsp.fm import fm_modulate_symbols, quadrature_demod
    from amps_tpu.rx import correlator
    from amps_tpu.tx import recc_ms

    pipe = PipelineConfig()
    sps = pipe.chan_sps
    words = recc_ms.page_response_words("4155559876")
    syms = recc_ms.burst_symbols(words, dcc=1, sps=sps)
    sens = 2 * np.pi * pipe.deviation_hz / pipe.chan_rate
    bb, _ = fm_modulate_symbols(syms.astype(np.int8), sens)
    bb = np.asarray(bb)
    off = 6000
    iq = np.zeros((off + len(bb) + 4000, 2), np.float32)
    iq[off: off + len(bb)] = bb
    rng = np.random.default_rng(5)
    iq += rng.normal(0, 0.005, iq.shape).astype(np.float32)
    demod = np.asarray(quadrature_demod(jnp.asarray(iq))[0])

    phases = correlator.symbol_phase_streams(jnp.asarray(demod), sps)
    starts, valid, quality = correlator.find_bursts_phases(
        phases[None], sps, max_bursts=2, threshold=0.55)
    assert bool(np.asarray(valid)[0, 0])
    true_start = int(np.asarray(starts)[0, 0])

    cand = jnp.asarray([[true_start, true_start - 1200]], jnp.int32)
    errs = np.asarray(correlator.trigger_errors(phases[None], cand, sps))
    assert errs[0, 0] <= 3, errs          # real trigger: near-exact
    assert errs[0, 1] >= 20, errs         # silence: ~half mismatch
    v = np.asarray(correlator.apply_trigger_gate(
        jnp.asarray([[True, True]]), phases[None], cand, sps,
        correlator.MAX_TRIGGER_ERRORS))
    assert v.tolist() == [[True, False]]
    # disabled gate passes everything through
    v = np.asarray(correlator.apply_trigger_gate(
        jnp.asarray([[True, True]]), phases[None], cand, sps, -1))
    assert v.tolist() == [[True, True]]
    # partial window (start near the stream head): only in-window
    # symbols are counted, so the count stays bounded by availability
    cand2 = jnp.asarray([[30, 100]], jnp.int32)
    errs2 = np.asarray(correlator.trigger_errors(phases[None], cand2, sps))
    assert (errs2 <= correlator.TRIGGER_SYMBOLS).all()


def test_repeat_gate_kills_bch_aliased_noise_repeats():
    """Erasure-gated 5-repeat combining (rx/decoder.py repeat_gate).

    The (48,36) code decodes PURE NOISE with p~0.29 per repeat, so the
    reference's sequential fallback (lib/recc_decode_impl.cc:100-107)
    delivers an aliased word_ok=True wrong word whenever a noise repeat
    precedes the first clean one — the misdecode class the 64-block
    streaming soak observed on the device.  With the gate, noise
    repeats (>=~24 of 48 Manchester violations) are erasures: selection
    and the majority vote use clean repeats only, and a word with zero
    clean decodable repeats is honestly word_ok=False."""
    words = recc_ms.page_response_words("5551234567")
    syms = recc_ms.burst_symbols(words, dcc=0, sps=1)
    idle = np.tile(np.array([1, -1], np.int8), 250)
    stream = np.concatenate([idle, syms, idle]).astype(np.float32)
    starts, valid, q = correlator.find_bursts(stream, 1, max_bursts=2)
    assert np.asarray(valid)[0]
    hard, _ = correlator.extract_burst_symbols(
        np.pad(stream, (0, correlator.CAPTURE_SYMBOLS)), starts, 1)
    cap = np.asarray(hard)[0].astype(np.uint8)
    W = 1                      # corrupt word 1 (word 0 stays a control)
    base = 14 + W * 480
    aliased = 0
    for seed in range(6):
        rng = np.random.default_rng(seed)
        c = cap.copy()
        for r in range(3):     # repeats 0-2 noise, 3-4 clean
            c[base + 96 * r: base + 96 * (r + 1)] = rng.integers(0, 2, 96)
        for policy in ("first_ok", "majority"):
            d0 = decoder.decode_bursts(c, policy)
            if (np.asarray(d0.word_ok)[W]
                    and not np.array_equal(np.asarray(d0.words)[W],
                                           words[W])):
                aliased += 1   # ungated: wrong word delivered as ok
            d1 = decoder.decode_bursts(c, policy, repeat_gate=6)
            assert np.asarray(d1.word_ok)[W], (seed, policy)
            assert np.array_equal(np.asarray(d1.words)[W], words[W]), \
                (seed, policy)
            # untouched words unaffected by the gate
            assert np.asarray(d1.word_ok)[0]
            assert np.array_equal(np.asarray(d1.words)[0], words[0])
        # all 5 repeats noise: gated decode must refuse, both policies
        for r in range(3, 5):
            c[base + 96 * r: base + 96 * (r + 1)] = rng.integers(0, 2, 96)
        for policy in ("first_ok", "majority"):
            d2 = decoder.decode_bursts(c, policy, repeat_gate=6)
            assert not np.asarray(d2.word_ok)[W], (seed, policy)
    # the hazard is real: ungated decodes deliver aliased words
    assert aliased >= 6, aliased


def test_window_power_blocks_matches_contiguous_series(rng):
    """Piecewise blocked power (carry | new parts) equals the
    contiguous-series reduction burst_rssi runs internally."""
    import jax.numpy as jnp
    pw = rng.uniform(0.0, 2.0, (5, 9000)).astype(np.float32)
    starts = np.array([[0, 1200], [384, 383], [7000, 8999],
                       [10, 4000], [8999, 0]], np.int32)
    want = np.asarray(correlator.burst_rssi(jnp.asarray(pw), starts, 1))
    for cut in (0, 1, 344, 384, 4000, 9000):
        blk = correlator.window_power_blocks(
            [jnp.asarray(pw[:, :cut]), jnp.asarray(pw[:, cut:])])
        got = np.asarray(correlator.burst_rssi_blocks(blk, starts, 1))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def test_majority_tie_break_weights_are_bf16_exact():
    """The gated-majority tie-break epsilons must survive bf16 operand
    rounding (default matmul precision may round f32 operands to bf16 —
    the packed-LUT incident class; TF32 keeps more bits): every weight
    1 + 2^-(r+3) must be exactly representable in bfloat16, and the
    total perturbation must stay below the minimum non-tie margin."""
    import jax.numpy as jnp
    eps = 0.125 / 2.0 ** np.arange(5)
    w = (1.0 + eps).astype(np.float32)
    roundtrip = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(roundtrip, w), (roundtrip, w)
    # subset sums of the epsilons are unique (distinct powers of two)
    sums = set()
    for m in range(32):
        t = sum(e for i, e in enumerate(eps) if m >> i & 1)
        assert t not in sums
        sums.add(t)
    # 2*sum(eps_votes) + sum(eps_nvote) < 1, the minimum non-tie margin
    assert 3 * eps.sum() < 1.0


def test_fused_trigger_gate_matches_standalone():
    """Extraction-fused trigger verification (lead symbols +
    trigger_errors_soft) counts the same mismatches as the standalone
    trigger_errors plane pass, for real triggers and for noise."""
    import jax.numpy as jnp
    words = recc_ms.page_response_words("5551234567")
    rng = np.random.default_rng(5)
    sps = 3
    base = recc_ms.burst_symbols(words, dcc=0, sps=sps).astype(np.float32)
    noise = np.repeat(rng.choice(np.array([-1, 1], np.float32), 3600), sps)
    stream = np.concatenate([np.tile(np.array([1, -1], np.float32), 400),
                             base, noise])
    phases = correlator.symbol_phase_streams(stream, sps)
    starts, valid, q = correlator.find_bursts_phases(
        phases[None], sps, max_bursts=4, threshold=0.5)
    want = np.asarray(correlator.trigger_errors(phases[None], starts, sps))
    ext = correlator.extract_from_phases(
        phases[None], starts, sps, lead=correlator.TRIGGER_SYMBOLS)
    got = np.asarray(correlator.trigger_errors_soft(ext[2]))
    assert np.array_equal(got, want), (got, want)
    # and the capture symbols are unchanged by the lead
    hard0, _ = correlator.extract_from_phases(phases[None], starts, sps)
    assert np.array_equal(np.asarray(hard0), np.asarray(ext[0]))


def test_fused_trigger_gate_matches_standalone_head_starts():
    """r3 advisor finding: for candidate starts < TRIGGER_SYMBOLS*sps
    (the trigger window extends before the stream head) the fused gate
    used to clamp the extraction window and score stream-head symbols
    against the template (~37 errors) where the standalone
    trigger_errors masks before-window symbols.  With floor-division
    targeting + the starts mask, the two paths must agree for ANY
    start — and the capture itself must stay aligned (the old clamp
    also shifted the capture for such starts)."""
    import jax.numpy as jnp
    words = recc_ms.page_response_words("5551234567")
    sps = 3
    base = recc_ms.burst_symbols(words, dcc=0, sps=sps).astype(np.float32)
    # burst begins AT the stream head: capture start = trigger end =
    # 74 symbols in, and we probe candidate starts both before and
    # after TRIGGER_SYMBOLS*sps
    stream = np.concatenate([base, np.zeros(2000 * sps, np.float32)])
    phases = correlator.symbol_phase_streams(stream, sps)
    # the true capture start is symbol 82 (30 dotting + 11 sync bits);
    # the others probe the head-clipped region
    cand = jnp.asarray([[0, 50, 74 * sps - 1, 74 * sps, 82 * sps]],
                       jnp.int32)
    want = np.asarray(correlator.trigger_errors(phases[None], cand, sps))
    ext = correlator.extract_from_phases(
        phases[None], cand, sps, lead=correlator.TRIGGER_SYMBOLS)
    got = np.asarray(correlator.trigger_errors_soft(ext[2], cand, sps))
    assert np.array_equal(got, want), (got, want)
    # capture alignment: the lead variant must extract the same capture
    # symbols as the lead=0 variant for every candidate, including the
    # head-clipped ones
    hard0, _ = correlator.extract_from_phases(phases[None], cand, sps)
    assert np.array_equal(np.asarray(hard0), np.asarray(ext[0]))
    # the true burst (capture start at symbol 82) slices its trigger clean
    assert got[0, 4] <= 2, got
