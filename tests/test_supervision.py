"""SAT/ST supervision: device tone measurement + host call supervision.

Extension over the reference (it never verifies the transponded SAT;
SURVEY.md §5 'failure detection: none').  Scenarios follow TIA/EIA-553
§2.4.2 (SAT fade), §2.7.1.2/§2.7.2 (signaling tone: ringing, answer,
flash 400 ms, release 1.8 s).
"""

import numpy as np
import pytest

from amps_tpu.config import SystemConfig
from amps_tpu.control.station import BaseStation
from amps_tpu.control.supervision import (ALERTING, CONVERSATION, RELEASED,
                                          ChannelSupervisor,
                                          SupervisionConfig)
from amps_tpu.rx.voice import ST_INDEX, supervision_levels

FS = 60_000
FRAME = 600  # 10 ms


def _tone_demod(seconds, sat_hz=6000.0, sat_amp=0.05, st=False,
                st_amp=0.05, noise=0.0, seed=0):
    """Synthesize an RVC FM-demod stream: SAT + optional ST + noise."""
    n = int(seconds * FS)
    t = np.arange(n) / FS
    x = np.zeros(n, np.float32)
    if sat_amp:
        x += sat_amp * np.cos(2 * np.pi * sat_hz * t).astype(np.float32)
    if st:
        x += st_amp * np.cos(2 * np.pi * 10_000.0 * t).astype(np.float32)
    if noise:
        x += np.random.default_rng(seed).normal(
            0, noise, n).astype(np.float32)
    return x


def _frames(x):
    lv, pw = supervision_levels(x, FRAME, FS)
    return np.asarray(lv), np.asarray(pw)


def test_supervision_levels_measures_tones():
    x = _tone_demod(0.2, sat_amp=0.05, st=True, st_amp=0.08, noise=0.01)
    lv, pw = _frames(x)
    assert lv.shape == (20, 5) and pw.shape == (20,)
    assert np.allclose(lv[:, 1], 0.05, atol=0.01)      # SCC=1 SAT
    assert np.allclose(lv[:, ST_INDEX], 0.08, atol=0.01)
    assert lv[:, 0].max() < 0.02 and lv[:, 2].max() < 0.02
    # guard noise-reference bins stay quiet under tones+noise, so a
    # real ST dominates them by far more than st_guard_ratio
    assert (lv[:, ST_INDEX] > 4 * lv[:, 4]).all()
    silent, _ = _frames(_tone_demod(0.1, sat_amp=0.0))
    assert silent.max() < 1e-3


def test_wrong_scc_releases_after_fade_timeout():
    cfg = SupervisionConfig(fade_timeout_s=1.0)
    sup = ChannelSupervisor(355, scc=1, config=cfg, state=CONVERSATION)
    # mobile transponds the WRONG SAT (5970 = SCC 0)
    lv, pw = _frames(_tone_demod(1.5, sat_hz=5970.0))
    sup.push_frames(lv, pw)
    assert sup.state == RELEASED
    kinds = [e.kind for e in sup.events]
    assert "sat_lost" in kinds and kinds[-1] == "release"
    assert "SAT fade" in sup.events[-1].reason


def test_short_fade_recovers():
    sup = ChannelSupervisor(355, scc=1, state=CONVERSATION)
    lv1, pw1 = _frames(_tone_demod(0.5))
    lv2, pw2 = _frames(_tone_demod(0.5, sat_amp=0.0))   # 0.5 s fade
    sup.push_frames(lv1, pw1)
    sup.push_frames(lv2, pw2)
    sup.push_frames(lv1, pw1)
    assert sup.state == CONVERSATION
    kinds = [e.kind for e in sup.events]
    assert "sat_lost" in kinds and "sat_back" in kinds


def test_alert_answer_flash_release_sequence():
    sup = ChannelSupervisor(355, scc=1, state=ALERTING)
    sup.begin_alert()
    # ringing: ST on (mobile transponds SAT too)
    lv, pw = _frames(_tone_demod(1.0, st=True))
    sup.push_frames(lv, pw)
    assert sup.state == ALERTING
    # answer: ST drops, SAT stays
    lv, pw = _frames(_tone_demod(1.0))
    sup.push_frames(lv, pw)
    assert sup.state == CONVERSATION
    assert [e.kind for e in sup.events] == ["answer"]
    # flash: 400 ms ST burst
    lv, pw = _frames(_tone_demod(0.4, st=True))
    sup.push_frames(lv, pw)
    lv, pw = _frames(_tone_demod(0.3))
    sup.push_frames(lv, pw)
    assert [e.kind for e in sup.events] == ["answer", "flash"]
    # hang-up: 1.8 s ST
    lv, pw = _frames(_tone_demod(2.0, st=True))
    sup.push_frames(lv, pw)
    assert sup.state == RELEASED
    assert sup.events[-1].kind == "release"
    assert "ST" in sup.events[-1].reason


def test_alert_timeout_releases():
    cfg = SupervisionConfig(alert_timeout_s=2.0)
    sup = ChannelSupervisor(355, scc=1, config=cfg, state=ALERTING)
    sup.begin_alert()
    lv, pw = _frames(_tone_demod(2.5, st=True))   # rings forever
    sup.push_frames(lv, pw)
    assert sup.state == RELEASED
    assert "no answer" in sup.events[-1].reason


def test_station_supervises_paged_call():
    bs = BaseStation()
    bs.handle_command("page 5551234567")
    # drive through the public dispatch with synthesized field words
    from amps_tpu.tx import recc_ms
    words = recc_ms.page_response_words("5551234567")
    ok = np.ones(7, bool)
    w7 = np.zeros((7, 36), np.uint8)
    w7[: len(words)] = words
    bs.handle_burst(w7, ok)
    chan = bs.system.voice_channels[0]
    assert chan in bs.supervisors
    assert bs.supervisors[chan].state == ALERTING
    assert bs.fvc_mute is False and bs.audio_mute is True

    # ringing then answer
    lv, pw = _frames(_tone_demod(0.5, st=True))
    bs.push_supervision(chan, lv, pw)
    lv, pw = _frames(_tone_demod(0.5))
    bs.push_supervision(chan, lv, pw)
    assert bs.supervisors[chan].state == CONVERSATION
    assert bs.fvc_mute is True and bs.audio_mute is False  # voice path up

    # SAT fade to release (shorten the timeout to keep the test fast)
    bs.supervisors[chan].cfg = SupervisionConfig(fade_timeout_s=0.5)
    lv, pw = _frames(_tone_demod(1.0, sat_amp=0.0))
    bs.push_supervision(chan, lv, pw)
    assert chan not in bs.supervisors
    rel = [e for e in bs.events if e.kind == "release"]
    assert rel and rel[-1].payload[0] == chan
    # release order went out on the FVC with the timer armed
    fvc = [e for e in bs.events if e.kind == "fvc_words"]
    assert fvc, "no FVC words emitted"
    rel_word, timer = fvc[-1].payload
    assert timer > 0


def test_dead_carrier_noise_is_squelched():
    """A dead carrier demodulates to full-scale discriminator noise
    (power >> any live modulation); the max_power squelch must treat it
    as carrier loss — fade release fires, and the random ST-bin hits
    never surface as flash/answer/release(ST) events (the spurious
    'flash' the voice soak observed on the device)."""
    cfg = SupervisionConfig(fade_timeout_s=0.5)
    sup = ChannelSupervisor(355, scc=1, config=cfg, state=CONVERSATION)
    # full-scale white discriminator noise, deviation-normalized:
    # uniform(-pi, pi) / sens
    rng = np.random.default_rng(3)
    sens = 2 * np.pi * 8000.0 / FS
    x = rng.uniform(-np.pi, np.pi, int(1.0 * FS)).astype(np.float32) / sens
    lv, pw = _frames(x)
    assert pw.min() > cfg.max_power     # the regime the squelch targets
    sup.push_frames(lv, pw)
    kinds = [e.kind for e in sup.events]
    assert "release" in kinds
    assert sup.events[-1].reason == "SAT fade timeout"
    assert "flash" not in kinds and "answer" not in kinds


def test_fade_frame_during_ringing_is_not_an_answer():
    """A deep-fade frame while the mobile rings (carrier False -> no
    tone information) must not register as ST drop / answer; the real
    answer after the fade still lands."""
    cfg = SupervisionConfig(fade_timeout_s=5.0)
    sup = ChannelSupervisor(355, scc=1, config=cfg, state=CONVERSATION)
    sup.begin_alert()
    ring, pw_ring = _frames(_tone_demod(0.2, st=True))
    sup.push_frames(ring, pw_ring)
    # 3 frames of full-scale discriminator noise (dead carrier)
    rng = np.random.default_rng(7)
    sens = 2 * np.pi * 8000.0 / FS
    noise = rng.uniform(-np.pi, np.pi, 3 * FRAME).astype(np.float32) / sens
    lvn, pwn = _frames(noise)
    sup.push_frames(lvn, pwn)
    assert not any(e.kind == "answer" for e in sup.events)
    assert sup.state == ALERTING
    # ringing resumes, then a REAL ST drop answers
    sup.push_frames(ring, pw_ring)
    talk, pw_talk = _frames(_tone_demod(0.2, st=False))
    sup.push_frames(talk, pw_talk)
    assert any(e.kind == "answer" for e in sup.events)
    assert sup.state == CONVERSATION


def test_noise_that_slips_the_power_squelch_cannot_sustain_st():
    """VERDICT r3 item 4: even discriminator noise whose band power
    happens to sit INSIDE the carrier-present window (so the max_power
    squelch does not help) must never sustain an ST run: white noise
    puts the same expected level in the 10 kHz bin and the empty guard
    bins, so the per-frame dominance gate (st > st_guard_ratio * guard)
    breaks every run long before flash length."""
    cfg = SupervisionConfig(fade_timeout_s=60.0)  # isolate the ST logic
    sup = ChannelSupervisor(355, scc=1, config=cfg, state=CONVERSATION)
    rng = np.random.default_rng(11)
    # noise scaled so per-frame power lands between min_power and
    # max_power — the squelch-transparent regime
    x = rng.normal(0, 0.9, int(4.0 * FS)).astype(np.float32)
    lv, pw = _frames(x)
    inside = (pw > cfg.min_power) & (pw < cfg.max_power)
    assert inside.mean() > 0.9, "test signal must slip the squelch"
    sup.push_frames(lv, pw)
    kinds = [e.kind for e in sup.events]
    assert "flash" not in kinds and "release" not in kinds, kinds
    # sanity: without the dominance gate this noise DOES fake ST frames
    st_naive = lv[:, 3] > cfg.st_on_ratio * cfg.st_nominal
    assert st_naive.any(), "noise too weak to threaten the naive gate"
    # and a genuine ST (with voice underneath) still passes the gate
    sup2 = ChannelSupervisor(355, scc=1, config=cfg, state=CONVERSATION)
    x2 = _tone_demod(0.5, st=True) + \
        0.3 * np.cos(2 * np.pi * 1000.0 *
                     np.arange(int(0.5 * FS)) / FS).astype(np.float32)
    lv2, pw2 = _frames(x2)
    sup2.push_frames(lv2, pw2)
    sup2.push_frames(*_frames(_tone_demod(0.2, st=False)))
    assert any(e.kind == "flash" for e in sup2.events) or \
        sup2._st_run_t == 0.0  # the 0.5 s run read as ST throughout
    assert (lv2[:, 3] > cfg.st_guard_ratio * lv2[:, 4]).all()


def test_isolated_false_st_frames_cannot_fake_an_answer():
    """r4 fading study: fade edges produce ISOLATED false-ST frames
    (runs <= 0.03 s measured, tools/sup_fading_sweep.out).  Before the
    answer-arming run requirement, ONE such frame during alerting plus
    the next quiet frame faked an answer.  Real ringing (seconds of
    continuous ST) still answers normally."""
    cfg = SupervisionConfig()
    sup = ChannelSupervisor(355, scc=1, config=cfg, state=CONVERSATION)
    sup.begin_alert()
    quiet, pw_q = _frames(_tone_demod(0.1, st=False))      # SAT only
    blip, pw_b = _frames(_tone_demod(0.02, st=True))       # 2 ST frames
    sup.push_frames(quiet, pw_q)
    sup.push_frames(blip, pw_b)       # isolated blip, below arm run
    sup.push_frames(quiet, pw_q)
    assert not any(e.kind == "answer" for e in sup.events), sup.events
    assert sup.state == ALERTING
    # genuine ringing (>= arm run) then drop answers
    ring, pw_r = _frames(_tone_demod(0.3, st=True))
    sup.push_frames(ring, pw_r)
    sup.push_frames(quiet, pw_q)
    assert any(e.kind == "answer" for e in sup.events)
    assert sup.state == CONVERSATION


def test_supervision_rides_out_fading():
    """docs/BER.md supervision section regression: conversation-state
    supervision through fast Rayleigh fading + noise must neither
    release the call (longest SAT loss << fade timeout) nor emit ANY
    signaling event (isolated false-ST frames never reach flash
    length)."""
    import jax.numpy as jnp
    from amps_tpu.config import PipelineConfig
    from amps_tpu.dsp.fm import fm_modulate, quadrature_demod
    from amps_tpu.eval import channel

    pipe = PipelineConfig()
    fs = float(pipe.chan_rate)
    sens = 2.0 * np.pi * pipe.deviation_hz / fs
    n = int(8.0 * fs)
    t = np.arange(n) / fs
    m = (0.05 * np.cos(2 * np.pi * 6000.0 * t)
         + 0.3 * np.cos(2 * np.pi * 1000.0 * t)).astype(np.float32)
    iq = np.asarray(fm_modulate(jnp.asarray(m), sens)[0])
    rng = np.random.default_rng(5)
    iq = np.asarray(channel.apply_gain(
        iq, channel.rayleigh_gain(n, fs, 77.0, rng)), np.float32)
    iq = iq + rng.normal(0, np.sqrt(10 ** (-1.0) / 2),
                         iq.shape).astype(np.float32)   # 10 dB
    demod = np.asarray(quadrature_demod(jnp.asarray(iq))[0]) / sens
    lv, pw = _frames(demod)
    sup = ChannelSupervisor(355, scc=1, config=SupervisionConfig(),
                            state=CONVERSATION)
    sup.push_frames(lv, pw)
    kinds = [e.kind for e in sup.events]
    assert "release" not in kinds, kinds
    assert "flash" not in kinds and "answer" not in kinds, kinds
    assert sup.state == CONVERSATION


def test_periodic_spurious_st_cannot_ratchet_the_arm_accumulator():
    """Advisor finding (r4): the arming accumulator summed
    non-consecutive ST frames with NO decay, so a periodic train of
    isolated spurious ST hits with inter-arrival shorter than the drop
    confirmation window (which is what resets the accumulator) could
    ratchet it to the arm threshold and fire a false answer at the next
    confirmed quiet.  With the unconfirmed-quiet decay, arming needs an
    ST duty cycle > 1/3 — the sparse pattern never arms, while genuine
    ringing seen through fading gaps (duty ~60%, miss runs below the
    confirm window) still arms and answers."""
    cfg = SupervisionConfig()
    sup = ChannelSupervisor(355, scc=1, config=cfg, state=CONVERSATION)
    sup.begin_alert()
    # 1 spurious ST frame every 8 frames: quiet runs of 7 frames never
    # reach st_drop_confirm_s (10 frames), so the accumulator was never
    # reset under the old logic and armed after ~1.6 s
    blip, pw_b = _frames(_tone_demod(0.01, st=True))       # 1 ST frame
    quiet7, pw_q7 = _frames(_tone_demod(0.07, st=False))   # 7 quiet
    for _ in range(40):                                    # 3.2 s of pattern
        sup.push_frames(blip, pw_b)
        sup.push_frames(quiet7, pw_q7)
    assert sup._st_run_t < cfg.st_answer_arm_s / 2, sup._st_run_t
    assert not sup._st_seen_in_alert
    # the pattern stops: the following confirmed quiet must NOT answer
    quiet, pw_q = _frames(_tone_demod(0.3, st=False))
    sup.push_frames(quiet, pw_q)
    assert not any(e.kind == "answer" for e in sup.events), sup.events
    assert sup.state == ALERTING

    # fading-shaped genuine ringing still arms: 6 ST / 4 miss repeating
    ring6, pw_r6 = _frames(_tone_demod(0.06, st=True))
    miss4, pw_m4 = _frames(_tone_demod(0.04, st=False))
    for _ in range(10):                                    # 1.0 s ringing
        sup.push_frames(ring6, pw_r6)
        sup.push_frames(miss4, pw_m4)
    assert sup._st_seen_in_alert
    sup.push_frames(quiet, pw_q)                           # confirmed drop
    assert any(e.kind == "answer" for e in sup.events)
    assert sup.state == CONVERSATION


def test_fading_fragmented_release_still_releases_without_flash():
    """r5 review finding: CONVERSATION ST tracking had no drop-debounce,
    so a 1.8 s mobile-release tone fragmented by fading (single missed
    frames, duty ~80%) fired repeated spurious 'flash' events and never
    released until the 5 s SAT fade timeout.  With the confirmed-off
    debounce + decay (the ALERTING discipline mirrored), the fragmented
    run accumulates to the release threshold and no flash fires."""
    cfg = SupervisionConfig(fade_timeout_s=60.0)  # isolate the ST logic
    sup = ChannelSupervisor(355, scc=1, config=cfg, state=CONVERSATION)
    # 4 ST frames, 1 missed frame (fading dropout shorter than the
    # 0.1 s drop-confirm window), repeating — 80% duty
    frag = np.concatenate([_tone_demod(0.04, st=True),
                           _tone_demod(0.01, st=False)])
    x = np.concatenate([frag] * 64)               # 3.2 s of fragmented ST
    sup.push_frames(*_frames(x))
    kinds = [e.kind for e in sup.events]
    assert sup.state == RELEASED, kinds
    assert "flash" not in kinds, kinds
    assert "ST" in sup.events[-1].reason

    # a genuine 400 ms flash (clean) still classifies as flash, using
    # the run length at the falling edge (not the decayed value)
    sup2 = ChannelSupervisor(355, scc=1, config=cfg, state=CONVERSATION)
    sup2.push_frames(*_frames(_tone_demod(0.4, st=True)))
    sup2.push_frames(*_frames(_tone_demod(0.3, st=False)))
    assert [e.kind for e in sup2.events] == ["flash"]

    # an isolated single fake-ST frame decays away: no flash, no release
    sup3 = ChannelSupervisor(355, scc=1, config=cfg, state=CONVERSATION)
    one = np.concatenate([_tone_demod(0.01, st=True),
                          _tone_demod(0.5, st=False)])
    sup3.push_frames(*_frames(np.concatenate([one] * 4)))
    assert [e.kind for e in sup3.events] == []
