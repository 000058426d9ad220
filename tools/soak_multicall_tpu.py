"""ON-CHIP multi-call supervision soak (round 4): FOUR concurrent
supervised calls on the 1024-channel bank at bench dtypes, per-channel
call control (BaseStation(per_channel_fvc=True)), staggered lifecycles:

  chan 355 (slot 300): ring -> answer 0.6 -> talk -> hang-up ST 1.6
  chan 356 (slot 400): conversation from 0 -> hang-up ST 2.1
  chan 357 (slot 500): ring -> answer 1.0 -> talk -> deep fade 2.6
  chan 358 (slot 600): conversation from 0 -> talks past every other
                       call's teardown (released by the operator at
                       the end) — proves neighbors' releases leave it
                       untouched.

Verdict: the supervision event timeline must match EXACTLY (zero
unexpected events — no cross-call leakage, no spurious flash/answer on
the dead carriers after teardown), hang-ups release with the ST
reason, the fade releases with the fade reason, and the long call
survives to the end.
"""
import os
import dataclasses
import json
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax

from amps_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
import jax.numpy as jnp  # noqa: E402

from amps_tpu.config import SystemConfig  # noqa: E402
from amps_tpu.control.station import BaseStation  # noqa: E402
from amps_tpu.control.supervision import ALERTING, CONVERSATION  # noqa: E402
from amps_tpu.dsp import channelizer as chz  # noqa: E402
from amps_tpu.dsp.fm import fm_modulate  # noqa: E402
from amps_tpu.parallel.pipeline import MultichannelSpec  # noqa: E402
from amps_tpu.runtime.streamer import MultichannelReceiver  # noqa: E402

OUT = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "soak_multicall_tpu.out"), "a", buffering=1)


def emit(**kw):
    OUT.write(json.dumps(kw) + "\n")
    print(kw, flush=True)


M = int(__import__("os").environ.get("SOAK_M", "1024"))
spec = MultichannelSpec(num_channels=M, taps_per_phase=8, fold="bank",
                        io_bf16=True, corr_bf16=True)
P = spec.chz_spec.hop
pipe = spec.pipe
fs = float(pipe.chan_rate)
sens = 2.0 * np.pi * pipe.deviation_hz / fs
DUR = 3.6
n = int(DUR * fs)
n -= n % P
t = np.arange(n) / fs
SAT_AMP, ST_AMP = 0.05, 0.05
FADE_TO, ST_REL = 0.6, 0.5

# (chan, slot, start_state, t_answer|None, t_hang|None, t_fade|None)
CALLS = [
    (355, min(300, M - 8) // 1, ALERTING, 0.6, 1.6, None),
    (356, min(400, M - 6), CONVERSATION, None, 2.1, None),
    (357, min(500, M - 4), ALERTING, 1.0, None, 2.6),
    (358, min(600, M - 2), CONVERSATION, None, None, None),
]
GATES = dict(fade_timeout_s=FADE_TO, st_release_s=ST_REL,
             per_channel_fvc=True, st_guard_ratio=2.0,
             carrier_guard_max=0.04,
             spec=dict(io_bf16=spec.io_bf16, corr_bf16=spec.corr_bf16))
emit(event="start", device=str(jax.devices()[0]), M=M, dur_s=DUR,
     calls=[(c, s, st, ta, th, tf) for c, s, st, ta, th, tf in CALLS],
     gates=GATES)


def call_mod(state0, t_ans, t_hang, t_fade):
    """Deviation-normalized modulating signal for one call timeline."""
    sat = SAT_AMP * np.cos(2 * np.pi * 6000.0 * t)       # SCC=1
    st_tone = ST_AMP * np.cos(2 * np.pi * 10_000.0 * t)
    voice = 0.3 * np.cos(2 * np.pi * 1000.0 * t)
    ringing = (t < t_ans) if t_ans is not None else np.zeros_like(t, bool)
    m = sat + np.where(ringing, st_tone, voice)
    active = np.ones_like(t, bool)
    if t_hang is not None:
        # hang-up: ST run then carrier off
        st_run = (t >= t_hang) & (t < t_hang + ST_REL + 0.2)
        m = np.where(st_run, sat + st_tone, m)
        active &= t < t_hang + ST_REL + 0.2
    if t_fade is not None:
        active &= t < t_fade
    return m, active.astype(np.float32)


Y = np.zeros((n, M, 2), np.float32)
for chan, slot, st0, t_ans, t_hang, t_fade in CALLS:
    m, act = call_mod(st0, t_ans, t_hang, t_fade)
    iq = np.array(fm_modulate(jnp.asarray(m, jnp.float32), sens)[0])
    Y[:, slot] = iq * act[:, None]
x, _ = chz.synthesize(jnp.asarray(Y), spec.chz_spec,
                      chz.synthesizer_init(spec.chz_spec))
x = x + 0.005 * jax.random.normal(jax.random.PRNGKey(7), x.shape,
                                  jnp.float32)
del Y
x.block_until_ready()
emit(event="synthesized", samples=int(x.shape[0]))

system = SystemConfig(voice_channels=tuple(c for c, *_ in CALLS))
station = BaseStation(system, sps=spec.chan_sps, per_channel_fvc=True)
station.supervision_config = dataclasses.replace(
    station.supervision_config, fade_timeout_s=FADE_TO, st_release_s=ST_REL)
events = []
station._on_event = lambda ev: events.append((ev.kind, ev.payload))
slot_map = {slot: chan for chan, slot, *_ in CALLS}
for chan, slot, st0, *_ in CALLS:
    station._start_supervision(chan, st0)
    if st0 == ALERTING:
        station.supervisors[chan].begin_alert()

rx = MultichannelReceiver(
    spec, max_bursts=2, threshold=0.55,
    supervision_slots=tuple(sorted(slot_map)),
    on_supervision=lambda slot, lv, pw: station.push_supervision(
        slot_map[slot], lv, pw))
BLOCK = 8192 * P
t0 = time.perf_counter()
for off in range(0, n * P, BLOCK):
    rx.push(x[off: off + BLOCK])
rx.flush()
emit(event="streamed", wall_s=round(time.perf_counter() - t0, 2),
     blocks=-(-n * P // BLOCK))

sup = [p for k, p in events if k == "supervision_event"]
timeline = [(e.kind, e.channel, round(e.t, 2)) for e in sup]
emit(event="timeline", events=timeline)

# the long call (358) must still be alive before the operator releases
checks = {"long_call_survived": 358 in station.supervisors
          and station.supervisors[358].state == CONVERSATION}
station.release_call(358, "operator")

expected = [
    ("answer", 355, 0.6, 0.15),
    ("answer", 357, 1.0, 0.15),
    ("release", 355, 1.6 + ST_REL, 0.15),          # ST hang-up
    ("release", 356, 2.1 + ST_REL, 0.15),          # ST hang-up
    ("sat_lost", 357, 2.6, 0.15),
    ("release", 357, 2.6 + FADE_TO, 0.15),         # fade
    ("sat_lost", 355, 1.6 + ST_REL + 0.2, 0.25),   # post-release carrier off
    ("sat_lost", 356, 2.1 + ST_REL + 0.2, 0.25),
    # end of stream: the flush block is trailing silence, so the long
    # call's carrier drops right at DUR (supervision keeps running
    # until the operator release below)
    ("sat_lost", 358, DUR, 0.5),
]
problems = []
got = list(timeline)
# releases tear supervisors down, so post-release sat_lost may or may
# not appear depending on ordering; match kinds greedily by (kind, chan)
for kind, chan, t_exp, tol in expected:
    hit = next((g for g in got
                if g[0] == kind and g[1] == chan
                and abs(g[2] - t_exp) <= tol), None)
    if kind == "sat_lost" and hit is None:
        continue        # optional trailing event (supervisor torn down)
    if hit is None:
        problems.append(f"missing {kind} on {chan} @ ~{t_exp}")
    else:
        got.remove(hit)
for g in got:
    problems.append(f"unexpected event {g}")
rel_reasons = {e.channel: e.reason for e in sup if e.kind == "release"}
checks.update({
    "timeline_exact_zero_unexpected": not problems,
    "st_release_355": "ST" in rel_reasons.get(355, ""),
    "st_release_356": "ST" in rel_reasons.get(356, ""),
    "fade_release_357": "fade" in rel_reasons.get(357, ""),
    "all_torn_down": not station.supervisors,
})
emit(event="verdict", checks=checks, problems=problems,
     ok=all(checks.values()))
sys.exit(0 if all(checks.values()) else 1)
