"""ON-CHIP 16-call capacity soak (VERDICT r4 item 8): SIXTEEN
concurrent supervised calls on the 1024-channel bank at bench dtypes,
per-channel call control (BaseStation(per_channel_fvc=True)), staggered
lifecycles on a wide voice plan (355-370):

  355-358 (slots 60-252):  ring -> answer 0.6/0.8/1.0/1.2 -> talk ->
                           hang-up ST at 1.8/2.0/2.2/2.4
  359-365 (slots 316-700): conversation from 0 -> hang-up ST 1.9..3.1
  366     (slot 764):      ring -> answer 0.9 -> talk -> deep fade 2.8
  367-370 (slots 828-1016):conversation from 0 -> talk past every other
                           call's teardown (operator release at end)

All sixteen supervisors run simultaneously over the sharded-equivalent
single-device bank; the voice band is assembled ON DEVICE (host
uploads only the 1 MB/call modulating signals).  Verdict: the supervision event timeline must match
EXACTLY (zero unexpected events, zero cross-call leakage), every
hang-up releases with the ST reason, the fade with the fade reason,
and the four long calls survive to the operator release.  Host
control-plane cost per supervised call is measured and recorded for
docs/OPERATIONS.md.  Reference capacity: ONE call's signaling at a
time (single shared fvc block, lib/fvc_impl.cc).
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

OUT = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "soak_multicall16_tpu.out"), "a", buffering=1)


def emit(**kw):
    OUT.write(json.dumps(kw) + "\n")
    print(kw, flush=True)


M = 1024
spec = MultichannelSpec(num_channels=M, taps_per_phase=8, fold="bank",
                        io_bf16=True, corr_bf16=True)
P = spec.chz_spec.hop
pipe = spec.pipe
fs = float(pipe.chan_rate)
sens = 2.0 * np.pi * pipe.deviation_hz / fs
DUR = 4.4
n = int(DUR * fs)
n -= n % 2
t = np.arange(n) / fs
SAT_AMP, ST_AMP = 0.05, 0.05
FADE_TO, ST_REL = 0.6, 0.5

# (chan, slot, start_state, t_answer|None, t_hang|None, t_fade|None)
CALLS = (
    [(355 + i, 60 + 64 * i, ALERTING, 0.6 + 0.2 * i, 1.8 + 0.2 * i, None)
     for i in range(4)]
    + [(359 + i, 316 + 64 * i, CONVERSATION, None, 1.9 + 0.2 * i, None)
       for i in range(7)]
    + [(366, 764, ALERTING, 0.9, None, 2.8)]
    + [(367 + i, 828 + 64 * i, CONVERSATION, None, None, None)
       for i in range(4)]
)
assert len(CALLS) == 16
LONG = [c for c, _, _, ta, th, tf in CALLS if th is None and tf is None]
emit(event="start", device=str(jax.devices()[0]), M=M, dur_s=DUR,
     calls=[(c, s, st, ta, th, tf) for c, s, st, ta, th, tf in CALLS],
     gates=dict(fade_timeout_s=FADE_TO, st_release_s=ST_REL,
                per_channel_fvc=True))


def call_mod(t_ans, t_hang, t_fade, seed=0):
    """Deviation-normalized modulating signal for one call timeline.

    Every mobile transponds the SAME 6 kHz SAT, but with ITS OWN phase
    (path delay) — run 1 of this soak gave every call the same phase
    and the 15 live calls' bf16-leakage copies added COHERENTLY
    (+23.5 dB over a single leaker) onto the faded slot, fluttering its
    carrier gate; with realistic random phases the leakage sums
    incoherently (~-28 dB) and stays far under every gate.  Voice tones
    are likewise detuned per call."""
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, 3)
    f_voice = 1000.0 + rng.uniform(-150.0, 150.0)
    sat = SAT_AMP * np.cos(2 * np.pi * 6000.0 * t + ph[0])   # SCC=1
    st_tone = ST_AMP * np.cos(2 * np.pi * 10_000.0 * t + ph[1])
    voice = 0.3 * np.cos(2 * np.pi * f_voice * t + ph[2])
    ringing = (t < t_ans) if t_ans is not None else np.zeros_like(t, bool)
    m = sat + np.where(ringing, st_tone, voice)
    active = np.ones_like(t, bool)
    if t_hang is not None:
        st_run = (t >= t_hang) & (t < t_hang + ST_REL + 0.2)
        m = np.where(st_run, sat + st_tone, m)
        active &= t < t_hang + ST_REL + 0.2
    if t_fade is not None:
        active &= t < t_fade
    return m.astype(np.float32), active.astype(np.float32)


# device-side band assembly: upload only the (n,) modulating signals
Y = jnp.zeros((n, M, 2), jnp.float32)
for chan, slot, st0, t_ans, t_hang, t_fade in CALLS:
    m, act = call_mod(t_ans, t_hang, t_fade, seed=chan)
    iq = fm_modulate(jnp.asarray(m), sens)[0] * jnp.asarray(act)[:, None]
    Y = Y.at[:, slot].set(iq)
x, _ = chz.synthesize(Y, spec.chz_spec, chz.synthesizer_init(spec.chz_spec))
del Y
x = x + 0.005 * jax.random.normal(jax.random.PRNGKey(7), x.shape,
                                  jnp.float32)
x = jax.block_until_ready(x)
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
assert len(station.supervisors) == 16

cost = {"s": 0.0, "calls": 0, "max": 0.0, "over_1ms": 0}


def on_sup(slot, lv, pw):
    t0 = time.perf_counter()
    station.push_supervision(slot_map[slot], lv, pw)
    dt = time.perf_counter() - t0
    cost["s"] += dt
    cost["calls"] += 1
    cost["max"] = max(cost["max"], dt)
    cost["over_1ms"] += dt > 1e-3


rx = MultichannelReceiver(
    spec, max_bursts=2, threshold=0.55, min_rssi=0.05,
    supervision_slots=tuple(sorted(slot_map)), on_supervision=on_sup)
BLOCK = 8192 * P
t0 = time.perf_counter()
for off in range(0, n * P, BLOCK):
    rx.push(x[off: off + BLOCK])
rx.flush()
wall = time.perf_counter() - t0
emit(event="streamed", wall_s=round(wall, 2), blocks=-(-n * P // BLOCK),
     realtime_factor=round(DUR / wall, 2))
emit(event="host_cost",
     push_supervision_total_s=round(cost["s"], 4),
     push_supervision_calls=cost["calls"],
     push_supervision_us_per_call_block=round(
         cost["s"] / max(cost["calls"], 1) * 1e6, 1),
     push_supervision_max_ms=round(cost["max"] * 1e3, 1),
     calls_over_1ms=cost["over_1ms"],
     host_share_of_wall=round(cost["s"] / wall, 4))

sup = [p for k, p in events if k == "supervision_event"]
timeline = [(e.kind, e.channel, round(e.t, 2)) for e in sup]
emit(event="timeline", events=timeline)

checks = {"long_calls_survived": all(
    c in station.supervisors
    and station.supervisors[c].state == CONVERSATION for c in LONG)}
for c in LONG:
    station.release_call(c, "operator")

expected = []
for chan, slot, st0, t_ans, t_hang, t_fade in CALLS:
    if t_ans is not None and (t_fade is None or t_ans < t_fade):
        expected.append(("answer", chan, t_ans, 0.15))
    if t_hang is not None:
        expected.append(("release", chan, t_hang + ST_REL, 0.15))
        expected.append(("sat_lost", chan, t_hang + ST_REL + 0.2, 0.25))
    if t_fade is not None:
        expected.append(("sat_lost", chan, t_fade, 0.15))
        expected.append(("release", chan, t_fade + FADE_TO, 0.15))
for c in LONG:
    # end of stream: the flush block is trailing silence
    expected.append(("sat_lost", c, DUR, 0.5))

problems = []
got = list(timeline)
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
    "st_releases": all("ST" in rel_reasons.get(c, "")
                       for c, _, _, _, th, _ in CALLS if th is not None),
    "fade_release_366": "fade" in rel_reasons.get(366, ""),
    "all_torn_down": not station.supervisors,
    "sixteen_concurrent": True,   # asserted above before streaming
})
emit(event="verdict", checks=checks, problems=problems,
     ok=all(checks.values()))
sys.exit(0 if all(checks.values()) else 1)
