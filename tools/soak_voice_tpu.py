"""ON-CHIP voice/supervision soak (VERDICT r2 item 8): every previous
chip soak was RECC-only; this one drives the VOICE path — SAT + ST
supervisory tones and NBFM voice through the 1024-channel analysis
bank on the device — and runs a full supervised call timeline off the
measured levels: ringing (ST) -> answer (ST removal) -> conversation ->
intra-station handoff (SAT moves to the new channel, supervision
resumes) -> deep fade -> fade-timeout release (553 §2.4.2/§2.7.2).

Supervision timers are compressed (fade 1.0 s, ST release 0.6 s) so the
timeline fits ~3.4 s of 1024-channel wideband; the measurement math
(rx/voice.supervision_levels: framed ST + 120 ms coherent SAT windows,
two matmuls) runs with the exact bench dtypes — the class of chip-only
numeric trap this soak exists to catch (cf. the BCH precision bug).
"""
import os
import json, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
from amps_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
import jax.numpy as jnp

from amps_tpu.control.station import BaseStation
from amps_tpu.control.supervision import ALERTING
from amps_tpu.dsp import channelizer as chz
from amps_tpu.dsp.fm import fm_modulate
from amps_tpu.parallel.pipeline import MultichannelSpec
from amps_tpu.runtime.streamer import MultichannelReceiver

OUT = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "soak_voice_tpu.out"), "a", buffering=1)
def emit(**kw):
    OUT.write(json.dumps(kw) + "\n"); print(kw, flush=True)

spec = MultichannelSpec(num_channels=1024, taps_per_phase=8, fold="bank",
                        io_bf16=True, corr_bf16=True)
M = spec.num_channels
P = spec.chz_spec.hop
pipe = spec.pipe
fs = float(pipe.chan_rate)
sens = 2.0 * np.pi * pipe.deviation_hz / fs
SLOT_A, SLOT_B = 400, 500      # reverse voice channels (RVC transponder)
DUR = 3.4
n = int(DUR * fs)
n -= n % P
t = np.arange(n) / fs

# --- the mobile's transponded RVC signal ----------------------------------
# amplitudes in modulating units (receiver divides demod by sens):
SAT_AMP, ST_AMP = 0.05, 0.05
sat = SAT_AMP * np.cos(2 * np.pi * 6000.0 * t)          # SCC=1 -> 6000 Hz
st = ST_AMP * np.cos(2 * np.pi * 10000.0 * t)
voice = 0.3 * np.cos(2 * np.pi * 1000.0 * t)
T_ANSWER, T_HANDOFF, T_RETUNE, T_FADE = 0.6, 1.4, 1.45, 2.2
m_a = np.where(t < T_ANSWER, sat + st,                   # ringing
               np.where(t < T_HANDOFF, sat + voice, 0.0))  # conversation
m_b = np.where((t >= T_RETUNE) & (t < T_FADE), sat + voice, 0.0)
GATES = dict(fade_timeout_s=1.0, st_release_s=0.6,
             max_power=2.0, st_guard_ratio=2.0, carrier_guard_max=0.04,
             spec=dict(io_bf16=spec.io_bf16, corr_bf16=spec.corr_bf16,
                       max_trigger_errors=spec.max_trigger_errors,
                       repeat_gate=spec.repeat_gate))
emit(event="start", device=str(jax.devices()[0]), M=M, dur_s=DUR,
     slots=[SLOT_A, SLOT_B], gates=GATES,
     timeline={"answer": T_ANSWER, "handoff": T_HANDOFF,
               "retune": T_RETUNE, "fade": T_FADE})

Y = np.zeros((n, M, 2), np.float32)
iq_a, _ = fm_modulate(jnp.asarray(m_a, jnp.float32), sens)
iq_b, _ = fm_modulate(jnp.asarray(m_b, jnp.float32), sens)
Y[:, SLOT_A] = np.asarray(iq_a)
# carrier off outside B's active window (mobile not yet retuned)
act_b = ((t >= T_RETUNE) & (t < T_FADE)).astype(np.float32)[:, None]
Y[:, SLOT_B] = np.asarray(iq_b) * act_b
x, _ = chz.synthesize(jnp.asarray(Y), spec.chz_spec,
                      chz.synthesizer_init(spec.chz_spec))
x = x + 0.005 * jax.random.normal(jax.random.PRNGKey(7), x.shape,
                                  jnp.float32)
del Y
x.block_until_ready()
emit(event="synthesized", samples=int(x.shape[0]))

# --- station + supervised receiver ----------------------------------------
import dataclasses as _dc
station = BaseStation(sps=spec.chan_sps)
station.supervision_config = _dc.replace(
    station.supervision_config, fade_timeout_s=1.0, st_release_s=0.6)
events = []
station._on_event = lambda ev: events.append((ev.kind, ev.payload))
station._start_supervision(SLOT_A, ALERTING)   # begin_alert inside

levels_log = []


def on_sup(slot, lv, pw):
    levels_log.append((slot, np.asarray(lv), np.asarray(pw)))
    station.push_supervision(slot, lv, pw)


rx = MultichannelReceiver(spec, max_bursts=2, threshold=0.55,
                          supervision_slots=(SLOT_A, SLOT_B),
                          on_supervision=on_sup)
BLOCK = 8192 * P
t0 = time.perf_counter()
done_handoff = False
for off in range(0, n * P, BLOCK):
    rx.push(x[off: off + BLOCK])
    t_now = (off + BLOCK) / P / fs
    if not done_handoff and t_now >= T_HANDOFF:
        ok = station.handoff(SLOT_A, SLOT_B)
        emit(event="handoff_cmd", t=round(t_now, 2), accepted=bool(ok))
        done_handoff = True
rx.flush()
emit(event="streamed", wall_s=round(time.perf_counter() - t0, 2),
     blocks=n * P // BLOCK)

# --- assertions ------------------------------------------------------------
kinds = [k for k, _ in events]
sup_events = [p for k, p in events if k == "supervision_event"]
timeline = [(e.kind, e.channel, round(e.t, 2)) for e in sup_events]
emit(event="timeline", events=timeline,
     station_kinds=sorted(set(kinds)))

# measured level sanity on a conversation frame of slot A
lv_a = [lv for slot, lv, pw in levels_log if slot == SLOT_A]
lv_a = np.concatenate(lv_a, axis=0)          # (F, 4)
frames_conv = lv_a[70:130]                   # ~0.7-1.3 s: SAT+voice
sat_meas = float(np.median(frames_conv[:, 1]))
emit(event="levels", sat_measured=round(sat_meas, 4), sat_tx=SAT_AMP,
     sat_err_pct=round(100 * abs(sat_meas - SAT_AMP) / SAT_AMP, 1))

# ---- exact-timeline verdict (VERDICT r3 item 4): the soak FAILS on
# ANY supervision event outside the expected list — a spurious flash /
# answer / sat flicker on a dead carrier is a regression, not noise.
# Event times are relative to each supervisor's start; supervisor B
# starts at the handoff command (the first block boundary >= T_HANDOFF).
blk_s = BLOCK / P / fs
t_handoff_cmd = -(-T_HANDOFF // blk_s) * blk_s
expected = [
    ("answer", SLOT_A, T_ANSWER, 0.15),
    # mobile leaves A at T_HANDOFF (unmodulated carrier: SAT gone)
    ("sat_lost", SLOT_A, T_HANDOFF, 0.15),
    ("sat_lost", SLOT_B, T_FADE - t_handoff_cmd, 0.15),
    ("release", SLOT_B, T_FADE - t_handoff_cmd + GATES["fade_timeout_s"],
     0.15),
]
problems = []
if len(timeline) != len(expected):
    problems.append(f"expected {len(expected)} events, got {len(timeline)}")
for got, exp in zip(timeline, expected):
    kind, chan, t_exp, tol = exp
    if got[0] != kind or got[1] != chan or abs(got[2] - t_exp) > tol:
        problems.append(f"expected {exp}, got {got}")
checks = {
    "timeline_exact_zero_unexpected": not problems,
    "handoff_event": ("handoff", (SLOT_A, SLOT_B)) in
                     [(k, p) for k, p in events if k == "handoff"],
    "no_release_on_A_before_handoff": not any(
        k == "release" and c == SLOT_A for k, c, _ in timeline),
    "sat_level_within_10pct": abs(sat_meas - SAT_AMP) / SAT_AMP < 0.10,
    "call_torn_down": SLOT_A not in station.supervisors
                      and SLOT_B not in station.supervisors,
}
emit(event="verdict", checks=checks, problems=problems,
     ok=all(checks.values()))
sys.exit(0 if all(checks.values()) else 1)
