"""Virtual-mesh voice/supervision timeline soak (VERDICT r3 item 2):
the SHARDED receiver's SAT/ST supervision path — device-side slot tap
(one-hot + psum inside shard_map, parallel/pipeline.py) + host framing —
drives a full supervised call timeline on the 8-device CPU mesh:
ringing (ST) -> answer (ST removal) -> intra-station handoff (SAT moves
to the new channel) -> deep fade -> fade-timeout release
(553 §2.4.2/§2.7.2).

Event discipline (VERDICT r3 item 4): the verdict FAILS on ANY
supervision event outside the expected timeline — spurious flash /
answer / release events are regressions, not noise.

Run: python tools/soak_sharded_voice_cpu.py   (forces CPU, 8 devices)
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
from amps_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
import jax.numpy as jnp  # noqa: E402

import dataclasses  # noqa: E402
import time  # noqa: E402

from amps_tpu.control.station import BaseStation  # noqa: E402
from amps_tpu.control.supervision import ALERTING  # noqa: E402
from amps_tpu.dsp import channelizer as chz  # noqa: E402
from amps_tpu.dsp.fm import fm_modulate  # noqa: E402
from amps_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa: E402
from amps_tpu.parallel.pipeline import MultichannelSpec  # noqa: E402
from amps_tpu.parallel.stream import ShardedReceiver  # noqa: E402

OUT = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "soak_sharded_voice_cpu.out"), "a", buffering=1)


def emit(**kw):
    OUT.write(json.dumps(kw) + "\n")
    print(kw, flush=True)


spec = MultichannelSpec(num_channels=64, taps_per_phase=8)
M = spec.num_channels
P = spec.chz_spec.hop
pipe = spec.pipe
fs = float(pipe.chan_rate)
sens = 2.0 * np.pi * pipe.deviation_hz / fs
SLOT_A, SLOT_B = 20, 40
TSIZE, CSIZE = 4, 2
NH_ROW = 10352                       # >= full demod halo + slack
BLOCK_HOPS = TSIZE * NH_ROW          # 41408 hops = 0.69 s
NBLOCKS = 5
n = NBLOCKS * BLOCK_HOPS
t = np.arange(n) / fs

SAT_AMP, ST_AMP = 0.05, 0.05
sat = SAT_AMP * np.cos(2 * np.pi * 6000.0 * t)          # SCC=1
st = ST_AMP * np.cos(2 * np.pi * 10000.0 * t)
voice = 0.3 * np.cos(2 * np.pi * 1000.0 * t)
T_ANSWER, T_HANDOFF, T_RETUNE, T_FADE = 0.6, 1.4, 1.45, 2.2
m_a = np.where(t < T_ANSWER, sat + st,
               np.where(t < T_HANDOFF, sat + voice, 0.0))
m_b = np.where((t >= T_RETUNE) & (t < T_FADE), sat + voice, 0.0)

GATES = dict(fade_timeout_s=1.0, st_release_s=0.6,
             max_trigger_errors=spec.max_trigger_errors,
             repeat_gate=spec.repeat_gate,
             st_guard_ratio=2.0)
emit(event="start", device=str(jax.devices()[0]), n_devices=len(jax.devices()),
     mesh=[TSIZE, CSIZE], M=M, blocks=NBLOCKS, block_hops=BLOCK_HOPS,
     slots=[SLOT_A, SLOT_B], gates=GATES,
     timeline={"answer": T_ANSWER, "handoff": T_HANDOFF,
               "retune": T_RETUNE, "fade": T_FADE})

Y = np.zeros((n, M, 2), np.float32)
iq_a = np.array(fm_modulate(jnp.asarray(m_a, jnp.float32), sens)[0])
iq_b = np.array(fm_modulate(jnp.asarray(m_b, jnp.float32), sens)[0])
iq_a[t >= T_HANDOFF] = 0.0           # mobile leaves channel A
act_b = ((t >= T_RETUNE) & (t < T_FADE)).astype(np.float32)[:, None]
Y[:, SLOT_A] = iq_a
Y[:, SLOT_B] = iq_b * act_b
x, _ = chz.synthesize(jnp.asarray(Y), spec.chz_spec,
                      chz.synthesizer_init(spec.chz_spec))
x = np.asarray(x) + 0.005 * np.random.default_rng(7).normal(
    0, 1, (n * P, 2)).astype(np.float32)
del Y
emit(event="synthesized", samples=int(x.shape[0]))

station = BaseStation(sps=spec.chan_sps)
station.supervision_config = dataclasses.replace(
    station.supervision_config, fade_timeout_s=GATES["fade_timeout_s"],
    st_release_s=GATES["st_release_s"])
events = []
station._on_event = lambda ev: events.append((ev.kind, ev.payload))
station._start_supervision(SLOT_A, ALERTING)

mesh = make_mesh(MeshSpec(time=TSIZE, chan=CSIZE), jax.devices()[:8])
rx = ShardedReceiver(
    mesh, spec, max_bursts=2, threshold=0.55,
    supervision_slots=(SLOT_A, SLOT_B),
    on_supervision=lambda slot, lv, pw: station.push_supervision(
        slot, lv, pw))

t0 = time.perf_counter()
done_handoff = False
for b in range(NBLOCKS):
    rx.push(x[b * BLOCK_HOPS * P:(b + 1) * BLOCK_HOPS * P])
    t_now = (b + 1) * BLOCK_HOPS / fs
    if not done_handoff and t_now >= T_HANDOFF:
        ok = station.handoff(SLOT_A, SLOT_B)
        emit(event="handoff_cmd", t=round(t_now, 2), accepted=bool(ok))
        done_handoff = True
rx.flush()
emit(event="streamed", wall_s=round(time.perf_counter() - t0, 2),
     blocks=NBLOCKS)

sup_events = [p for k, p in events if k == "supervision_event"]
timeline = [(e.kind, e.channel, round(e.t, 2)) for e in sup_events]
emit(event="timeline", events=timeline,
     station_kinds=sorted({k for k, _ in events}))

# ---- verdict: the timeline must match EXACTLY (item 4 discipline) ----
# Event times are relative to each supervisor's start.  Expected, in
# order: answer on A at the ST drop; sat_lost on A when the mobile
# leaves at T_HANDOFF (the handoff command lands at the next block
# boundary, before A's fade timeout); on B (supervisor starts at the
# handoff command = end of block 3): sat_lost at the fade, release one
# fade timeout later.  The flush block appends trailing silence, so no
# further events may follow the release — in particular ZERO
# flash/answer/sat_back flickers on the dead carriers (the guard-bin
# carrier gate; the channelized dead carrier slips the power squelch).
t_handoff_cmd = 3 * BLOCK_HOPS / fs
expected = [
    ("answer", SLOT_A, T_ANSWER, 0.15),
    ("sat_lost", SLOT_A, T_HANDOFF, 0.15),
    ("sat_lost", SLOT_B, T_FADE - t_handoff_cmd, 0.15),
    ("release", SLOT_B,
     T_FADE - t_handoff_cmd + GATES["fade_timeout_s"], 0.15),
]
problems = []
if len(timeline) != len(expected):
    problems.append(f"expected {len(expected)} events, got {len(timeline)}")
for got, exp in zip(timeline, expected):
    kind, chan, tol_t, tol = exp
    if got[0] != kind or got[1] != chan or abs(got[2] - tol_t) > tol:
        problems.append(f"expected {exp}, got {got}")
checks = {
    "timeline_exact": not problems,
    "handoff_event": any(k == "handoff" and p == (SLOT_A, SLOT_B)
                         for k, p in events),
    "call_torn_down": (SLOT_A not in station.supervisors
                       and SLOT_B not in station.supervisors),
    "zero_unexpected_events": not problems,
}
emit(event="verdict", checks=checks, problems=problems,
     ok=all(checks.values()))
sys.exit(0 if all(checks.values()) else 1)
