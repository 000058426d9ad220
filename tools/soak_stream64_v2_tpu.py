"""64-block streaming soak ON CHIP, v2 (VERDICT r2 item 1).

The stream64 workload — seed 41, 150 events,
identical rng draw order (dcc/cfo/fd/Rayleigh per event), 2048-hop
blocks, checkpoint->fresh receiver->restore at block 32 — re-run after
the stream64 triage fix (correlator.trigger_errors: post-capture
trigger verification, the memmem exactness of lib/recc_impl.cc:118).

The band grid is built host-side (numpy) and shipped once, and
exactly-once accounting attributes each report by WORD IDENTITY before
position-checking (window arithmetic alone mis-associates same-channel
neighbors).

Pass bar (unchanged, now honestly measurable): every event reported
EXACTLY once, decoded bit-exact with correct DCC; zero duplicates,
zero ghosts, zero word_ok=True wrong-word deliveries.
"""
import os
import json, sys, tempfile, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp
from amps_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()

from amps_tpu.dsp import channelizer as chz
from amps_tpu.dsp.fm import fm_modulate_symbols
from amps_tpu.eval import channel as chanimp
from amps_tpu.eval.traffic import random_events
from amps_tpu.parallel.pipeline import MultichannelSpec
from amps_tpu.runtime.state import load_receiver, save_receiver
from amps_tpu.runtime.streamer import MultichannelReceiver
from amps_tpu.tx import recc_ms

OUT = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "soak_stream64_v2_tpu.out"), "a", buffering=1)
def emit(**kw):
    OUT.write(json.dumps(kw) + "\n"); print(kw, flush=True)

spec = MultichannelSpec(num_channels=1024, taps_per_phase=8, fold="bank",
                        io_bf16=True, corr_bf16=True)
P = spec.chz_spec.hop
BLOCK_HOPS = 2048
NBLOCKS = 64
total_hops = BLOCK_HOPS * NBLOCKS
rng = np.random.default_rng(41)
events = random_events(150, spec, total_hops, seed=41)
MIN_RSSI = 0.05
# the ACTIVE gate configuration, echoed so every run's artifact is
# self-describing (VERDICT r3 item 5: the v2 artifact's run 1 predated
# the rssi/repeat gates and that was only recorded in ROADMAP prose)
GATES = dict(max_trigger_errors=spec.max_trigger_errors,
             repeat_gate=spec.repeat_gate, min_rssi=MIN_RSSI,
             require_word_a=True, policy="majority", threshold=0.55,
             io_bf16=spec.io_bf16, corr_bf16=spec.corr_bf16,
             transform_bf16=spec.transform_bf16)
emit(event="start", device=str(jax.devices()[0]), M=1024,
     blocks=NBLOCKS, block_hops=BLOCK_HOPS, n_events=len(events),
     gates=GATES,
     mode="stream64 v2: CFO +-2.1kHz, Rayleigh fd 2-80Hz, random DCC, "
          "noise, checkpoint/restore at block 32")

pipe = spec.pipe
fs = float(pipe.chan_rate)
sens = 2 * np.pi * pipe.deviation_hz / fs
Y = np.zeros((total_hops, spec.num_channels, 2), np.float32)
meta = []
for ev in events:
    dcc = int(rng.integers(0, 4))
    syms = recc_ms.burst_symbols(ev.words(), dcc=dcc, sps=spec.chan_sps)
    bb, _ = fm_modulate_symbols(syms.astype(np.int8), sens)
    bb = np.asarray(bb)
    cfo = float(rng.uniform(-2100.0, 2100.0))
    ph = 2 * np.pi * cfo * np.arange(len(bb)) / fs
    c, s = np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)
    bb = np.stack([bb[:, 0] * c - bb[:, 1] * s,
                   bb[:, 0] * s + bb[:, 1] * c], -1)
    fd = float(rng.uniform(2.0, 80.0))
    bb = np.asarray(chanimp.apply_gain(
        bb, chanimp.rayleigh_gain(len(bb), fs, fd, rng)), np.float32)
    n = min(len(bb), total_hops - ev.start_hop)
    Y[ev.start_hop: ev.start_hop + n, ev.channel] = bb[:n]
    meta.append((ev, dcc, cfo, fd))
t0 = time.perf_counter()
x, _ = chz.synthesize(jnp.asarray(Y), spec.chz_spec,
                      chz.synthesizer_init(spec.chz_spec))
x = x + 0.01 * jax.random.normal(jax.random.PRNGKey(2), x.shape, jnp.float32)
del Y
x.block_until_ready()
emit(event="synthesized", samples=int(x.shape[0]),
     synth_s=round(time.perf_counter() - t0, 1))


def make_rx():
    # min_rssi 0.05: rssi is now measured per burst over the candidate's
    # own capture extent, so real deep-fade bursts still average near
    # their fade-mean (~0.5+) while bf16-leakage FM-capture ghosts sit
    # at the ~0.02 leakage floor
    return MultichannelReceiver(spec, threshold=0.55, max_bursts=6,
                                min_rssi=MIN_RSSI)


CKPT = os.path.join(tempfile.gettempdir(), "stream64v2_ckpt.npz")
rx = make_rx()
reports = []
t0 = time.perf_counter()
for b in range(NBLOCKS):
    if b == 32:
        save_receiver(CKPT, rx)
        rx = make_rx()
        load_receiver(CKPT, rx)
        emit(event="checkpoint_restore", block=b)
    reports += rx.push(x[b * BLOCK_HOPS * P:(b + 1) * BLOCK_HOPS * P])
reports += rx.flush(pad_tail=True)
dt = time.perf_counter() - t0
emit(event="streamed", wall_s=round(dt, 2), n_reports=len(reports))

# ---- exactly-once accounting by word identity -----------------------------
burst_syms = 10432 // 3
matched = {i: [] for i in range(len(meta))}
ghosts, misdecodes = [], []
for j, r in enumerate(reports):
    got = np.asarray(r.words)
    hit = None
    for i, (ev, dcc, cfo, fd) in enumerate(meta):
        w = np.stack(ev.words())
        nw = w.shape[0]
        if ev.channel == r.channel and \
                np.asarray(r.word_ok)[:nw].all() and \
                all(np.array_equal(got[t], w[t]) for t in range(nw)) and \
                abs(r.abs_symbol - ev.start_hop // 3) < burst_syms:
            hit = i
            break
    if hit is None:
        rec = {"j": j, "chan": int(r.channel), "abs_sym": int(r.abs_symbol),
               "quality": round(float(r.quality), 3),
               "rssi": round(float(r.rssi), 3),
               "ok": np.asarray(r.word_ok).astype(int).tolist(),
               "bad": np.asarray(r.bad_symbols).astype(int).tolist()}
        near = [i for i, (ev, d, c2, f2) in enumerate(meta)
                if ev.channel == r.channel
                and abs(r.abs_symbol - ev.start_hop // 3) < burst_syms]
        (misdecodes if near else ghosts).append(
            dict(rec, near_event=near[0] if near else None))
    else:
        matched[hit].append(j)

lost = [i for i, js in matched.items() if not js]
dups = {i: js for i, js in matched.items() if len(js) > 1}
dcc_ok = sum(1 for i, js in matched.items()
             if js and reports[js[0]].dcc == meta[i][1])
emit(event="done", n_events=len(meta), n_reports=len(reports),
     exact=sum(1 for js in matched.values() if js), dcc_ok=dcc_ok,
     lost=[{"i": i, "kind": meta[i][0].kind,
            "chan": int(meta[i][0].channel),
            "hop": int(meta[i][0].start_hop),
            "cfo": round(meta[i][2]), "fd": round(meta[i][3], 1)}
           for i in lost],
     duplicates={str(i): js for i, js in dups.items()},
     misdecodes=misdecodes, ghosts=ghosts, wall_s=round(dt, 2))
ok = (not lost) and (not dups) and (not misdecodes) and (not ghosts)
emit(event="verdict", exactly_once=bool(ok))
