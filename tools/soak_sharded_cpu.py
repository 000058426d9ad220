"""Moderate-scale SHARDED streaming soak on the virtual 8-device CPU
mesh (VERDICT r2 item 3): M=64 channels, 24 small blocks (including a
block-length change mid-stream), 30 impaired events (CFO inside the
+-2.5 ppm mobile tolerance, Rayleigh fading, random DCC) placed to
cross row AND block boundaries, streamed through ShardedReceiver with
the end-of-stream flush.

Exactly-once accounting done properly (the lesson of the stream64
triage): each report is attributed by WORD IDENTITY to the event that
transmitted it, then position-checked — so a same-channel neighbor can
never masquerade as the expected event, and every duplicate/ghost is
classified rather than inferred from window arithmetic.
"""
import os
import json, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
from amps_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
import jax.numpy as jnp

from amps_tpu.dsp import channelizer as chz
from amps_tpu.dsp.fm import fm_modulate_symbols
from amps_tpu.eval import channel as chanimp
from amps_tpu.eval.traffic import MobileEvent, random_events
from amps_tpu.parallel.mesh import make_mesh, MeshSpec
from amps_tpu.parallel.pipeline import MultichannelSpec
from amps_tpu.parallel.stream import ShardedReceiver
from amps_tpu.tx import recc_ms

OUT = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "soak_sharded_cpu.out"), "a", buffering=1)
def emit(**kw):
    OUT.write(json.dumps(kw) + "\n"); print(kw, flush=True)

spec = MultichannelSpec(num_channels=64, taps_per_phase=8)
M, sps = 64, spec.chan_sps
P = spec.chz_spec.hop                      # 32
TSIZE, CSIZE = 2, 4
NH_ROW_A, NH_ROW_B = 10560, 13440          # two block geometries
BLOCKS_A, BLOCKS_B = 16, 8
block_hops_a, block_hops_b = TSIZE * NH_ROW_A, TSIZE * NH_ROW_B
total_hops = BLOCKS_A * block_hops_a + BLOCKS_B * block_hops_b
burst_hops = 10432

rng = np.random.default_rng(7)
events = random_events(24, spec, total_hops - 40000, seed=7,
                       channels=range(2, 60))
# deliberate boundary crossings: row boundary inside block 3, block
# boundaries 5->6 and (across the geometry change) 15->16, the final
# flush-pending tail, and a same-channel back-to-back pair
events += [
    MobileEvent("origination", 0, 3 * block_hops_a + NH_ROW_A - 5000,
                "5551234567", "7025551000", esn=1),
    MobileEvent("page_response", 1, 6 * block_hops_a - 4000, "4155559876"),
    MobileEvent("registration", 61, BLOCKS_A * block_hops_a - 5200,
                "9165554321", esn=2),
    MobileEvent("page_response", 62, total_hops - 6000, "7075550123"),
    MobileEvent("origination", 63, 50000, "5305551000", "9"*8, esn=3),
    MobileEvent("registration", 63, 50000 + burst_hops + 600,
                "5305551000", esn=4),
]
emit(event="start", M=M, mesh=[TSIZE, CSIZE],
     blocks=[BLOCKS_A, BLOCKS_B], nh_rows=[NH_ROW_A, NH_ROW_B],
     n_events=len(events), total_hops=total_hops,
     mode="CFO +-2.1kHz, Rayleigh fd 2-80Hz, random DCC, noise 0.01, "
          "variable block length, end-of-stream flush")

pipe = spec.pipe
fs = float(pipe.chan_rate)
sens = 2 * np.pi * pipe.deviation_hz / fs
Y = np.zeros((total_hops, M, 2), np.float32)
meta = []
for ev in events:
    dcc = int(rng.integers(0, 4))
    syms = recc_ms.burst_symbols(ev.words(), dcc=dcc, sps=sps)
    bb, _ = fm_modulate_symbols(syms.astype(np.int8), sens)
    bb = np.asarray(bb)
    cfo = float(rng.uniform(-2100.0, 2100.0))
    ph = 2 * np.pi * cfo * np.arange(len(bb)) / fs
    c, s = np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)
    bb = np.stack([bb[:, 0] * c - bb[:, 1] * s,
                   bb[:, 0] * s + bb[:, 1] * c], -1)
    fd = float(rng.uniform(2.0, 80.0))
    bb = np.asarray(chanimp.apply_gain(
        bb, chanimp.rayleigh_gain(len(bb), fs, fd, rng)))
    n = min(len(bb), total_hops - ev.start_hop)
    Y[ev.start_hop: ev.start_hop + n, ev.channel] += bb[:n]
    meta.append((ev, dcc, cfo, fd))
x, _ = chz.synthesize(jnp.asarray(Y), spec.chz_spec,
                      chz.synthesizer_init(spec.chz_spec))
x = np.asarray(x)
x = x + rng.normal(0, 0.01, x.shape).astype(np.float32)
del Y
emit(event="synthesized", samples=int(x.shape[0]))

mesh = make_mesh(MeshSpec(time=TSIZE, chan=CSIZE), jax.devices())
rx = ShardedReceiver(mesh, spec, threshold=0.55, max_bursts=6,
                     min_rssi=0.02)
reports = []
t0 = time.perf_counter()
off = 0
for b in range(BLOCKS_A):
    reports += rx.push(x[off: off + block_hops_a * P]); off += block_hops_a * P
for b in range(BLOCKS_B):
    reports += rx.push(x[off: off + block_hops_b * P]); off += block_hops_b * P
assert off == len(x)
reports += rx.flush()
dt = time.perf_counter() - t0
emit(event="streamed", wall_s=round(dt, 2), n_reports=len(reports))

# ---- exactly-once accounting by word identity -----------------------------
ev_sig = {}
for i, (ev, dcc, cfo, fd) in enumerate(meta):
    w = np.stack(ev.words())
    ev_sig[i] = (ev, w, dcc, cfo, fd)

matched = {i: [] for i in ev_sig}        # event -> [report idx]
ghosts, misdecodes = [], []
for j, r in enumerate(reports):
    got = np.asarray(r.words)
    hit = None
    for i, (ev, w, dcc, cfo, fd) in ev_sig.items():
        nw = w.shape[0]
        if ev.channel == r.channel and \
                np.asarray(r.word_ok)[:nw].all() and \
                all(np.array_equal(got[t], w[t]) for t in range(nw)) and \
                abs(r.abs_symbol - ev.start_hop // 3) < burst_hops // 3:
            hit = i
            break
    if hit is None:
        rec = {"j": j, "chan": int(r.channel), "abs_sym": int(r.abs_symbol),
               "quality": round(float(r.quality), 3),
               "rssi": round(float(r.rssi), 3),
               "ok": np.asarray(r.word_ok).astype(int).tolist()}
        # same-channel, right position, wrong/partial words -> misdecode
        near = [i for i, (ev, w, d, c2, f2) in ev_sig.items()
                if ev.channel == r.channel
                and abs(r.abs_symbol - ev.start_hop // 3) < burst_hops // 3]
        (misdecodes if near else ghosts).append(
            dict(rec, near_event=near[0] if near else None))
    else:
        matched[hit].append(j)

lost = [i for i, js in matched.items() if not js]
dups = {i: js for i, js in matched.items() if len(js) > 1}
dcc_ok = sum(1 for i, js in matched.items()
             if js and reports[js[0]].dcc == ev_sig[i][2])
emit(event="done", n_events=len(meta), n_reports=len(reports),
     exact=sum(1 for js in matched.values() if js),
     dcc_ok=dcc_ok, lost=[{
         "i": i, "kind": ev_sig[i][0].kind,
         "chan": int(ev_sig[i][0].channel),
         "hop": int(ev_sig[i][0].start_hop),
         "cfo": round(ev_sig[i][3]), "fd": round(ev_sig[i][4], 1)}
         for i in lost],
     duplicates={str(i): js for i, js in dups.items()},
     misdecodes=misdecodes, ghosts=ghosts, wall_s=round(dt, 2))
ok = (not lost) and (not dups) and (not misdecodes) and (not ghosts)
emit(event="verdict", exactly_once=bool(ok))
