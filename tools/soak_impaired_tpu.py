"""Impaired soak at scale ON CHIP: every burst carries a random carrier
frequency offset inside the +-2.5 ppm mobile tolerance (+-2.1 kHz),
Rayleigh fading at a random Doppler (walking..highway), a random DCC,
and band noise — the full robustness stack exercised simultaneously
across a 1024-channel band."""
import os
import json, sys, time
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
from amps_tpu.runtime.streamer import MultichannelReceiver
from amps_tpu.tx import recc_ms

OUT = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "soak_impaired_tpu.out"), "a", buffering=1)
def emit(**kw):
    OUT.write(json.dumps(kw) + "\n"); print(kw, flush=True)

spec = MultichannelSpec(num_channels=1024, taps_per_phase=8, fold="bank",
                        io_bf16=True, corr_bf16=True)
P = spec.chz_spec.hop
total_hops = 65536
rng = np.random.default_rng(23)
events = random_events(200, spec, total_hops, seed=23)
emit(event="start", device=str(jax.devices()[0]), M=1024,
     total_hops=total_hops, n_events=len(events),
     mode="impaired: CFO +-2.1kHz, Rayleigh fd 2-80Hz, random DCC, noise")

pipe = spec.pipe
fs = float(pipe.chan_rate)
sens = 2 * np.pi * pipe.deviation_hz / fs
Y = jnp.zeros((total_hops, 1024, 2), jnp.float32)
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
    bb = chanimp.apply_gain(bb, chanimp.rayleigh_gain(len(bb), fs, fd, rng))
    n = min(len(bb), total_hops - ev.start_hop)
    Y = Y.at[ev.start_hop: ev.start_hop + n, ev.channel].set(
        jnp.asarray(bb[:n]))
    meta.append((ev, dcc, cfo, fd))
x, _ = chz.synthesize(Y, spec.chz_spec, chz.synthesizer_init(spec.chz_spec))
x = x + 0.01 * jax.random.normal(jax.random.PRNGKey(2), x.shape, jnp.float32)
x.block_until_ready()
emit(event="synthesized")

rx = MultichannelReceiver(spec, threshold=0.55, max_bursts=6, min_rssi=0.02)
reports, off, blk = [], 0, 1 << 22
t0 = time.perf_counter()
while off < int(x.shape[0]):
    end = min(off + blk, int(x.shape[0])); end -= (end - off) % P
    if end <= off: break
    reports += rx.push(x[off:end]); off = end
dt = time.perf_counter() - t0

by_key = {}
for r in reports:
    by_key.setdefault(r.channel, []).append(r)
found, exact, dcc_ok, miss = 0, 0, 0, []
for ev, dcc, cfo, fd in meta:
    cands = by_key.get(ev.channel, [])
    if not cands:
        if len(miss) < 6:
            miss.append({"kind": "NODET", "chan": int(ev.channel),
                         "cfo": round(cfo), "fd": round(fd, 1)})
        continue
    found += 1
    want = np.stack(ev.words())
    got = min(cands, key=lambda r: abs(r.abs_symbol - ev.start_hop // 3))
    nw = want.shape[0]
    rows = [bool(np.array_equal(np.asarray(got.words)[i], want[i]))
            for i in range(nw)]
    if np.asarray(got.word_ok)[:nw].all() and all(rows):
        exact += 1
        if got.dcc == dcc:
            dcc_ok += 1
    elif len(miss) < 6:
        miss.append({"kind": ev.kind, "chan": int(ev.channel),
                     "cfo": round(cfo), "fd": round(fd, 1),
                     "ok": np.asarray(got.word_ok)[:nw].tolist(),
                     "rows": rows})
emit(event="done", n_events=len(events), n_reports=len(reports),
     found=found, exact=exact, dcc_ok=dcc_ok, wall_s=round(dt, 2),
     misses=miss)
