"""Long correctness-at-scale soak on the device: a 1024-channel
reverse band carrying 420 mobile bursts is synthesized on the device
and streamed through MultichannelReceiver; every event must be detected
on its channel and decode bit-exact, at the bench-class streaming rate.
"""
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
from amps_tpu.eval.traffic import random_events
from amps_tpu.parallel.pipeline import MultichannelSpec
from amps_tpu.runtime.streamer import MultichannelReceiver
from amps_tpu.tx import recc_ms

OUT = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "soak_long_tpu.out"), "a", buffering=1)
def emit(**kw):
    OUT.write(json.dumps(kw) + "\n"); print(kw, flush=True)

spec = MultichannelSpec(num_channels=1024, taps_per_phase=8, fold="bank",
                        io_bf16=True, corr_bf16=True)
P = spec.chz_spec.hop
total_hops = 131072
emit(event="start", device=str(jax.devices()[0]), M=1024,
     total_hops=total_hops, mode="on-device synth")

events = random_events(420, spec, total_hops, seed=13)
# host builds only the tiny per-event basebands; the big (hops, M, 2)
# plane and the synthesis run on the device
pipe = spec.pipe
sens = 2 * np.pi * pipe.deviation_hz / pipe.chan_rate
t0 = time.time()
Y = jnp.zeros((total_hops, spec.num_channels, 2), jnp.float32)
for ev in events:
    syms = recc_ms.burst_symbols(ev.words(), dcc=0, sps=spec.chan_sps)
    bb, _ = fm_modulate_symbols(syms.astype(np.int8), sens)
    n = min(int(np.asarray(bb).shape[0]), total_hops - ev.start_hop)
    Y = Y.at[ev.start_hop: ev.start_hop + n, ev.channel].set(
        jnp.asarray(bb)[:n])
x, _ = chz.synthesize(Y, spec.chz_spec, chz.synthesizer_init(spec.chz_spec))
key = jax.random.PRNGKey(1)
x = x + 0.02 * jax.random.normal(key, x.shape, jnp.float32)
x.block_until_ready()
emit(event="synthesized", n_events=len(events), wideband=int(x.shape[0]),
     synth_s=round(time.time() - t0, 1))

rx = MultichannelReceiver(spec, threshold=0.6, max_bursts=6, min_rssi=0.05)
reports = []
blk = 1 << 22
t0 = time.perf_counter()
off = 0
while off < int(x.shape[0]):
    end = min(off + blk, int(x.shape[0]))
    end -= (end - off) % P
    if end <= off:
        break
    reports += rx.push(x[off:end])
    off = end
dt = time.perf_counter() - t0
by_key = {}
for r in reports:
    by_key.setdefault(r.channel, []).append(r)
found, exact, miss = 0, 0, []
for ev in events:
    cands = by_key.get(ev.channel, [])
    if not cands:
        continue
    found += 1
    want = np.stack(ev.words())
    got = min(cands, key=lambda r: abs(r.abs_symbol - ev.start_hop // 3))
    nw = want.shape[0]
    okv = np.asarray(got.word_ok)[:nw]
    rows = [bool(np.array_equal(np.asarray(got.words)[i], want[i]))
            for i in range(nw)]
    if okv.all() and all(rows):
        exact += 1
    elif len(miss) < 4:
        miss.append({"kind": ev.kind, "chan": int(ev.channel),
                     "ok": okv.tolist(), "rows": rows,
                     "q": round(float(got.quality), 3)})
emit(event="done", n_events=len(events), n_reports=len(reports),
     found=found, exact=exact, wall_s=round(dt, 2),
     streaming_msps=round(off / dt / 1e6, 1), misses=miss)
