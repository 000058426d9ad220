"""Chaos variant of the on-chip soak: the 1024-channel receiver 'dies'
mid-stream (injected failure on the 3rd block) and is rebuilt by
ResilientReceiver from its last snapshot; all 112 events must STILL
detect and decode bit-exact on the device."""
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
from amps_tpu.runtime.resilient import ResilientReceiver
from amps_tpu.runtime.streamer import MultichannelReceiver
from amps_tpu.tx import recc_ms

OUT = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "soak_chaos_tpu.out"), "a", buffering=1)
def emit(**kw):
    OUT.write(json.dumps(kw) + "\n"); print(kw, flush=True)

spec = MultichannelSpec(num_channels=1024, taps_per_phase=8, fold="bank",
                        io_bf16=True, corr_bf16=True)
P = spec.chz_spec.hop
total_hops = 32768
emit(event="start", device=str(jax.devices()[0]), M=1024,
     total_hops=total_hops, mode="chaos: kill block 3, recover, replay")

events = random_events(112, spec, total_hops, seed=11)
pipe = spec.pipe
sens = 2 * np.pi * pipe.deviation_hz / pipe.chan_rate
Y = jnp.zeros((total_hops, spec.num_channels, 2), jnp.float32)
for ev in events:
    syms = recc_ms.burst_symbols(ev.words(), dcc=0, sps=spec.chan_sps)
    bb, _ = fm_modulate_symbols(syms.astype(np.int8), sens)
    n = min(int(np.asarray(bb).shape[0]), total_hops - ev.start_hop)
    Y = Y.at[ev.start_hop: ev.start_hop + n, ev.channel].set(
        jnp.asarray(bb)[:n])
x, _ = chz.synthesize(Y, spec.chz_spec, chz.synthesizer_init(spec.chz_spec))
x = x + 0.02 * jax.random.normal(jax.random.PRNGKey(1), x.shape, jnp.float32)
x.block_until_ready()
emit(event="synthesized", n_events=len(events))

res = ResilientReceiver(
    lambda: MultichannelReceiver(spec, threshold=0.6, max_bursts=6,
                                 min_rssi=0.05),
    checkpoint_blocks=1)
state = {"n": 0}
orig = MultichannelReceiver.push
def flaky(self, b):
    state["n"] += 1
    if state["n"] == 3:
        raise RuntimeError("injected device loss at block 3")
    return orig(self, b)
MultichannelReceiver.push = flaky

reports, off, blk = [], 0, 1 << 22
t0 = time.perf_counter()
while off < int(x.shape[0]):
    end = min(off + blk, int(x.shape[0]))
    end -= (end - off) % P
    if end <= off:
        break
    reports += res.push(x[off:end])
    off = end
MultichannelReceiver.push = orig
dt = time.perf_counter() - t0

by_key = {}
for r in reports:
    by_key.setdefault(r.channel, []).append(r)
found, exact = 0, 0
for ev in events:
    cands = by_key.get(ev.channel, [])
    if not cands:
        continue
    found += 1
    want = np.stack(ev.words())
    got = min(cands, key=lambda r: abs(r.abs_symbol - ev.start_hop // 3))
    nw = want.shape[0]
    if (np.asarray(got.word_ok)[:nw].all()
            and np.array_equal(np.asarray(got.words)[:nw], want)):
        exact += 1
emit(event="done", n_events=len(events), n_reports=len(reports),
     recoveries=res.recoveries, found=found, exact=exact,
     wall_s=round(dt, 2))
