"""Measured multi-device datapoint on the virtual CPU mesh (VERDICT r1
'what's weak': one measured, not modeled, step-time-vs-devices number).

IMPORTANT CONTEXT: this host has TWO physical cores, so the 8 virtual
XLA:CPU devices cannot show wall-clock SPEEDUP — every mesh shape
timeshares the same 2 cores.  What the measurement DOES bound is the
sharding OVERHEAD: the same total workload through the sharded step
(halos, all_gather, per-row all_to_all, resharded decode) vs the
unsharded single-device block.  On real multi-chip hardware the compute
divides by N while this overhead term is what scaling efficiency pays
(docs/SCALING.md model); here we observe it directly at N=1..8 with
zero hardware parallelism available.
"""
import os
import json, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from amps_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
import jax.numpy as jnp

from amps_tpu.parallel.mesh import make_mesh, MeshSpec
from amps_tpu.parallel.pipeline import (MultichannelSpec, full_demod_halo,
                                        make_sharded_rx_stream_step,
                                        rx_multichannel_block,
                                        sharded_stream_state)
from amps_tpu.eval.traffic import random_events, synthesize_reverse_band

OUT = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "scaling_measure_cpu.out"), "a", buffering=1)
def emit(**kw):
    OUT.write(json.dumps(kw) + "\n"); print(kw, flush=True)

spec = MultichannelSpec(num_channels=8, taps_per_phase=4)
halo = full_demod_halo(spec)
total_hops = 99840
events = random_events(10, spec, total_hops, seed=3, channels=range(8))
x = synthesize_reverse_band(events, spec, total_hops, noise_sigma=0.001)
xj = jnp.asarray(x)
emit(event="start", host_cores=os.cpu_count(), M=8,
     total_hops=total_hops, halo=halo)


def timeit(fn, *args, iters=8):
    r = fn(*args)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn(*args)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / iters


t1 = timeit(lambda a: rx_multichannel_block(a, spec, max_bursts=4,
                                            threshold=0.55)["quality"], xj)
emit(mesh="unsharded(1)", step_ms=round(t1 * 1e3, 1))
for t, c in ((2, 1), (4, 1), (8, 1), (4, 2), (2, 4), (1, 8)):
    mesh = make_mesh(MeshSpec(time=t, chan=c), jax.devices()[: t * c])
    step = make_sharded_rx_stream_step(mesh, spec, halo, max_bursts=4,
                                       threshold=0.55)
    st = sharded_stream_state(spec, halo)
    tm = timeit(lambda a: step(a, st)[0]["quality"], xj)
    emit(mesh=f"({t}x{c})", devices=t * c, step_ms=round(tm * 1e3, 1),
         overhead_vs_unsharded=round(tm / t1, 3))
emit(event="done")
