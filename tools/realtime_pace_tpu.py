"""Wall-clock real-time pacing artifact (VERDICT r4 item 2).

The reference runs at true 400 ksps against UHD hardware pacing
(grc/ampsbs.grc:2246); BASELINE.json's north star is channels
demodulated IN REAL TIME.  Previous rounds proved 70x real-time
*throughput*; this tool converts that into the actual contract: the
full 1024-channel pipeline driven through runtime/executor.py with
input arriving at true 30.72 Msps wall-clock for >= 60 s, reporting
per-block latency (p50/p90/p99/max), arrival jitter, backlog, and
deadline misses.

Two legs:
  rx   — paced RX: an 8-block periodic reverse band (noise + 5 planted
         page-response bursts per period, one spanning a pool-block
         boundary) pre-staged in device memory (a radio ADC DMAs into
         device memory), released to the receiver on the exact
         30.72 Msps schedule.  Every planted burst must be reported
         bit-exactly, exactly once per period.
  fdx  — paced full-duplex loopback (the closed loop under pacing):
         each 92.6 ms deadline synthesizes one 2.84 Ms TX wideband
         block (1024 FOCC channels) on device AND pushes it through
         the full RX pipeline, via ThreadedExecutor's tx-feeder /
         rx-drainer threads and a bounded BlockQueue.

Latency protocol: pipeline_depth=1, so rx.push returns only after the
block's reports are fetched on the host (a data dependency on the full
RX compute — the honest, conservative completion time).
latency_b = completion_b - arrival_b; deadline miss = latency_b >
block_dt.  Run it alone on the card: a second process competes for it.
"""

import os
import gc
import json
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax                                                  # noqa: E402
from amps_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
import jax.numpy as jnp                                     # noqa: E402

from amps_tpu.dsp import channelizer as chz                 # noqa: E402
from amps_tpu.dsp.fm import fm_modulate_symbols             # noqa: E402
from amps_tpu.eval.traffic import MobileEvent               # noqa: E402
from amps_tpu.parallel.pipeline import (MultichannelSpec,   # noqa: E402
                                        tx_multichannel_block)
from amps_tpu.runtime.executor import (BlockQueue,          # noqa: E402
                                       ThreadedExecutor)
from amps_tpu.runtime.streamer import MultichannelReceiver  # noqa: E402
from amps_tpu.tx import recc_ms                             # noqa: E402

RATE = 30.72e6                 # 1024 x 30 kHz wideband, samples/s
M = 1024
POOL_BLOCKS = 8
BLOCK = 1 << 22                # bench block: 8192 hops, 136.53 ms
SECONDS = 70.0                 # per leg (>= 60 s required)

SPEC = MultichannelSpec(num_channels=M, taps_per_phase=8, fold="bank",
                        io_bf16=True, corr_bf16=True, transform_bf16=True)

EVENTS = [MobileEvent("page_response", 100, 2000, "5551234567"),
          MobileEvent("page_response", 700, 12000, "4155559876"),
          # spans the pool-block 2 -> 3 boundary (hop 24576)
          MobileEvent("page_response", 300, 19576, "9165554321"),
          MobileEvent("page_response", 900, 40000, "7025551000"),
          MobileEvent("page_response", 50, 52000, "2125550000")]


def stage_pool():
    """Build the 8-block periodic reverse band ON DEVICE (host uploads
    only the tiny burst basebands)."""
    P = M // 2
    period_hops = POOL_BLOCKS * BLOCK // P            # 65536
    sens = 2 * np.pi * SPEC.pipe.deviation_hz / SPEC.pipe.chan_rate
    Y = jnp.zeros((period_hops, M, 2), jnp.float32)
    for ev in EVENTS:
        syms = recc_ms.burst_symbols(np.stack(ev.words()), dcc=0,
                                     sps=SPEC.chan_sps)
        bb, _ = fm_modulate_symbols(jnp.asarray(syms, jnp.int8), sens)
        n = bb.shape[0]
        assert ev.start_hop + n < period_hops, (ev.start_hop, n)
        Y = Y.at[ev.start_hop: ev.start_hop + n, ev.channel].set(bb)
    x, _ = chz.synthesize(Y, SPEC.chz_spec,
                          chz.synthesizer_init(SPEC.chz_spec))
    del Y
    key = jax.random.PRNGKey(7)
    x = x + 0.01 * jax.random.normal(key, x.shape, jnp.float32)
    x = jax.block_until_ready(x)
    return [x[i * BLOCK:(i + 1) * BLOCK] for i in range(POOL_BLOCKS)]


def summarize(lat_ms, block_dt_ms, jit_ms, extra):
    lat = np.asarray(lat_ms)
    out = {
        "blocks": int(len(lat)),
        "block_dt_ms": round(block_dt_ms, 3),
        "wall_s": round(len(lat) * block_dt_ms / 1e3, 1),
        "latency_ms": {
            "p50": round(float(np.percentile(lat, 50)), 2),
            "p90": round(float(np.percentile(lat, 90)), 2),
            "p99": round(float(np.percentile(lat, 99)), 2),
            "max": round(float(lat.max()), 2),
        },
        "deadline_misses": int((lat > block_dt_ms).sum()),
        # a real radio front end buffers a couple of blocks; an actual
        # sample drop (underrun/overrun) needs the completion to slip
        # past the deadline PLUS the buffered slack
        "underruns_1_block_buffer": int((lat > 2 * block_dt_ms).sum()),
        "underruns_2_block_buffer": int((lat > 3 * block_dt_ms).sum()),
        "arrival_jitter_ms_max": round(float(np.max(jit_ms)), 2),
        "rt_headroom_p99": round(block_dt_ms
                                 / float(np.percentile(lat, 99)), 1),
    }
    out.update(extra)
    return out


def leg_rx(seconds=None):
    pool = stage_pool()
    block_dt = BLOCK / RATE
    n_blocks = int(np.ceil((seconds or SECONDS) / block_dt))
    n_blocks -= n_blocks % POOL_BLOCKS                # whole periods
    # warm the executables on a scratch receiver (same shapes)
    warm = MultichannelReceiver(SPEC, threshold=0.5, pipeline_depth=1,
                                max_bursts=2, min_rssi=0.05)
    for b in range(2):
        warm.push(pool[b])
    del warm

    rx = MultichannelReceiver(SPEC, threshold=0.5, pipeline_depth=1,
                                max_bursts=2, min_rssi=0.05)
    reports = []
    lat, jit, backlog = [], [], []
    state = {"b": 0}
    t0 = time.monotonic() + 0.2

    def source():
        b = state["b"]
        if b >= n_blocks:
            return None
        state["b"] = b + 1
        arrival = t0 + (b + 1) * block_dt     # block fully arrived
        now = time.monotonic()
        if now < arrival:
            time.sleep(arrival - now)
        jit.append((time.monotonic() - arrival) * 1e3)
        # backlog: how far the previous completion overran this arrival
        late = (lat[-1] / 1e3 - block_dt) if lat else 0.0
        backlog.append(max(0.0, late))
        return pool[b % POOL_BLOCKS]

    def push(block):
        b = state["b"] - 1
        reports.extend(rx.push(block))
        lat.append((time.monotonic() - (t0 + (b + 1) * block_dt)) * 1e3)

    gc.collect()
    gc.disable()      # a GC pause mid-deadline is a spurious tail spike
    try:
        ex = ThreadedExecutor(rx_source=source, rx_push=push).start()
        ex.join(timeout=SECONDS * 2 + 300)
    finally:
        gc.enable()
    reports.extend(rx.flush())

    # exactly-once, bit-exact delivery of every planted burst
    periods = n_blocks // POOL_BLOCKS
    expect = periods * len(EVENTS)
    ok_words = 0
    for r in reports:
        if r.word_ok[:2].all():
            ok_words += 1
    per_event = {}
    for r in reports:
        per_event[r.channel] = per_event.get(r.channel, 0) + 1
    counts_ok = all(per_event.get(ev.channel, 0) == periods
                    for ev in EVENTS)
    return summarize(
        lat, block_dt * 1e3, jit,
        {"leg": "rx_paced",
         "rate_msps": RATE / 1e6,
         "reports": len(reports),
         "reports_expected": expect,
         "reports_word_ok": ok_words,
         "exactly_once_per_period": bool(counts_ok
                                         and len(reports) == expect),
         "max_backlog_s": round(max(backlog), 3) if backlog else 0.0})


def leg_fdx(threaded=True):
    """``threaded=False`` runs the same paced full-duplex loop in ONE
    thread (tx dispatch then rx push per deadline), to compare the
    two-thread executor's tail against a single dispatch stream."""
    frames = 2
    n_hops = frames * 463 * 2 * SPEC.chan_sps         # 5556
    P = M // 2
    block = n_hops * P                                # 2,844,672
    block_dt = block / RATE                           # 92.6 ms
    n_blocks = int(np.ceil(SECONDS / block_dt))
    rng = np.random.default_rng(0)
    wp = jnp.asarray(rng.integers(0, 2, (M, frames, 2, 28))
                     .astype(np.uint8))

    import functools
    tx_run = jax.jit(functools.partial(tx_multichannel_block, spec=SPEC))
    xw = tx_run(wp)
    xw.block_until_ready()                             # compile + warm TX
    warm = MultichannelReceiver(SPEC, threshold=0.5, pipeline_depth=1,
                                max_bursts=2, min_rssi=0.05)
    warm.push(xw)
    del warm

    rx = MultichannelReceiver(SPEC, threshold=0.5, pipeline_depth=1,
                                max_bursts=2, min_rssi=0.05)
    q = BlockQueue(depth=2)
    lat, jit, qdepth = [], [], []
    state = {"tx": 0, "rx": 0}
    t0 = time.monotonic() + 0.2

    def tx_step():
        b = state["tx"]
        if b >= n_blocks:
            q.close()
            return None
        state["tx"] = b + 1
        deadline = t0 + b * block_dt                 # produce block b now
        now = time.monotonic()
        if now < deadline:
            time.sleep(deadline - now)
        jit.append((time.monotonic() - deadline) * 1e3)
        return tx_run(wp)

    def rx_source():
        qdepth.append(q._q.qsize())
        return q.get()

    def rx_push(block):
        b = state["rx"]
        state["rx"] = b + 1
        rx.push(block)
        # deadline for block b: its samples would have finished hitting
        # the air at t0 + (b+1) * dt; full-duplex real time means the
        # whole TX+RX round stays ahead of that clock
        lat.append((time.monotonic() - (t0 + b * block_dt)) * 1e3)

    gc.collect()
    gc.disable()
    try:
        if threaded:
            ex = ThreadedExecutor(tx_step=tx_step, tx_sink=q.put,
                                  rx_source=rx_source,
                                  rx_push=rx_push).start()
            ex.join(timeout=SECONDS * 2 + 300)
        else:
            while True:
                blk = tx_step()
                if blk is None:
                    break
                rx_push(blk)
    finally:
        gc.enable()
    return summarize(
        lat, block_dt * 1e3, jit,
        {"leg": "full_duplex_paced_loopback" + (
            "" if threaded else "_single_thread"),
         "rate_msps": RATE / 1e6,
         "tx_blocks": state["tx"], "rx_blocks": state["rx"],
         "max_queue_depth": int(max(qdepth)) if qdepth else 0})


def main():
    print(json.dumps({"device": str(jax.devices()[0]),
                      "spec": "1024ch bench config",
                      "rate_msps": RATE / 1e6}), flush=True)
    legs = {"rx": leg_rx, "fdx": leg_fdx,
            "fdx1": lambda: leg_fdx(threaded=False)}
    names = sys.argv[1:] or ["rx", "fdx"]
    for name in names:
        t0 = time.time()
        res = legs[name]()
        res["leg_wall_s_total"] = round(time.time() - t0, 1)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
