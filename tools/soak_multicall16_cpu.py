"""Virtual-mesh multi-call CAPACITY soak (VERDICT r4 item 8): sixteen
concurrent supervised calls through the APPLICATION (apps/bs_app.py
--mesh 2x2) on a wide voice plan.

The operator pages 16 mobiles via the TCP socket; each scripted mobile
answers over the air interface (RECC response through the sharded RX —
serialized by the real B/I busy marking), transponds SAT on its own
reverse voice channel (measured through the sharded analysis bank's
16-slot supervision tap), talks long enough that ALL SIXTEEN calls are
up simultaneously, then hangs up on a staggered schedule (1.8 s ST).

Verdict: peak concurrency >= 16; every channel sees exactly one answer
and one ST-reason release; zero unexpected supervision events; every
mobile's log completes.  Host-side control-plane cost per supervised
call is measured (push_supervision + handle_burst wall time) and
recorded for docs/OPERATIONS.md.

Reference capacity being beaten: ONE call's signaling at a time (a
single shared fvc block, lib/fvc_impl.cc; voice channels hardcoded to
355/356, lib/recc_decode_impl.cc:205,252).
"""

import os
import json
import socket
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

OUT = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "soak_multicall16_cpu.out"), "a", buffering=1)


def emit(**kw):
    OUT.write(json.dumps(kw) + "\n")
    print(kw, flush=True)


N_CALLS = 16
CHANS = list(range(355, 355 + N_CALLS))
SLOTS = list(range(8, 8 + N_CALLS))          # bank slots 8..23 (M=32)
MINS = [f"415555{1000 + i:04d}" for i in range(N_CALLS)]
PORT = 64731
BLOCKS = 120


def main():
    import os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from amps_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from amps_tpu.control.station import BaseStation
    from apps import bs_app

    # host-cost metering: wrap the two control-plane entry points
    cost = {"sup_s": 0.0, "sup_calls": 0, "burst_s": 0.0, "bursts": 0}
    orig_push = BaseStation.push_supervision
    orig_burst = BaseStation.handle_burst

    def timed_push(self, chan, levels, power):
        t0 = time.perf_counter()
        orig_push(self, chan, levels, power)
        cost["sup_s"] += time.perf_counter() - t0
        cost["sup_calls"] += 1

    def timed_burst(self, words, word_ok, bad_symbols=None):
        t0 = time.perf_counter()
        orig_burst(self, words, word_ok, bad_symbols)
        cost["burst_s"] += time.perf_counter() - t0
        cost["bursts"] += 1

    BaseStation.push_supervision = timed_push
    BaseStation.handle_burst = timed_burst

    slot_map = ",".join(f"{c}:{s}" for c, s in zip(CHANS, SLOTS))
    sims = [f"mobile:{m}:hangup:{30 + 2 * i}" for i, m in enumerate(MINS)]
    argv = ["--mesh", "2x2", "--channels", "32", "--platform", "cpu",
            "--voice-slot-map", slot_map,
            "--sup-timers", "3.0:0.8",
            "--port", str(PORT), "--blocks", str(BLOCKS)]
    for s in sims:
        argv += ["--simulate", s]
    emit(event="start", calls=N_CALLS, chans=CHANS, slots=SLOTS,
         blocks=BLOCKS, argv_mesh="2x2 M=32")

    result: dict = {}
    th = threading.Thread(target=bs_app.main, args=(argv, result),
                          daemon=True)
    t_start = time.time()
    th.start()

    # operator: page all 16 via the socket once the server is up
    deadline = time.time() + 900
    sock = None
    while time.time() < deadline:
        try:
            sock = socket.create_connection(("127.0.0.1", PORT), timeout=1)
            break
        except OSError:
            time.sleep(0.5)
    assert sock is not None, "command server never came up"
    for m in MINS:
        sock.sendall(f"page {m}\n".encode())
        time.sleep(0.05)
    sock.close()
    emit(event="paged", n=N_CALLS)

    th.join(timeout=3600)
    assert not th.is_alive(), "mesh BS loop did not finish"
    wall = time.time() - t_start
    BaseStation.push_supervision = orig_push
    BaseStation.handle_burst = orig_burst

    station, mobs = result["station"], result["mobs"]

    # ---- concurrency from the (supervision-start, release) intervals
    starts, rels = {}, {}
    for e in station.events:
        if e.kind == "supervision":
            starts.setdefault(e.payload[0], e.t)
        elif e.kind == "release":
            rels[e.payload[0]] = e.t
    edges = sorted([(t, +1) for t in starts.values()]
                   + [(t, -1) for t in rels.values()])
    cur = peak = 0
    for _, d in edges:
        cur += d
        peak = max(peak, cur)

    sup_events = [e.payload for e in station.events
                  if e.kind == "supervision_event"]
    per_chan = {c: [ev.kind for ev in sup_events if ev.channel == c]
                for c in CHANS}
    answers = {c: k.count("answer") for c, k in per_chan.items()}
    rel_reasons = {ev.channel: ev.reason for ev in sup_events
                   if ev.kind == "release"}
    unexpected = [k for k in (ev.kind for ev in sup_events)
                  if k not in ("answer", "sat_lost", "sat_back", "release")]

    checks = {
        "peak_concurrent_calls_ge_16": peak >= N_CALLS,
        "every_channel_answered_once": all(answers.get(c) == 1
                                           for c in CHANS),
        "every_release_is_st": all("ST" in rel_reasons.get(c, "")
                                   for c in CHANS),
        "zero_unexpected_events": not unexpected,
        "all_mobiles_completed": all("answered" in m.log
                                     and "hang_up" in m.log
                                     and m.state == "released"
                                     for m in mobs),
        "all_torn_down": not station.supervisors,
    }
    sup_per_call_us = (cost["sup_s"] / max(cost["sup_calls"], 1)) * 1e6
    emit(event="host_cost",
         push_supervision_total_s=round(cost["sup_s"], 3),
         push_supervision_calls=cost["sup_calls"],
         push_supervision_us_per_call_block=round(sup_per_call_us, 1),
         handle_burst_total_s=round(cost["burst_s"], 3),
         handle_burst_calls=cost["bursts"],
         handle_burst_ms_each=round(
             cost["burst_s"] / max(cost["bursts"], 1) * 1e3, 2),
         wall_s=round(wall, 1))
    emit(event="concurrency", peak=peak,
         intervals={c: (round(starts.get(c, -1), 1),
                        round(rels.get(c, -1), 1)) for c in CHANS})
    emit(event="verdict", checks=checks, answers=answers,
         unexpected=unexpected, ok=all(checks.values()))
    sys.exit(0 if all(checks.values()) else 1)


if __name__ == "__main__":
    main()
