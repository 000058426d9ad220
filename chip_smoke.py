"""Bring-up smoke run of the AMPS station on a GPU.

    python chip_smoke.py          # one card: device, bank, rx, loop, bs, memory
    python chip_smoke.py --four   # four cards: the sharded station against
                                  # the single-device one, nothing else

Drives the station's main path through the entry points an operator
uses, at the deployed width (a 1024-channel bank, the bench's
production spec), and checks what comes out against the repo's own
references: a float64 NumPy channel bank, the planted burst words, the
NumPy FOCC framer, and the CPU test's call timeline.  Each phase prints
one JSON line with its wall time (compilation included — set-up
information, not a benchmark number); the last line is
``{"ok": true, "device": {...}}``.  The script exits non-zero, without
that line, when JAX finds no GPU or any phase fails.

Every phase is a function with size parameters so that the CPU tests
run the same code at tiny widths (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time
import traceback

import numpy as np

# the bench's production spec (bench.py): permutation-absorbed bank
# fold, bf16 data planes and transform, f32 accumulation
PRODUCTION = dict(num_channels=1024, taps_per_phase=8, fold="bank",
                  io_bf16=True, corr_bf16=True, transform_bf16=True)
# one RX push of the bench: 2^22 wideband samples (~137 ms at 30.72 Msps)
BLOCK = 1 << 22
# bank SNR floors against float64, in dB, a few dB under what an H100
# gives at M=1024: bf16 operands keep an 8-bit mantissa (53.5 dB
# measured); the f32 path runs at default matmul precision, which on
# the H100's tensor cores is TF32 with a 10-bit mantissa (71.6 dB; 127.7
# with Precision.HIGHEST)
SNR_FLOOR_DB = {"bf16": 50.0, "f32": 65.0}
# the station timeline of the live call in
# tests/test_apps.py::test_mesh_bs_full_call_lifecycle (page -> alert ->
# answer -> SAT/ST supervision -> ST release) as bs_app reports it; the
# CPU test mesh gives exactly this on 2x2 and 1x1
CALL_TIMELINE = [["supervision_event", "sat_lost"],
                 ["supervision_event", "sat_back"],
                 ["supervision_event", "answer"],
                 ["supervision_event", "release"],
                 ["release", [355, "mobile release (ST)"]]]
CALL_MIN = "5551234567"


def _spec(**kw):
    from amps_tpu.parallel.pipeline import MultichannelSpec
    return MultichannelSpec(**{**PRODUCTION, **kw})


def _emit(phase: str, t0: float, **fields) -> dict:
    rec = {"phase": phase, "wall_s": round(time.perf_counter() - t0, 3),
           **fields}
    print(json.dumps(rec, default=str), flush=True)
    return rec


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(cache_dir: str, smi: str) -> dict:
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "count": len(devs), "jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "compile_cache": cache_dir, "nvidia_smi": smi}


def phase_bank(num_channels: int = 1024, hops: int = 256,
               seed: int = 0) -> dict:
    """The analysis bank (channel-major, planar, bank fold) on random IQ
    against the float64 reference, for both transform paths."""
    import jax
    import jax.numpy as jnp
    from amps_tpu.dsp import channelizer as chz
    from amps_tpu.ref.channelizer_ref import analyze_ref

    spec = _spec(num_channels=num_channels).chz_spec
    M = spec.num_channels
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.5, (hops * spec.hop, 2)).astype(np.float32)
    ref = analyze_ref(x, chz.prototype_taps(M, spec.taps_per_phase), M)

    def snr_db(bf16: bool) -> float:
        y, _ = chz.analyze(jnp.asarray(x), spec, chz.analyzer_init(spec),
                           chmajor=True, planar=True, fold="bank",
                           bf16=bf16)
        y = np.asarray(y, np.float64)
        err = y[0] + 1j * y[1] - ref
        return float(10 * np.log10(np.sum(np.abs(ref) ** 2)
                                   / np.sum(np.abs(err) ** 2)))

    snr = {"bf16": snr_db(True), "f32": snr_db(False)}
    with jax.default_matmul_precision("highest"):
        snr["f32_highest"] = snr_db(False)
    for path, floor in SNR_FLOOR_DB.items():
        _check(snr[path] >= floor,
               f"bank {path} SNR {snr[path]:.1f} dB < {floor} dB")
    return {"channels": M, "hops": hops, "snr_db": snr,
            "floor_db": SNR_FLOOR_DB,
            "precision": {
                "bf16": "bf16 operands, f32 accumulation",
                "f32": "f32 operands at default matmul precision",
                "f32_highest": "f32 operands, Precision.HIGHEST "
                               "(reference point, not a served path)"}}


def phase_rx(num_channels: int = 1024, n_events: int = 112,
             total_hops: int = 32768, block: int = BLOCK) -> dict:
    """The clean soak: planted bursts through MultichannelReceiver,
    exactly once, bit-exact, no ghosts."""
    from amps_tpu.eval.soak import clean_soak
    res = clean_soak(_spec(num_channels=num_channels), n_events,
                     total_hops, block)
    _check(res["n_events"] == n_events,
           f"planted {res['n_events']} of {n_events} events")
    _check(res["ok"] and res["exact_once"] == n_events,
           f"rx soak failed: {json.dumps(res)[:2000]}")
    return res


def phase_loop(num_channels: int = 1024, nblocks: int = 4, frames: int = 4,
               n_events: int = 24, seed: int = 5) -> dict:
    """The fused full-duplex closed loop with external reverse traffic:
    planted words decoded exactly once; FOCC frame bits bit-exact
    against the NumPy framer."""
    import jax
    import jax.numpy as jnp
    from amps_tpu.eval.soak import (account, closed_loop_reports,
                                    synthesize_on_device)
    from amps_tpu.eval.traffic import random_events
    from amps_tpu.ref import frames_ref
    from amps_tpu.rx import correlator
    from amps_tpu.runtime.streamer import make_closed_loop_stream
    from amps_tpu.tx.focc import focc_frame_bits

    spec = _spec(num_channels=num_channels)
    M, sps = spec.num_channels, spec.chan_sps
    n_hops = frames * 463 * 2 * sps
    run, block_samples = make_closed_loop_stream(
        spec, nblocks, frames, max_bursts=4, threshold=0.6,
        rx_external=True)
    events = random_events(n_events, spec, nblocks * n_hops, seed=seed)
    x = synthesize_on_device(events, spec, nblocks * n_hops, 0.02)
    rng = np.random.default_rng(seed)
    wp = rng.integers(0, 2, (M, frames, 2, 28)).astype(np.uint8)
    out = run(jnp.asarray(wp), x.reshape(nblocks, block_samples, 2))
    overlap = (correlator.TRIGGER_SYMBOLS + correlator.CAPTURE_SYMBOLS) * sps
    reports = closed_loop_reports(out, n_hops, overlap, sps, min_rssi=0.05)
    res = account(events, reports, sps)
    tx_peak = np.asarray(jax.device_get(out["tx_peak"]))
    _check(res["ok"] and res["exact_once"] == len(events) > 0,
           f"closed loop decode failed: {json.dumps(res)[:2000]}")
    _check(bool((tx_peak > 0.01).all()), f"TX silent: {tx_peak}")

    bits = np.asarray(focc_frame_bits(wp))                # (M, frames*463)
    ref = np.stack([np.concatenate([frames_ref.frame_bits(*wp[c, f])
                                    for f in range(frames)])
                    for c in range(M)])
    mismatched = int(np.sum(bits != ref))
    _check(mismatched == 0, f"FOCC frame bits differ in {mismatched} places")
    res.update(blocks=nblocks, block_samples=block_samples,
               tx_peak_min=float(tx_peak.min()),
               focc_frame_bits_checked=int(ref.size),
               focc_frame_bits_mismatched=mismatched)
    return res


def _operator_page(port: int, minstr: str, deadline_s: float) -> None:
    """Page ``minstr`` through the station's TCP command server (the
    reference's Socket PDU), retrying until the server listens."""
    deadline = time.time() + deadline_s
    while True:
        try:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=1) as s:
                s.sendall(f"page {minstr}\n".encode())
                time.sleep(0.2)
            return
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.05)


def run_live_call(mesh: str, channels: int, blocks: int = 30) -> dict:
    """One paged call on ``bs_app --mesh``: the operator pages through
    the socket, the simulated mobile answers, talks and hangs up."""
    from apps import bs_app
    port = _free_port()
    result: dict = {}
    th = threading.Thread(
        target=bs_app.main,
        args=(["--mesh", mesh, "--channels", str(channels),
               "--simulate", f"mobile:{CALL_MIN}",
               "--voice-slot-map", "355:4,356:5",
               "--sup-timers", "3.0:0.8",
               "--port", str(port), "--blocks", str(blocks)], result),
        daemon=True)
    th.start()
    _operator_page(port, CALL_MIN, deadline_s=900)
    th.join(timeout=1800)
    _check(not th.is_alive(), f"mesh {mesh} station did not finish")
    mob = result["mob"]
    timeline = json.loads(json.dumps(result["timeline"]))
    _check(mob.log[:4] == ["paged", "assigned 355", "ringing", "answered"]
           and "hang_up" in mob.log, f"mobile log {mob.log}")
    _check(timeline == CALL_TIMELINE,
           f"mesh {mesh} timeline {timeline}")
    _check(not result["station"].supervisors, "call not torn down")
    return {"mesh": mesh, "channels": channels, "timeline": timeline,
            "mobile_log": mob.log}


def phase_bs(channels: int = 1024, call_channels: int = 1024,
             superframes: int = 6) -> dict:
    """The operator path: bs_app single-device with its TCP command
    server (a page arrives through the socket; simulated page-response
    and origination bursts are decoded and dispatched), then one live
    call on a 1x1 mesh."""
    from apps import bs_app
    port = _free_port()
    result: dict = {}
    th = threading.Thread(
        target=bs_app.main,
        args=(["--channels", str(channels), "--port", str(port),
               "--superframes", str(superframes),
               "--simulate", "page_response:4155559876",
               "--simulate", "origination:2125550000:7025551000"], result),
        daemon=True)
    th.start()
    _operator_page(port, "3105551234", deadline_s=600)
    th.join(timeout=1200)
    _check(not th.is_alive(), "bs_app did not finish")
    station = result["station"]
    debug = [str(e.payload) for e in station.events if e.kind == "debug"]
    commands = [str(e.payload) for e in station.events
                if e.kind == "command"]
    _check(any("paging" in d for d in debug), f"page not handled: {debug}")
    _check(any("response from MIN=4155559876" in d for d in debug),
           f"page response not dispatched: {debug}")
    _check(any("origination: MIN=2125550000" in d
               and "dialed 7025551000" in d for d in debug)
           and any("page 7025551000" in c for c in commands),
           f"origination not dispatched: {debug} {commands}")
    call = run_live_call("1x1", call_channels)
    return {"channels": channels, "operator_page": True,
            "dispatched": [d.strip() for d in debug
                           if "response" in d or "origination" in d],
            "call": call}


def phase_memory(num_channels: int = 1024, block: int = BLOCK) -> dict:
    """Compiled memory of the streaming RX block step, and the device's
    peak allocation so far."""
    import jax
    import jax.numpy as jnp
    from amps_tpu.dsp import channelizer as chz
    from amps_tpu.rx import correlator
    from amps_tpu.runtime.streamer import _rx_stream_block

    spec = _spec(num_channels=num_channels)
    M, T, sps = spec.num_channels, spec.taps_per_phase, spec.chan_sps
    ovr = (correlator.TRIGGER_SYMBOLS + correlator.CAPTURE_SYMBOLS) * sps
    f32 = jnp.float32
    args = (jax.ShapeDtypeStruct((block, 2), f32),
            jax.ShapeDtypeStruct((M * T - M // 2, 2), f32),
            jax.ShapeDtypeStruct((M, ovr), f32),
            jax.ShapeDtypeStruct((M, 2), f32),
            jax.ShapeDtypeStruct((M, ovr), f32))
    compiled = _rx_stream_block.lower(
        *args, M=M, T=T, sps=sps, max_bursts=6, threshold=0.6,
        bf16=spec.transform_bf16, split=chz.default_split(M),
        fold=spec.fold, io_bf16=spec.io_bf16,
        corr_bf16=spec.corr_bf16).compile()
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    stats = jax.devices()[0].memory_stats() or {}
    return {"rx_block_samples": block,
            "rx_block_memory": {f: getattr(ma, f, None) for f in fields},
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "bytes_limit": stats.get("bytes_limit")}


def phase_four(num_channels: int = 1024, row_hops: int = 12480,
               nblocks: int = 3, n_random: int = 24,
               call_channels: int = 1024) -> dict:
    """The sharded station on a 2x2 mesh of four devices against one
    device: full-duplex stream step (ShardedTransceiver over
    make_sharded_bs_stream_step) with bursts across row and block
    boundaries and a checkpoint/restore through the host, compared
    report by report with MultichannelReceiver; the sharded TX wideband
    against MultichannelTransmitter; one live call on --mesh 2x2 against
    the same call on 1x1."""
    import tempfile
    import jax
    import jax.numpy as jnp
    from amps_tpu.eval.soak import account, synthesize_on_device
    from amps_tpu.eval.traffic import MobileEvent, random_events
    from amps_tpu.parallel.mesh import MeshSpec, make_mesh
    from amps_tpu.parallel.stream import ShardedTransceiver
    from amps_tpu.runtime.state import (load_sharded_receiver,
                                        save_sharded_receiver)
    from amps_tpu.runtime.streamer import (MultichannelReceiver,
                                           MultichannelTransmitter)

    _check(len(jax.devices()) >= 4, f"need 4 devices, have {jax.devices()}")
    spec = _spec(num_channels=num_channels)
    M, P, sps = spec.num_channels, spec.chz_spec.hop, spec.chan_sps
    tsize = csize = 2
    block_hops = tsize * row_hops
    total_hops = nblocks * block_hops
    fixed = [MobileEvent("origination", 0, row_hops - 5000, "5551234567",
                         "7025551000", esn=777),          # row boundary
             MobileEvent("page_response", 1, block_hops - 4000,
                         "4155559876"),                   # block boundary
             MobileEvent("registration", 2, 2 * block_hops + 3000,
                         "2125550000", esn=5)]            # after restore
    events = random_events(n_random, spec, total_hops, seed=13,
                           channels=range(3, M)) + fixed
    x = synthesize_on_device(events, spec, total_hops, 0.02)
    gates = dict(max_bursts=4, threshold=0.6, policy="first_ok",
                 min_rssi=0.05)

    single = MultichannelReceiver(spec, **gates)
    want = []
    for i in range(nblocks * tsize):
        want += single.push(x[i * row_hops * P:(i + 1) * row_hops * P])
    want += single.flush()

    mesh = make_mesh(MeshSpec(time=tsize, chan=csize), jax.devices()[:4])
    ctrl = [1]
    trx = ShardedTransceiver(mesh, spec, control_channels=ctrl, **gates)
    tx_ref = MultichannelTransmitter(spec, control_channels=ctrl)
    got, tx_err, tx_scale = [], 0.0, 0.0
    for b in range(nblocks):
        if b == 1:
            # whole-state checkpoint through an .npz file; the state is
            # zeroed before the restore, so a restore bug cannot pass
            # (the block-boundary burst's head lives in this carry)
            with tempfile.TemporaryDirectory() as td:
                path = os.path.join(td, "sharded.npz")
                save_sharded_receiver(path, trx)
                trx._state = {k: jnp.zeros_like(v)
                              for k, v in trx._state.items()}
                load_sharded_receiver(path, trx)
        tx, reps = trx.push(x[b * block_hops * P:(b + 1) * block_hops * P])
        got += reps
        want_tx = np.concatenate([np.asarray(tx_ref.next_block())
                                  for _ in range(trx.superframes_per_block)])
        tx_err = max(tx_err, float(np.abs(np.asarray(tx) - want_tx).max()))
        tx_scale = max(tx_scale, float(np.abs(want_tx).max()))
    got += trx.flush()

    def key(r):
        return (r.channel, r.abs_symbol, np.asarray(r.words).tobytes(),
                np.asarray(r.word_ok).tobytes(),
                np.asarray(r.bad_symbols).tobytes(), r.dcc)

    _check(len(got) == len(want) and all(key(a) == key(b)
                                         for a, b in zip(got, want)),
           f"sharded reports differ: {len(got)} vs {len(want)}")
    acc = account(events, got, sps)
    _check(acc["ok"] and acc["exact_once"] == len(events),
           f"sharded soak failed: {json.dumps(acc)[:2000]}")
    # the sharded and single-device synthesis programs sum in different
    # orders, and the transform rounds its stage-1 sums to bf16, where a
    # last-bit f32 difference can land on the neighbouring bf16 value
    # (2^-8 relative): equal to 2^-7 of the peak
    tx_tol = 2.0 ** -7 * tx_scale
    _check(tx_err <= tx_tol, f"sharded TX differs by {tx_err} > {tx_tol}")
    calls = [run_live_call("2x2", call_channels),
             run_live_call("1x1", call_channels)]
    _check(calls[0]["timeline"] == calls[1]["timeline"],
           "2x2 and 1x1 call timelines differ")
    return {"mesh": "2x2", "channels": M, "blocks": nblocks,
            "block_hops": block_hops, "n_events": len(events),
            "reports_equal_single_device": True,
            "exact_once": acc["exact_once"],
            "tx_max_abs_err": tx_err, "tx_peak": tx_scale,
            "tx_tolerance": tx_tol, "calls": calls}


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card sharded phase only")
    args = ap.parse_args(argv)

    from amps_tpu.utils.compile_cache import enable_compile_cache
    from amps_tpu.utils.device import gpu_devices, gpu_name_and_power
    try:
        gpu_devices(4 if args.four else 1)
    except RuntimeError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    import jax
    devs = jax.devices()
    cache = enable_compile_cache()
    smi = gpu_name_and_power()
    print(smi, flush=True)

    t0 = time.perf_counter()
    _emit("device", t0, **phase_device(cache, smi))
    phases = ([("four", phase_four)] if args.four else
              [("bank", phase_bank), ("rx", phase_rx), ("loop", phase_loop),
               ("bs", phase_bs), ("memory", phase_memory)])
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            _emit(name, t0, **fn())
        except Exception as e:    # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
            _emit(name, t0, error=f"{type(e).__name__}: {e}"[:4000])
    if failed:
        print(json.dumps({"ok": False, "failed": failed}))
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
