"""BS-in-a-box application — the grc/ampsbs.grc equivalent.

A running AMPS base station over the multichannel pipeline:

* forward: FOCC on the configured control slot(s), synthesized
  superframe-by-superframe into wideband IQ (written to --tx-out, a
  raw interleaved float32 I/Q file, or discarded);
* reverse: wideband IQ blocks read from --rx-in (raw float32 I/Q file,
  e.g. a recorded capture resampled to the bank rate) or from the
  built-in mobile simulator (--simulate), demodulated and decoded;
* control: TCP command server on port 64652 ('page <MIN>',
  'fvc on/off/alert'), plus automatic call handling (page response /
  registration / origination) exactly as the reference dispatches.

Examples:
  python -m apps.bs_app --channels 8 --simulate origination:5551234567:5551230000
  python -m apps.bs_app --channels 64 --rx-in capture.f32 --superframes 4
"""

from __future__ import annotations

import argparse
import asyncio
import sys

import numpy as np


def _station_config(args):
    """(SystemConfig, per_channel_fvc) from the CLI args — shared by
    mesh and single-device modes so the voice-plan rule stays
    single-source.  With mapped voice slots the station runs
    per-channel FVC streams, and the voice-channel PLAN is the mapped
    channels themselves: capacity scales with the map (a 16-entry map
    serves 16 concurrent calls; the reference hardcodes two channels,
    lib/recc_decode_impl.cc:205,252), and assigning an unmapped plan
    channel would leave its FVC stream unpulled (alert never
    transmits; the release-pending withholding would then leak the
    channel from the pool forever)."""
    from amps_tpu.config import SystemConfig
    per_chan = bool(args.voice_slot_map)
    mapped_chans = tuple(sorted(
        int(pair.split(":")[0])
        for pair in filter(None, args.voice_slot_map.split(","))))
    system = SystemConfig(
        aggressive_registration=args.aggressive_registration,
        **({"voice_channels": mapped_chans} if per_chan else {}))
    return system, per_chan


def build_parser():
    p = argparse.ArgumentParser(description="amps_tpu BS-in-a-box")
    p.add_argument("--channels", type=int, default=8,
                   help="channelizer bank size M (>= 8, even)")
    p.add_argument("--control-slot", type=int, default=1,
                   help="bank slot carrying the FOCC")
    p.add_argument("--superframes", type=int, default=2,
                   help="forward superframes to run")
    p.add_argument("--tx-out", type=str, default=None,
                   help="write wideband TX IQ (raw float32 interleaved)")
    p.add_argument("--rx-in", type=str, default=None,
                   help="read wideband RX IQ (raw float32 interleaved)")
    p.add_argument("--simulate", type=str, action="append", default=[],
                   help="single-device mode — one-shot mobile event: "
                        "origination:MIN:DIALED | page_response:MIN | "
                        "registration:MIN[:ESN] (slot 3 of the reverse "
                        "band).  Mesh mode — a LIVE scripted mobile: "
                        "mobile:MIN (answers a page, hangs up) | "
                        "mobile:MIN:hangup:N (paged; talks N blocks) | "
                        "mobile:MIN:originate:DIGITS[:BLOCK[:HANGUP_"
                        "AFTER]] | mobile:MIN:register[:BLOCK]; repeat "
                        "for concurrent calls")
    p.add_argument("--port", type=int, default=64652,
                   help="TCP command port (reference Socket PDU port)")
    p.add_argument("--voice-slot-map", type=str, default="",
                   help="AMPS_chan:bank_slot pairs for RVC supervision, "
                        "e.g. '355:4,356:5' — SAT/ST on those slots is "
                        "measured per block and drives call supervision")
    p.add_argument("--min-rssi", type=float, default=0.02,
                   help="per-channel band-power gate: FM capture of a "
                        "strong neighbor's leakage decodes cleanly on an "
                        "idle channel but at 20+ dB lower power; 0 "
                        "disables (observed on chip: adjacent-channel "
                        "ghosts double-dispatched an origination)")
    p.add_argument("--no-server", action="store_true")
    p.add_argument("--platform", type=str, default=None,
                   help="jax platform override (e.g. cpu, cuda)")
    p.add_argument("--aggressive-registration", action="store_true",
                   help="38-frame registration superframe (reference flag)")
    p.add_argument("--mesh", type=str, default=None,
                   help="run the MULTI-CHIP station: 'TxC' device mesh "
                        "(e.g. 2x2) — ShardedTransceiver full-duplex "
                        "blocks under the same control plane (TCP "
                        "server, BaseStation, SAT/ST supervision).  With "
                        "--platform cpu, T*C virtual devices are forced "
                        "if needed.")
    p.add_argument("--fvc-slot", type=int, default=None,
                   help="bank slot carrying the FVC blank-and-burst "
                        "stream in mesh mode (default control_slot+1)")
    p.add_argument("--blocks", type=int, default=40,
                   help="mesh mode: max full-duplex blocks to run (the "
                        "loop ends early once a simulated call has "
                        "completed and torn down)")
    p.add_argument("--sup-timers", type=str, default=None,
                   help="compress supervision timers for demos: "
                        "'<fade_s>:<st_release_s>' (e.g. 2.0:0.8)")
    return p


def _run_mesh(args, result: dict | None = None):
    """Multi-chip BS-in-a-box: the sharded full-duplex transceiver under
    the REAL control plane — TCP command server (operator 'page' in via
    the socket, like the reference's Socket PDU at grc/ampsbs.grc:1650),
    BaseStation call control, and SAT/ST supervision measured through
    the sharded analysis bank (the RVC tap of grc/ampsbs_rvc.grc).

    With ``--simulate mobile:MIN`` a scripted SimMobile lives on the
    reverse band: it hears the sharded FOCC/FVC wideband, responds on
    the RECC, transponds SAT+ST on its assigned voice channel, answers
    one block after ringing, and hangs up (1.8 s ST) after three
    conversation blocks — a full paged call lifecycle through the
    application.  ``result`` (optional dict) receives the station,
    mobile, and timeline for callers/tests."""
    import asyncio
    import dataclasses

    import jax
    import numpy as np

    from amps_tpu.control.server import CommandServer
    from amps_tpu.control.station import BaseStation
    from amps_tpu.dsp import channelizer as chz
    from amps_tpu.dsp.fm import fm_modulate_symbols, quadrature_demod
    from amps_tpu.ms import SimMobile
    from amps_tpu.parallel.mesh import MeshSpec, make_mesh
    from amps_tpu.parallel.pipeline import MultichannelSpec
    from amps_tpu.parallel.stream import ShardedTransceiver
    from amps_tpu.runtime.sources import VoiceFvcSlot
    from amps_tpu.utils.profiling import meter

    T, C = (int(v) for v in args.mesh.lower().split("x"))
    devs = jax.devices()
    assert len(devs) >= T * C, \
        f"mesh {T}x{C} needs {T * C} devices, have {len(devs)}"
    mesh = make_mesh(MeshSpec(time=T, chan=C), devs[:T * C])
    spec = MultichannelSpec(num_channels=args.channels)
    M, Phop, SPS = args.channels, args.channels // 2, spec.chan_sps
    # voice plan + per-channel FVC derived from the slot map
    # (shared rule: _station_config)
    system, per_chan = _station_config(args)
    station = BaseStation(system, sps=SPS, per_channel_fvc=per_chan)
    if args.sup_timers:
        fade_s, st_s = (float(v) for v in args.sup_timers.split(":"))
        station.supervision_config = dataclasses.replace(
            station.supervision_config, fade_timeout_s=fade_s,
            st_release_s=st_s)

    # voice-slot map: bank_slot -> AMPS channel (RVC supervision tap)
    slot_map = {}
    for pair in filter(None, args.voice_slot_map.split(",")):
        chan_s, slot_s = pair.split(":")
        slot_map[int(slot_s)] = int(chan_s)
    chan_to_slot = {c: s for s, c in slot_map.items()}
    sup_slots = tuple(sorted(slot_map))

    def on_burst(rep):
        print(f"[rx] burst ch={rep.channel} q={rep.quality:.2f} "
              f"ok={int(rep.word_ok.sum())}/7 rssi={rep.rssi:.3f}")
        station.handle_burst(rep.words, rep.word_ok, rep.bad_symbols)

    def on_sup(slot, lv, pw):
        station.push_supervision(slot_map[slot], lv, pw)

    trx = ShardedTransceiver(
        mesh, spec, system=system, control_channels=[args.control_slot],
        threshold=0.5, min_rssi=args.min_rssi, on_burst=on_burst,
        supervision_slots=sup_slots,
        on_supervision=on_sup if slot_map else None)
    station.focc = trx.focc[args.control_slot]
    # every mapped voice slot carries the blank-and-burst voice channel
    # (FVC data / voice+SAT per ITS OWN mute pair); an explicit
    # --fvc-slot additionally provides the legacy shared-stream slot
    for bank_slot, amps_chan in slot_map.items():
        trx.set_channel_source(
            bank_slot, VoiceFvcSlot(station,
                                    chan=amps_chan if per_chan else None))
    fvc_slot = (args.fvc_slot if args.fvc_slot is not None
                else args.control_slot + 1)
    if fvc_slot not in slot_map:
        trx.set_channel_source(fvc_slot, VoiceFvcSlot(station))

    # reverse-band block geometry: each time row's demod span (block
    # hops / T) must cover the carried halo (trx.ovr demod samples), and
    # one mobile burst (about trx.ovr hops) with the 2000-hop lead and
    # gap of one_block must fit a block, or a one-row mesh never sends it
    r = -(-(trx.ovr + 8) // C) * C
    rxh = max(T * r, -(-(trx.ovr + 4008) // (T * C)) * (T * C))
    sens = 2.0 * np.pi * spec.pipe.deviation_hz / spec.pipe.chan_rate

    # optional scripted mobiles on the reverse band (repeatable):
    #   mobile:<MIN>                      — answers a page, then hangs up
    #   mobile:<MIN>:originate:<digits>[:<block>[:<hangup_after>]]
    #                                     — originates at <block>
    mobs = []        # list of dicts: mob, action, sched
    for ev in args.simulate:
        parts = ev.split(":")
        if parts[0] == "mobile":
            mobs.append({
                "mob": SimMobile(parts[1], sps=SPS, system=system),
                "action": tuple(parts[2:]) if len(parts) > 2 else None,
                "sched": {"ring": 0, "conv": 0},
            })
        else:
            # the one-shot event kinds are single-device-mode only
            print(f"[bs] mesh mode ignores --simulate {ev!r}: use "
                  f"'mobile:MIN[:originate:DIGITS[:BLOCK[:N]]]' "
                  f"(live scripted mobile)", file=sys.stderr)
    mob = mobs[0]["mob"] if mobs else None     # primary, for reporting
    REVERSE_SLOT = 3
    ana_state = {"s": chz.analyzer_init(spec.chz_spec)}
    # the reverse-band "ether" is a CONTINUOUS stream: its synthesis
    # state must carry across blocks — a fresh synthesizer per block
    # injects a full-scale ~55-sample glitch at every boundary whose FM
    # click breaks supervision tone runs (observed: a 1.9 s release-ST
    # run read as four flash-length pieces and the release mis-fired
    # via the fade timeout)
    rev_state = {"s": chz.synthesizer_init(spec.chz_spec)}
    sched = {"block": 0}

    def one_block():
        """One full-duplex sharded block: reverse band in, TX out, the
        mobiles' ears fed from the TX wideband."""
        Y = np.zeros((rxh, M, 2), np.float32)
        cursor = 2000
        for rec in mobs:
            m = rec["mob"]
            # stagger concurrent accesses on the shared RECC; a burst
            # that doesn't fit this block waits for the next one
            if m.outbox and cursor + len(m.outbox[0][1]) <= rxh:
                _, syms = m.outbox.pop(0)
                bb = np.asarray(fm_modulate_symbols(
                    syms.astype(np.int8), sens)[0])
                Y[cursor: cursor + len(bb), REVERSE_SLOT] = bb
                cursor += len(bb) + 2000
            if m.voice_chan in chan_to_slot:
                Y[:, chan_to_slot[m.voice_chan]] += \
                    m.rvc_baseband(rxh, float(spec.pipe.chan_rate), sens)
        x_rx, rev_state["s"] = chz.synthesize(Y, spec.chz_spec,
                                              rev_state["s"])
        tx, _reports = trx.push(np.asarray(x_rx))
        if mobs:
            ya, ana_state["s"] = chz.analyze(tx, spec.chz_spec,
                                             ana_state["s"])
            ya = np.asarray(ya)
            focc_demod = np.asarray(
                quadrature_demod(ya[:, args.control_slot])[0])
            sched["block"] += 1
            for rec in mobs:
                m, action, ms = rec["mob"], rec["action"], rec["sched"]
                m.hear_focc(focc_demod, sps=SPS)
                # FVC data arrives on the mobile's ASSIGNED voice
                # channel (per-channel mode) or the legacy shared slot
                fvc_bank = chan_to_slot.get(m.voice_chan, fvc_slot) \
                    if per_chan else fvc_slot
                m.hear_fvc(np.asarray(
                    quadrature_demod(ya[:, fvc_bank])[0]), sps=SPS)
                # scripted user: originate at its block (default 2),
                # answer one block after ringing, hang up after
                # hangup_after (default 3) conversation blocks
                if (action and action[0] == "originate"
                        and m.state == "idle"
                        and sched["block"] ==
                        (int(action[2]) if len(action) > 2 else 2)):
                    m.originate(action[1])
                elif (action and action[0] == "register"
                        and "register" not in m.log
                        and sched["block"] >=
                        (int(action[1]) if len(action) > 1 else 2)):
                    # retried until the access actually queues: with
                    # concurrent mobiles the B/I bit can read busy at
                    # the scheduled block and register() drops the
                    # access silently ('register_blocked')
                    m.register()
                # paged mobiles take 'hangup:<N>' to script a longer
                # conversation (concurrency soaks overlap many calls)
                hang_after = 3
                if action and action[0] == "originate" and len(action) > 3:
                    hang_after = int(action[3])
                elif action and action[0] == "hangup":
                    hang_after = int(action[1])
                if m.state == "ringing":
                    ms["ring"] += 1
                    if ms["ring"] >= 2:
                        m.answer()
                elif m.state == "conversation":
                    ms["conv"] += 1
                    if ms["conv"] > hang_after:
                        m.hang_up()
        return len(np.asarray(tx))

    async def run():
        server = None
        if not args.no_server:
            server = CommandServer(station, port=args.port)
            await server.start()
            print(f"[ctl] command server on 127.0.0.1:{args.port} "
                  f"(mesh {T}x{C})")
        tx_meter = meter("tx_wideband")
        loop = asyncio.get_running_loop()
        had_call = False
        for b in range(args.blocks):
            ntx = await loop.run_in_executor(None, one_block)
            tx_meter.update(ntx)
            print(f"[bs] block {b}: tx {ntx} samples "
                  f"({tx_meter.rate / 1e6:.1f} Msps), rx {rxh * Phop}; "
                  f"calls={sorted(station.supervisors)}"
                  + (f" mob={mob.state}" if mob else ""))
            had_call = had_call or bool(station.supervisors)
            if (mobs and had_call and not station.supervisors
                    and all(r["mob"].state == "released" for r in mobs)):
                print("[bs] call(s) complete and torn down")
                break
        if server:
            await server.stop()

    asyncio.run(run())
    timeline = [(e.kind, e.payload.kind if hasattr(e.payload, "kind")
                 else e.payload) for e in station.events
                if e.kind in ("supervision_event", "release", "handoff")]
    print(f"[bs] station events: {timeline}")
    for rec in mobs:
        print(f"[bs] mobile {rec['mob'].min_str} log: {rec['mob'].log}")
    if result is not None:
        result.update(station=station, mob=mob,
                      mobs=[r["mob"] for r in mobs], timeline=timeline)


def main(argv=None, _result: dict | None = None):
    args = build_parser().parse_args(argv)

    import os
    if args.mesh and args.platform == "cpu":
        # a TxC virtual CPU mesh needs the device count forced BEFORE
        # the backend initializes (no-op if jax is already live, e.g.
        # under the test harness which provides 8 devices)
        T, C = (int(v) for v in args.mesh.lower().split("x"))
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={T * C}"
            ).strip()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from amps_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    if args.mesh:
        _run_mesh(args, _result)
        return

    from amps_tpu.control.server import CommandServer
    from amps_tpu.control.station import BaseStation
    from amps_tpu.dsp import channelizer as chz
    from amps_tpu.dsp.fm import fm_modulate_symbols
    from amps_tpu.parallel.pipeline import MultichannelSpec
    from amps_tpu.runtime.streamer import (MultichannelReceiver,
                                           MultichannelTransmitter)
    from amps_tpu.tx import recc_ms
    from amps_tpu.utils.profiling import meter

    spec = MultichannelSpec(num_channels=args.channels)
    # mapped voice slots get per-channel FVC streams + blank-and-burst
    # sources, exactly like mesh mode (independent concurrent-call
    # signaling); without a map the station keeps the reference's
    # single shared fvc block.  Voice plan from the slot map — the
    # shared rule of _station_config.
    system, per_chan = _station_config(args)
    station = BaseStation(system, sps=spec.chan_sps,
                          per_channel_fvc=per_chan)
    tx = MultichannelTransmitter(spec, system,
                                 control_channels=[args.control_slot])
    station.focc = tx.focc[args.control_slot]

    def on_burst(rep):
        print(f"[rx] burst ch={rep.channel} q={rep.quality:.2f} "
              f"ok={int(rep.word_ok.sum())}/7")
        station.handle_burst(rep.words, rep.word_ok, rep.bad_symbols)

    slot_map = {}
    for pair in filter(None, args.voice_slot_map.split(",")):
        chan_s, slot_s = pair.split(":")
        slot_map[int(slot_s)] = int(chan_s)
    from amps_tpu.runtime.sources import VoiceFvcSlot
    for bank_slot, amps_chan in slot_map.items():
        tx.set_channel_source(
            bank_slot, VoiceFvcSlot(station, chan=amps_chan))

    def on_supervision(slot, levels, power):
        station.push_supervision(slot_map[slot], levels, power)

    rx = MultichannelReceiver(spec, on_burst=on_burst, threshold=0.5,
                              pipeline_depth=2, min_rssi=args.min_rssi,
                              supervision_slots=tuple(slot_map),
                              on_supervision=(on_supervision
                                              if slot_map else None))

    from amps_tpu.runtime.executor import ThreadedExecutor
    from amps_tpu.runtime.sdr import FileIQSink, FileIQSource

    async def run():
        server = None
        if not args.no_server:
            server = CommandServer(station, port=args.port)
            await server.start()
            print(f"[ctl] command server on 127.0.0.1:{args.port}")

        tx_meter = meter("tx_wideband")
        rx_meter = meter("rx_wideband")

        # queue simulated mobile events as reverse-band blocks
        sim_blocks = []
        for ev in args.simulate:
            parts = ev.split(":")
            kind = parts[0]
            if kind == "origination":
                words = recc_ms.origination_words(parts[1], parts[2])
            elif kind == "page_response":
                words = recc_ms.page_response_words(parts[1])
            elif kind == "registration":
                esn = int(parts[2], 0) if len(parts) > 2 else None
                words = recc_ms.registration_words(parts[1], esn=esn)
            else:
                print(f"unknown --simulate kind {kind!r}", file=sys.stderr)
                continue
            syms = recc_ms.burst_symbols(words, dcc=system.dcc,
                                         sps=spec.chan_sps)
            sens = 2 * np.pi * spec.pipe.deviation_hz / spec.pipe.chan_rate
            bb, _ = fm_modulate_symbols(syms.astype(np.int8), sens)
            hops = 16384
            Y = np.zeros((hops, spec.num_channels, 2), np.float32)
            Y[1000:1000 + len(np.asarray(bb)), 3] = np.asarray(bb)
            blk, _ = chz.synthesize(Y, spec.chz_spec,
                                    chz.synthesizer_init(spec.chz_spec))
            sim_blocks.append(np.asarray(blk))

        # three-thread runtime: TX feeder / RX drainer here, the control
        # plane (TCP server + call state) stays on this asyncio thread
        tx_sink = FileIQSink(args.tx_out) if args.tx_out else None
        rx_src = FileIQSource(args.rx_in) if args.rx_in else None
        P = spec.chz_spec.hop
        rx_block_samples = 16384 * max(P // 4, 1)

        def tx_step():
            blk = np.asarray(tx.next_block())
            tx_meter.update(len(blk))
            print(f"[tx] superframe: {len(blk)} samples "
                  f"({tx_meter.rate / 1e6:.1f} Msps)")
            return blk

        def tx_out(blk):
            if tx_sink:
                tx_sink.write(blk)

        def rx_source():
            if rx_src is not None:
                blk = rx_src.read(rx_block_samples)
                if blk is None:
                    return None
                return blk[: (len(blk) // P) * P]
            if sim_blocks:
                return sim_blocks.pop(0)
            return None

        def rx_push(blk):
            reports = rx.push(blk)
            rx_meter.update(len(blk))
            print(f"[rx] block: {len(blk)} samples, "
                  f"{len(reports)} burst(s)")

        ex = ThreadedExecutor(tx_step=tx_step, tx_sink=tx_out,
                              rx_source=rx_source, rx_push=rx_push,
                              max_tx_blocks=args.superframes).start()
        while ex.alive:
            await asyncio.sleep(0.05)
        stats = ex.join(timeout=60)
        rx.flush()
        print(f"[run] tx {stats.tx_blocks} blocks "
              f"({stats.tx_samples} samples), rx {stats.rx_blocks} blocks "
              f"({stats.rx_samples} samples) in {stats.wall_s:.1f}s")

        for ev in station.events:
            if ev.kind in ("debug", "command"):
                print(f"[station] {ev.kind}: {str(ev.payload).strip()}")
        if tx_sink:
            tx_sink.close()
        if rx_src:
            rx_src.close()
        if server:
            await server.stop()

    asyncio.run(run())
    if _result is not None:
        _result.update(station=station)


if __name__ == "__main__":
    main()
