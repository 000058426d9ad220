"""BS-in-a-box loopback demo (no hardware).

A 8-slot channelizer base station: slot 1 runs a FOCC; a simulated
mobile originates a call on the reverse band; the station assigns a
voice channel and pages the dialed number — the §3.2 chain of the
reference (recc -> recc_decode -> focc/command_processor) end to end on
the array pipeline.

Run: python examples/bs_loopback_demo.py  (JAX's default backend)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from amps_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from amps_tpu.control.station import BaseStation
from amps_tpu.dsp import channelizer as chz
from amps_tpu.dsp.fm import fm_modulate_symbols
from amps_tpu.parallel.pipeline import MultichannelSpec
from amps_tpu.runtime.streamer import (MultichannelReceiver,
                                       MultichannelTransmitter)
from amps_tpu.tx import recc_ms


def main():
    spec = MultichannelSpec(num_channels=8, taps_per_phase=8)
    sps = spec.chan_sps

    station = BaseStation()
    tx = MultichannelTransmitter(spec, control_channels=[1])
    station.focc = tx.focc[1]  # station's FOCC words go out on slot 1

    def on_burst(rep):
        print(f"[rx] burst on channel {rep.channel} "
              f"q={rep.quality:.2f} words_ok={rep.word_ok.tolist()}")
        station.handle_burst(rep.words, rep.word_ok, rep.bad_symbols)

    rx = MultichannelReceiver(spec, on_burst=on_burst, threshold=0.5)

    # --- forward: one superframe of RF ---
    rf = np.asarray(tx.next_block())
    print(f"[tx] wideband superframe: {rf.shape[0]} samples "
          f"({rf.shape[0] / spec.chz_spec.fs * 1e3:.1f} ms of RF "
          f"at {spec.chz_spec.fs/1e6:.2f} Msps)")

    # --- reverse: a mobile originates a call on slot 3 ---
    words = recc_ms.origination_words("5551234567", "5551230000")
    syms = recc_ms.burst_symbols(words, dcc=0, sps=sps)
    sens = 2 * np.pi * spec.pipe.deviation_hz / spec.pipe.chan_rate
    bb, _ = fm_modulate_symbols(syms.astype(np.int8), sens)
    hops = 40960
    Y = np.zeros((hops, 8, 2), np.float32)
    Y[2000:2000 + len(np.asarray(bb)), 3] = np.asarray(bb)
    rev_rf, _ = chz.synthesize(Y, spec.chz_spec,
                               chz.synthesizer_init(spec.chz_spec))
    print(f"[ms] origination burst transmitted on reverse slot 3 "
          f"(dialing 5551230000)")

    rx.push(np.asarray(rev_rf))

    print("[station] events:")
    for ev in station.events:
        if ev.kind in ("debug", "command"):
            print(f"   {ev.kind}: {str(ev.payload).strip()}")
        else:
            print(f"   {ev.kind}")
    print(f"[station] FOCC queue depth: {station.focc.queue_depth()} "
          f"(voice assignment + page words await the next superframe)")

    # next superframe carries the response; the page is REPEATED over
    # SystemConfig.page_repeats superframes (so a mobile deferring
    # during a busy-marked superframe still hears one), so the queue
    # drains over that many blocks
    for k in range(station.system.page_repeats):
        rf2 = np.asarray(tx.next_block())
        print(f"[tx] superframe {k + 1} sent ({rf2.shape[0]} samples); "
              f"queue depth now {station.focc.queue_depth()}")
    assert station.focc.queue_depth() == 0
    print("[tx] assignment and repeated page delivered")


if __name__ == "__main__":
    main()
