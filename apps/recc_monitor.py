"""RECC capture replay/monitor — the grc/recctest.grc equivalent.

Replays a recorded (or synthesized) 400 ksps IQ capture through the
single-channel reference-parity RX chain: freq-xlating FIR (-160 kHz,
decim 2) -> FM discriminator -> correlator timing recovery -> burst
decode -> parsed words printed.  The file format is raw interleaved
float32 I/Q, like GR file sinks.

  python -m apps.recc_monitor capture.f32
  python -m apps.recc_monitor --synthesize origination:5551234567:5551230000 out.f32
      (writes a synthetic capture, then decodes it — self-test mode)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def synthesize_capture(path: str, events, rx_offset=-160e3):
    """Write a 400 ksps capture with MS bursts at the rx_offset (where
    the reference's front end expects the reverse channel)."""
    import jax
    from amps_tpu.config import PipelineConfig
    from amps_tpu.tx import recc_ms
    from amps_tpu.tx.modulator import fm_modulate

    pipe = PipelineConfig()
    blocks = []
    lead = np.tile(np.array([1, -1], np.int8), 2000)
    for ev in events:
        parts = ev.split(":")
        if parts[0] == "origination":
            words = recc_ms.origination_words(parts[1], parts[2])
        elif parts[0] == "page_response":
            words = recc_ms.page_response_words(parts[1])
        elif parts[0] == "registration":
            esn = int(parts[2], 0) if len(parts) > 2 else None
            words = recc_ms.registration_words(parts[1], esn=esn)
        else:
            raise ValueError(parts[0])
        syms = recc_ms.burst_symbols(words, 0, pipe.sps)
        stream = np.concatenate([lead, syms, lead]).astype(np.int8)
        bb, _ = fm_modulate(stream, pipe)  # 400 ksps riq
        bb = np.asarray(bb)
        # place at rx_offset
        n = len(bb)
        t = np.arange(n) / pipe.rx_rate
        lo = np.stack([np.cos(2 * np.pi * rx_offset * t),
                       np.sin(2 * np.pi * rx_offset * t)], -1).astype(np.float32)
        shifted = np.stack([bb[:, 0] * lo[:, 0] - bb[:, 1] * lo[:, 1],
                            bb[:, 0] * lo[:, 1] + bb[:, 1] * lo[:, 0]], -1)
        blocks.append(shifted)
    cap = np.concatenate(blocks)
    cap.astype(np.float32).tofile(path)
    return len(cap)


def monitor(path: str, rx_offset=-160e3, threshold=0.5):
    from amps_tpu.config import PipelineConfig
    from amps_tpu.control import fields
    from amps_tpu.rx.correlator import find_and_extract
    from amps_tpu.rx.decoder import decode_bursts
    from amps_tpu.rx.frontend import rx_frontend

    pipe = PipelineConfig()
    raw = np.fromfile(path, dtype=np.float32)
    iq = raw.reshape(-1, 2)
    n = len(iq) - len(iq) % pipe.rx_decim
    demod, _ = rx_frontend(iq[:n], pipe, center_freq=rx_offset)
    demod = np.asarray(demod)
    sps = (pipe.rx_rate // pipe.rx_decim) // pipe.baud  # 10
    pad = np.zeros(3374 * sps, np.float32)
    starts, valid, quality, hard, _ = find_and_extract(
        np.concatenate([demod, pad]), sps, max_bursts=8,
        threshold=threshold)
    dec = decode_bursts(np.asarray(hard))
    found = 0
    for k in range(len(np.asarray(valid))):
        if not np.asarray(valid)[k]:
            continue
        found += 1
        words = np.asarray(dec.words)[k]
        ok = np.asarray(dec.word_ok)[k]
        print(f"burst @{int(np.asarray(starts)[k])} "
              f"q={float(np.asarray(quality)[k]):.2f} "
              f"words_ok={ok.astype(int).tolist()}")
        if ok[0]:
            wa = fields.RxWordA.parse(words[0])
            line = (f"  A: T={int(wa.T)} S={int(wa.S)} NAWC={wa.NAWC} "
                    f"MIN1={wa.MIN1:#08x}")
            if ok[1]:
                wb = fields.RxWordB.parse(words[1])
                line += (f" | B: ORDER={wb.ORDER:#x} ORDQ={wb.ORDQ} "
                         f"MIN={fields.calc_min(wa.MIN1, wb.MIN2)}")
            print(line)
    print(f"{found} burst(s) decoded from {len(iq)} samples")
    return found


def main(argv=None):
    p = argparse.ArgumentParser(description="RECC capture monitor")
    p.add_argument("capture", help="raw float32 interleaved IQ @400 ksps")
    p.add_argument("--synthesize", action="append", default=[],
                   help="write a synthetic capture first "
                        "(origination:MIN:DIALED | page_response:MIN | "
                        "registration:MIN[:ESN])")
    p.add_argument("--rx-offset", type=float, default=-160e3)
    p.add_argument("--platform", type=str, default=None)
    args = p.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from amps_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    if args.synthesize:
        n = synthesize_capture(args.capture, args.synthesize,
                               args.rx_offset)
        print(f"wrote {n} samples to {args.capture}")
    found = monitor(args.capture, args.rx_offset)
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())
