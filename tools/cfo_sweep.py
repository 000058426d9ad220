"""CFO sensitivity sweep: full FM loopback with a carrier frequency
offset applied to the RX IQ; measure detection + word success vs CFO."""
import numpy as np
import jax
import os, sys; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
jax.config.update("jax_platforms", "cpu")
from amps_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()

from amps_tpu import PipelineConfig
from amps_tpu.rx import correlator, decoder
from amps_tpu.rx.frontend import rx_frontend
from amps_tpu.tx import recc_ms
from amps_tpu.tx.modulator import fm_modulate

PIPE = PipelineConfig()

def run(cfo_hz, noise_sigma=0.0, seed=0):
    rng = np.random.default_rng(seed)
    words = recc_ms.origination_words("5551234567", "16505551234", esn=0x1234ABCD)
    syms = recc_ms.burst_symbols(words, dcc=0, sps=PIPE.sps)
    idle = np.tile(np.array([1, -1], np.int8), 500)
    tail = np.tile(np.array([1, -1], np.int8), 1500)
    stream = np.concatenate([idle, syms, tail]).astype(np.int8)
    iq, _ = fm_modulate(stream, PIPE)
    iq = np.asarray(iq)
    n = iq.shape[0]
    t = np.arange(n) / PIPE.tx_rate
    ph = 2 * np.pi * cfo_hz * t
    c, s = np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)
    rot = np.stack([iq[:, 0] * c - iq[:, 1] * s,
                    iq[:, 0] * s + iq[:, 1] * c], axis=-1)
    if noise_sigma:
        rot = rot + rng.normal(0, noise_sigma, rot.shape).astype(np.float32)
    demod, _ = rx_frontend(rot, PIPE, center_freq=0.0)
    demod = np.asarray(demod)
    sps_rx = (PIPE.rx_rate // PIPE.rx_decim) // PIPE.baud
    starts, valid, q, hard, soft = correlator.find_and_extract(
        demod, sps_rx, max_bursts=2, threshold=0.5)
    det = bool(np.asarray(valid)[0])
    if not det:
        return det, float(np.asarray(q)[0]), 0, 5
    dec = decoder.decode_bursts(np.asarray(hard)[0])
    ok = np.asarray(dec.word_ok)
    got = np.asarray(dec.words)
    exact = sum(ok[i] and np.array_equal(got[i], w) for i, w in enumerate(words))
    return det, float(np.asarray(q)[0]), int(exact), len(words)

print(f"{'CFO Hz':>8} {'det':>4} {'quality':>8} {'words':>6}  (clean)")
for cfo in [0, 250, 500, 1000, 1500, 2000, 2500, 3000, 4000, 5000]:
    det, q, exact, tot = run(cfo)
    print(f"{cfo:8d} {det!s:>4} {q:8.3f} {exact:>3}/{tot}")

print(f"\n{'CFO Hz':>8} {'det':>4} {'quality':>8} {'words':>6}  (sigma=0.05 ~14 dB, negative CFO too)")
for cfo in [-4000, -2500, -2000, 2000, 2500, 4000]:
    det, q, exact, tot = run(cfo, noise_sigma=0.05, seed=3)
    print(f"{cfo:8d} {det!s:>4} {q:8.3f} {exact:>3}/{tot}")
