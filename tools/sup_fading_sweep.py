"""Supervision robustness under Rayleigh fading (round 4): the voice
soaks use clean tones + AWGN; a real reverse voice channel FADES.  This
sweep measures, per (doppler, SNR): the per-frame SAT-ok rate, the
LONGEST continuous SAT-loss run (what the 5 s fade timeout must ride
out), and the false-ST frame rate (spurious signaling is call-control
poison — a phantom 1.8 s run would release a live call).

Writes tools/sup_fading_sweep.out and regenerates the docs/BER.md
supervision section.  CPU (the measurement math is the production
supervision_levels path; chip parity is covered by the voice soaks).
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
from amps_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
import jax.numpy as jnp  # noqa: E402

from amps_tpu.config import PipelineConfig  # noqa: E402
from amps_tpu.control.supervision import (SupervisionConfig,  # noqa: E402
                                          classify_frames)
from amps_tpu.dsp.fm import fm_modulate, quadrature_demod  # noqa: E402
from amps_tpu.eval import channel  # noqa: E402
from amps_tpu.rx.voice import supervision_levels  # noqa: E402

OUT = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "sup_fading_sweep.out"), "a", buffering=1)


def emit(**kw):
    OUT.write(json.dumps(kw) + "\n")
    print(kw, flush=True)


pipe = PipelineConfig()
fs = float(pipe.chan_rate)
sens = 2.0 * np.pi * pipe.deviation_hz / fs
cfg = SupervisionConfig()
DUR = 20.0
n = int(DUR * fs)
t = np.arange(n) / fs
FRAME = int(fs * cfg.frame_s)

# two signals: conversation-state RVC (SAT SCC=1 + voice, NO ST — the
# false-ST question) and ringing RVC (SAT + ST — the missed-ST dual
# that sets the answer arm/drop debounce thresholds)
m_conv = (0.05 * np.cos(2 * np.pi * 6000.0 * t)
          + 0.3 * np.cos(2 * np.pi * 1000.0 * t)).astype(np.float32)
m_ring = (0.05 * np.cos(2 * np.pi * 6000.0 * t)
          + 0.05 * np.cos(2 * np.pi * 10_000.0 * t)).astype(np.float32)
iq_conv = np.asarray(fm_modulate(jnp.asarray(m_conv), sens)[0])
iq_ring = np.asarray(fm_modulate(jnp.asarray(m_ring), sens)[0])

emit(event="start", dur_s=DUR, frame_ms=cfg.frame_s * 1e3,
     gates=dict(sat_on_ratio=cfg.sat_on_ratio, margin_db=cfg.sat_margin_db,
                st_on_ratio=cfg.st_on_ratio, st_guard_ratio=cfg.st_guard_ratio,
                min_power=cfg.min_power, max_power=cfg.max_power,
                carrier_guard_max=cfg.carrier_guard_max))

rng = np.random.default_rng(5)


def longest(mask):
    worst = run = 0
    for v in mask:
        run = run + 1 if v else 0
        worst = max(worst, run)
    return worst


def measure(iq_clean, fd, snr_db):
    """Fade + noise one signal and evaluate THE PRODUCTION GATES
    (control/supervision.classify_frames — single source of truth)."""
    gain = channel.rayleigh_gain(n, fs, fd, rng)
    faded = np.asarray(channel.apply_gain(iq_clean, gain), np.float32)
    sigma = np.sqrt(10.0 ** (-snr_db / 10.0) / 2.0)
    iq = faded + rng.normal(0, sigma, faded.shape).astype(np.float32)
    demod = np.asarray(quadrature_demod(jnp.asarray(iq))[0]) / sens
    lv, pw = supervision_levels(jnp.asarray(demod), FRAME, fs)
    return classify_frames(np.asarray(lv), np.asarray(pw), 1, cfg)


results, ring_results = [], []
for fd in (5.0, 77.0):
    for snr_db in (20.0, 10.0, 6.0):
        carrier, sat_ok, st_on = measure(iq_conv, fd, snr_db)
        rec = dict(fd_hz=fd, snr_db=snr_db,
                   sat_ok_rate=round(float(sat_ok.mean()), 3),
                   longest_sat_loss_s=round(longest(~sat_ok) * cfg.frame_s, 2),
                   false_st_rate=round(float(st_on.mean()), 4),
                   longest_st_run_s=round(longest(st_on) * cfg.frame_s, 2),
                   frames=int(len(sat_ok)))
        results.append(rec)
        emit(event="point", **rec)
        carrier, sat_ok, st_on = measure(iq_ring, fd, snr_db)
        rrec = dict(fd_hz=fd, snr_db=snr_db,
                    carrier_rate=round(float(carrier.mean()), 3),
                    st_on_given_carrier=round(
                        float(st_on.sum() / max(carrier.sum(), 1)), 3),
                    longest_st_miss_carrier_s=round(
                        longest(carrier & ~st_on) * cfg.frame_s, 2))
        ring_results.append(rrec)
        emit(event="ring_point", **rrec)

# ---- regenerate the BER.md supervision section ------------------------
lines = [
    "",
    "## Supervision under Rayleigh fading",
    "",
    "Conversation-state RVC (SAT SCC=1 + voice, no ST) through Clarke",
    "fading + AWGN, measured with the production gates (guard-bin",
    "carrier gate, SAT margin, ST dominance; tools/sup_fading_sweep.py,",
    f"{DUR:.0f} s per point).  The question the 553 §2.4.2 fade timeout",
    "must answer: how long do fades LOOK like SAT loss, and does fading",
    "ever fake signaling-tone frames?",
    "",
    "| fd (Hz) | SNR (dB) | SAT-ok frames | longest SAT loss | false-ST frames | longest ST run |",
    "|---|---|---|---|---|---|",
]
for r in results:
    lines.append(f"| {r['fd_hz']:.0f} | {r['snr_db']:.0f} "
                 f"| {r['sat_ok_rate']:.3f} "
                 f"| {r['longest_sat_loss_s']:.2f} s "
                 f"| {r['false_st_rate']:.4f} "
                 f"| {r['longest_st_run_s']:.2f} s |")
lines += [
    "",
    "And the DUAL — a genuinely RINGING signal (SAT + ST) through the",
    "same channels: how reliably is real ST detected, and how long are",
    "its detection gaps?  These two run-length bounds set the answer",
    "debounce thresholds (SupervisionConfig.st_answer_arm_s /",
    "st_drop_confirm_s):",
    "",
    "| fd (Hz) | SNR (dB) | carrier frames | ST-on given carrier | longest ST miss (carrier) |",
    "|---|---|---|---|---|",
] + [
    f"| {r['fd_hz']:.0f} | {r['snr_db']:.0f} | {r['carrier_rate']:.3f} "
    f"| {r['st_on_given_carrier']:.3f} "
    f"| {r['longest_st_miss_carrier_s']:.2f} s |"
    for r in ring_results
] + [
    "",
    "Even at 6 dB under fast fading the longest continuous SAT loss",
    "stays far below the 5 s release timeout (deep fades are short at",
    "77 Hz, and at walking pace the envelope rarely stays in a null",
    "for seconds), so fading alone cannot drop a live call.  Fade",
    "EDGES do produce isolated false-ST frames (the discriminator",
    "noise burst while power/guard still read carrier-ish), but they",
    "never STRING: the longest false-ST run stays an order of",
    "magnitude below the 0.25 s flash minimum, and the supervisor's",
    "run-length logic (flash needs a 0.25-0.8 s run, release 1.8 s)",
    "means isolated frames produce zero events — fading cannot fake",
    "answer/flash/release signaling.  On the ringing dual, ST is",
    "detected in >= 59% of carrier frames even at the worst point and",
    "its detection gaps never exceed 0.05 s — hence the answer",
    "debounce: 0.2 s ACCUMULATED ring arms (false frames cannot reach",
    "it, faded real ringing reaches it in ~0.4 s), and the drop is",
    "confirmed over 0.1 s of consecutive quiet-with-carrier (2x the",
    "longest measured miss gap, so a fade dip cannot fake an early",
    "answer).",
    "Regression: tests/test_supervision.py::test_supervision_rides_out_fading.",
    "",
]
path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs", "BER.md")
doc = open(path).read()
marker = "\n## Supervision under Rayleigh fading"
if marker in doc:
    # splice ONLY this section: keep any later "## " sections intact
    start = doc.index(marker)
    nxt = doc.find("\n## ", start + 1)
    tail = doc[nxt:] if nxt != -1 else ""
    doc = doc[:start] + tail
open(path, "w").write(doc + "\n".join(lines))
emit(event="done", doc="docs/BER.md section written")
