"""Exactly-once soak: planted RECC bursts through the streaming receiver.

The correctness bar of the receiver at scale: a reverse band carrying
many mobile bursts (``traffic.random_events``) is synthesized on the
device, streamed through the normal receive path, and every report is
attributed to a planted event by WORD IDENTITY.  Pass means every event
is reported exactly once, on its own channel, bit-exact with the right
DCC; no report on a channel without a nearby event (ghost); and no
report near an event whose words differ from it (misdecode — with
word_ok=True that is a wrong word delivered as good).
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import jax
import jax.numpy as jnp

from amps_tpu.dsp import channelizer as chz
from amps_tpu.eval.traffic import MobileEvent, event_plane, random_events
from amps_tpu.parallel.pipeline import MultichannelSpec
from amps_tpu.runtime.streamer import (BurstReport, MultichannelReceiver,
                                       decode_dcc)
from amps_tpu.rx import correlator

# one RECC burst (dotting + sync + DCC + 7 x 5 repeats x 48 bits,
# Manchester) in symbols: the window that attributes a report to an event
BURST_SYMBOLS = (41 + 7 + 7 * 240) * 2


def synthesize_on_device(events: List[MobileEvent], spec: MultichannelSpec,
                         total_hops: int, noise_sigma: float,
                         seed: int = 1) -> jax.Array:
    """Wideband (total_hops * M/2, 2) on the device: the host places the
    small per-event basebands, the synthesis bank and the noise run on
    the device, and the wideband never returns to the host."""
    Y = jnp.asarray(event_plane(events, spec, total_hops))
    x, _ = chz.synthesize(Y, spec.chz_spec,
                          chz.synthesizer_init(spec.chz_spec))
    noise = jax.random.normal(jax.random.PRNGKey(seed), x.shape, jnp.float32)
    return x + jnp.float32(noise_sigma) * noise


def stream(rx, x, block: int) -> List[BurstReport]:
    """Push ``x`` through ``rx`` in hop-aligned blocks of at most
    ``block`` samples, then drain (flush with a zero tail so a burst
    pending in the carried overlap is completed)."""
    hop = rx.M // 2
    block -= block % hop
    reports: List[BurstReport] = []
    for off in range(0, int(x.shape[0]), block):
        reports += rx.push(x[off:off + block])
    return reports + rx.flush(pad_tail=True)


def account(events: List[MobileEvent], reports: Iterable[BurstReport],
            sps: int, dcc: int = 0) -> dict:
    """Attribute each report to a planted event by word identity."""
    want = [np.stack(ev.words()) for ev in events]
    matched = {i: [] for i in range(len(events))}
    ghosts, misdecodes = [], []
    for j, r in enumerate(reports):
        near = [i for i, ev in enumerate(events)
                if ev.channel == r.channel
                and abs(r.abs_symbol - ev.start_hop // sps) < BURST_SYMBOLS]
        hit = next((i for i in near
                    if np.asarray(r.word_ok)[:len(want[i])].all()
                    and np.array_equal(np.asarray(r.words)[:len(want[i])],
                                       want[i])
                    and r.dcc == dcc), None)
        if hit is not None:
            matched[hit].append(j)
            continue
        rec = {"chan": int(r.channel), "abs_symbol": int(r.abs_symbol),
               "quality": round(float(r.quality), 3),
               "rssi": round(float(r.rssi), 4),
               "word_ok": np.asarray(r.word_ok).astype(int).tolist()}
        (misdecodes if near else ghosts).append(rec)
    lost = [{"chan": int(events[i].channel), "hop": int(events[i].start_hop),
             "kind": events[i].kind}
            for i, js in matched.items() if not js]
    dups = {str(i): js for i, js in matched.items() if len(js) > 1}
    return {"n_events": len(events),
            "exact_once": sum(1 for js in matched.values() if len(js) == 1),
            "lost": lost, "duplicates": dups,
            "misdecodes": misdecodes, "ghosts": ghosts,
            "ok": not (lost or dups or misdecodes or ghosts)}


def clean_soak(spec: MultichannelSpec, n_events: int, total_hops: int,
               block: int, seed: int = 11, noise_sigma: float = 0.02,
               threshold: float = 0.6, max_bursts: int = 6,
               min_rssi: float = 0.05) -> dict:
    """The clean soak: ``n_events`` bursts over ``total_hops`` hops,
    streamed in ``block``-sample pushes through MultichannelReceiver
    (compacted report fetch, production gates).  Returns ``account``'s
    verdict plus the event count actually planted."""
    events = random_events(n_events, spec, total_hops, seed=seed)
    x = synthesize_on_device(events, spec, total_hops, noise_sigma)
    rx = MultichannelReceiver(spec, threshold=threshold,
                              max_bursts=max_bursts, min_rssi=min_rssi)
    res = account(events, stream(rx, x, block), spec.chan_sps)
    res["report_overflows"] = rx.report_overflows
    res["gates"] = {"threshold": threshold, "max_bursts": max_bursts,
                    "min_rssi": min_rssi,
                    "max_trigger_errors": spec.max_trigger_errors,
                    "repeat_gate": spec.repeat_gate,
                    "require_word_a": rx.require_word_a}
    return res


def closed_loop_reports(out: dict, n_hops: int, overlap: int, sps: int,
                        min_rssi: float) -> List[BurstReport]:
    """Reports from the stacked per-block planes of
    ``make_closed_loop_stream(..., rx_external=True)`` under the
    receiver's host discipline: rssi and word-A gates, then dedup of a
    burst found again in the next block's overlap window."""
    out = jax.device_get(out)
    M = out["valid"].shape[1]
    last_seen = np.full(M, -10**12, np.int64)
    keep = (out["valid"] & (out["rssi"] >= min_rssi)
            & out["word_ok"][..., 0].astype(bool))
    reports = []
    # argwhere walks (block, channel, slot) in order: the receiver's
    # delivery order, so dedup keeps the same copy it would
    for b, c, k in np.argwhere(keep):
        a = b * n_hops - overlap + int(out["starts"][b, c, k])
        if abs(a - last_seen[c]) < correlator.CAPTURE_SYMBOLS * sps // 2:
            continue
        last_seen[c] = a
        reports.append(BurstReport(
            int(c), a // sps, float(out["quality"][b, c, k]),
            out["words"][b, c, k], out["word_ok"][b, c, k],
            np.zeros(8, np.int32), rssi=float(out["rssi"][b, c, k]),
            dcc=decode_dcc(out["dcc_bits"][b, c, k])))
    return reports
