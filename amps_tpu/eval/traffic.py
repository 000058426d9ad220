"""Multi-mobile traffic simulator.

Generates reverse-band wideband blocks carrying a configurable mix of
mobile events (originations / page responses / registrations) across
the channel bank, for receiver load tests and call-handling soak tests.
Deterministic given the seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from amps_tpu.dsp import channelizer as chz
from amps_tpu.dsp.fm import fm_modulate_symbols
from amps_tpu.parallel.pipeline import MultichannelSpec
from amps_tpu.tx import recc_ms


@dataclasses.dataclass
class MobileEvent:
    kind: str          # origination | page_response | registration
    channel: int       # bank slot (reverse channel)
    start_hop: int
    min_str: str
    dialed: str = ""
    esn: Optional[int] = None

    def words(self):
        if self.kind == "origination":
            return recc_ms.origination_words(self.min_str, self.dialed,
                                             esn=self.esn)
        if self.kind == "page_response":
            return recc_ms.page_response_words(self.min_str)
        if self.kind == "registration":
            return recc_ms.registration_words(self.min_str, esn=self.esn)
        raise ValueError(self.kind)


def random_events(n_events: int, spec: MultichannelSpec, total_hops: int,
                  seed: int = 0, channels=None) -> List[MobileEvent]:
    """Events with non-overlapping bursts per channel."""
    rng = np.random.default_rng(seed)
    sps = spec.chan_sps
    burst_hops = (41 + 7 + 7 * 240) * 2 * sps + 64
    channels = list(channels if channels is not None
                    else range(spec.num_channels))
    next_free = {c: 200 for c in channels}
    kinds = ["origination", "page_response", "registration"]
    out: List[MobileEvent] = []
    for i in range(n_events):
        c = channels[int(rng.integers(len(channels)))]
        start = next_free[c] + int(rng.integers(0, 2000))
        if start + burst_hops + 200 > total_hops:
            continue
        next_free[c] = start + burst_hops + int(rng.integers(500, 1500))
        kind = kinds[int(rng.integers(3))]
        min_str = "".join(str(int(d)) for d in rng.integers(1, 9, 10))
        dialed = "".join(str(int(d)) for d in rng.integers(1, 9, 10))
        esn = int(rng.integers(1, 1 << 31)) if rng.random() < 0.5 else None
        out.append(MobileEvent(kind, c, start, min_str, dialed, esn))
    return out


def event_plane(events: List[MobileEvent], spec: MultichannelSpec,
                total_hops: int) -> np.ndarray:
    """(total_hops, M, 2) per-channel baseband with every event's RECC
    burst (DCC 0) FM-modulated at its start hop."""
    pipe = spec.pipe
    sens = 2 * np.pi * pipe.deviation_hz / pipe.chan_rate
    Y = np.zeros((total_hops, spec.num_channels, 2), np.float32)
    for ev in events:
        syms = recc_ms.burst_symbols(ev.words(), dcc=0, sps=spec.chan_sps)
        bb, _ = fm_modulate_symbols(syms.astype(np.int8), sens)
        bb = np.asarray(bb)
        n = min(len(bb), total_hops - ev.start_hop)
        Y[ev.start_hop: ev.start_hop + n, ev.channel] = bb[:n]
    return Y


def synthesize_reverse_band(events: List[MobileEvent],
                            spec: MultichannelSpec, total_hops: int,
                            noise_sigma: float = 0.0,
                            seed: int = 1) -> np.ndarray:
    """(total_hops * M/2, 2) wideband riq with all event bursts placed."""
    x, _ = chz.synthesize(event_plane(events, spec, total_hops),
                          spec.chz_spec,
                          chz.synthesizer_init(spec.chz_spec))
    x = np.asarray(x)
    if noise_sigma > 0:
        rng = np.random.default_rng(seed)
        x = x + rng.normal(0, noise_sigma, x.shape).astype(np.float32)
    return x
