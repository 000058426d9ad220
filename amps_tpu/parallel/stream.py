"""Sharded streaming receiver — the multi-chip mirror of
runtime/streamer.MultichannelReceiver.

``ShardedReceiver`` pushes whole wideband blocks through the sharded
streaming RX step (parallel/pipeline.make_sharded_rx_stream_step) and
reproduces the single-device receiver's host-side report discipline
exactly: per-row windows in time order, the same completeness guard
(device-side), the same dedup by absolute burst position, the same
carry-aware rssi ghost gate.  N pushed blocks therefore yield
bit-identical BurstReports to a MultichannelReceiver fed the same
continuous stream in row-sized blocks
(tests/test_parallel.py::test_sharded_stream_matches_single_device) —
the sharded equivalent of GR's continuous work() contract
(lib/focc_impl.cc:583-647 of the reference).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from amps_tpu.parallel.pipeline import (MultichannelSpec, full_demod_halo,
                                        make_sharded_rx_stream_step,
                                        sharded_stream_state)
from amps_tpu.runtime.streamer import (BurstReport, _compact_reports_rows,
                                       _flatten_full, _parse_compact,
                                       decode_dcc,
                                       deliver_supervision_frames)
from amps_tpu.rx import correlator


class ShardedReceiver:
    """Streaming wideband receiver over a ('time', 'chan') device mesh.

    Push blocks of (N, 2) wideband riq with N a multiple of
    tsize*csize*hop; each block is processed as ``tsize`` consecutive
    time-row windows, each with a carried left halo of
    ``demod_halo`` (default: the full trigger+capture overlap) so
    bursts spanning row or block boundaries decode completely.
    """

    def __init__(self, mesh: Mesh, spec: MultichannelSpec,
                 on_burst: Optional[Callable[[BurstReport], None]] = None,
                 max_bursts: int = 4, threshold: float = 0.55,
                 policy: str = "majority",
                 demod_halo: Optional[int] = None,
                 min_rssi: float = 0.0,
                 require_word_a: bool = True,
                 supervision_slots: tuple = (),
                 on_supervision: Optional[Callable] = None,
                 max_reports: int = 64):
        """``supervision_slots`` + ``on_supervision``: per-block SAT/ST
        supervision measurement on the given bank slots — the sharded
        mirror of MultichannelReceiver's RVC tap.  The sharded step
        returns the designated slots' fresh demod rows (device-side
        one-hot selection, parallel/pipeline.py); the host assembles
        them in time order, carries the sub-frame leftover across
        blocks exactly like the single-device receiver, and the
        callback receives (slot, levels (F, n_tones), power (F,)) per
        block, ready for BaseStation.push_supervision."""
        self.spec = spec
        self.M = spec.num_channels
        self.sps = spec.chan_sps
        self.ovr = (full_demod_halo(spec) if demod_halo is None
                    else demod_halo)
        self.min_rssi = min_rssi
        self.require_word_a = require_word_a
        self.on_burst = on_burst
        self.mesh = mesh
        self.max_bursts = max_bursts
        self.threshold = threshold
        self.policy = policy
        self.supervision_slots = tuple(supervision_slots)
        self.on_supervision = on_supervision
        self._sup_carry = (np.zeros((len(self.supervision_slots), 0),
                                    np.float32)
                           if self.supervision_slots else None)
        self.tsize = mesh.shape["time"]
        # device-side report compaction width PER TIME ROW (see
        # runtime/streamer._compact_reports): the host fetches at most
        # tsize*max_reports candidate slots per block
        self.max_reports = min(max_reports, self.M * max_bursts)
        self.report_overflows = 0
        self._hop = self.M // 2
        self._step = self._make_step()
        self._state = sharded_stream_state(spec, self.ovr)
        # consumed demod samples so far (NOT rows * current row length:
        # block lengths may vary between pushes — r2 advisor finding)
        self._nh_done = 0
        self._last_seen = np.full(self.M, -10**12, np.int64)
        self._last_block_len = 0
        self._flushed = False
        self.reports: List[BurstReport] = []

    def _make_step(self):
        return make_sharded_rx_stream_step(
            self.mesh, self.spec, self.ovr, self.max_bursts,
            self.threshold, self.policy, self.supervision_slots)

    def push(self, x_block) -> List[BurstReport]:
        """Process one wideband block; returns new (deduplicated)
        burst reports in time order."""
        assert not self._flushed, "push after flush()"
        x = jnp.asarray(x_block, jnp.float32)
        self._last_block_len = int(x.shape[0])
        out, self._state = self._step(x, self._state)
        host = self._fetch(out)
        self._push_supervision(host)
        return self._extract_reports(host, int(x.shape[0]))

    def _fetch(self, out) -> dict:
        """ONE batched device fetch of every consumed output — the
        COMPACTED burst reports (top-R candidate slots per time row,
        runtime/streamer._compact_reports_rows: O(tsize*R) bytes
        instead of the full (tsize, M, K, ...) planes), the supervision
        tap, and (transceiver) the TX wideband.  Sequential per-array
        fetches would cost one device round trip EACH
        (runtime/streamer._drain_one)."""
        comp = _compact_reports_rows(
            out["starts"], out["valid"], out["quality"], out["words"],
            out["word_ok"], out["bad_symbols"], out["dcc_bits"],
            out["rssi"], np.float32(self.min_rssi), self.max_reports,
            self.require_word_a)
        keys = [k for k in ("sup_demod", "tx_wideband") if k in out]
        fetched = jax.device_get((comp,) + tuple(out[k] for k in keys))
        host = dict(zip(keys, fetched[1:]))
        host["comp"] = fetched[0]
        # DEVICE references only (no fetch): the overflow fallback in
        # _extract_reports fetches the full planes if a row's n_valid
        # exceeds max_reports, so compaction can never drop a report
        host["full"] = tuple(out[k] for k in self._FULL_KEYS)
        return host

    _FULL_KEYS = ("starts", "valid", "quality", "words", "word_ok",
                  "bad_symbols", "dcc_bits", "rssi")

    def _push_supervision(self, host: dict) -> None:
        """Assemble the per-row supervision demod tap in time order and
        run the framed tone measurement — identical frame discipline to
        MultichannelReceiver._drain_one (sub-frame leftover carried
        across blocks so SAT/ST timers track wall time exactly)."""
        if not self.supervision_slots:
            return
        sup = np.asarray(host["sup_demod"], np.float32)
        # (tsize, S, nh_row) rows -> (S, tsize*nh_row) continuous stream
        dem = np.concatenate([sup[r] for r in range(sup.shape[0])],
                             axis=-1)
        self._sup_carry = deliver_supervision_frames(
            dem, self._sup_carry, self.spec,
            self.supervision_slots, self.on_supervision)

    def _extract_reports(self, host: dict,
                         n_samples: int) -> List[BurstReport]:
        """Host-side report discipline shared with ShardedTransceiver:
        per-row windows in time order, carry-aware rssi ghost gate,
        dedup by absolute position.  ``host["comp"]``: the compacted
        (meta (tsize, R, 6), payload (tsize, R, 274)) pair from one
        batched ``_fetch`` — the min_rssi/word-A gates already ran on
        device inside the compaction priority; the host re-applies them
        on the same f32 values (defense in depth) and keeps dedup,
        which needs cross-block history only the host has."""
        meta, payload = host["comp"]
        nh_row = (n_samples // self._hop) // self.tsize
        K = self.max_bursts
        # OVERFLOW fallback: if any row had more deliverable candidates
        # than max_reports, fetch the full (tsize, M, K, ...) planes
        # (device refs kept by _fetch, zero cost until now) so no
        # report is ever dropped — only this block pays the big fetch
        full = None
        if any(int(meta[r, 0, 5]) > meta.shape[1]
               for r in range(self.tsize)):
            # counter incremented AFTER the fallible fetch so a
            # replayed block cannot double-count
            full = jax.device_get(host["full"])
            self.report_overflows += 1
        new: List[BurstReport] = []
        for r in range(self.tsize):
            # absolute channel-sample index of this row's window[0]
            base = self._nh_done + r * nh_row - self.ovr
            if full is not None:
                cand = _flatten_full(tuple(p[r] for p in full))
            else:
                cand = _parse_compact(meta[r], payload[r])
            (idx, cvalid, starts, quality, rssi_pb,
             words, ok, bad, dccs) = cand
            # ascending flat (c*K+k) index == the uncompacted (c, k)
            # loop order, so delivery order and dedup retention match
            # the single-device receiver exactly
            for j in np.argsort(idx, kind="stable"):
                if not cvalid[j]:
                    continue
                c = int(idx[j]) // K
                # per-burst rssi over the candidate's own capture
                # extent (device-side, correlator.burst_rssi)
                rssi = float(rssi_pb[j])
                if rssi < self.min_rssi:
                    continue
                # invalid Word A: nothing dispatchable
                # (lib/recc_decode_impl.cc:107-110)
                if self.require_word_a and not ok[j, 0]:
                    continue
                abs_sample = base + int(starts[j])
                if abs(abs_sample - self._last_seen[c]) < \
                        correlator.CAPTURE_SYMBOLS * self.sps // 2:
                    continue
                self._last_seen[c] = abs_sample
                rep = BurstReport(c, abs_sample // self.sps,
                                  float(quality[j]),
                                  words[j], ok[j],
                                  bad[j], rssi=rssi,
                                  dcc=decode_dcc(dccs[j]))
                new.append(rep)
                if self.on_burst:
                    self.on_burst(rep)
        self._nh_done += self.tsize * nh_row
        self.reports.extend(new)
        return new

    def flush(self) -> List[BurstReport]:
        """End-of-stream drain: a burst pending in the carried overlap
        (capture extending past the last pushed block) is completed
        against trailing silence and reported — the sharded mirror of
        the reference's ring-buffer retention at shutdown
        (lib/recc_impl.cc:104-126).  Word repeats that were fully
        received decode normally; repeats lost to the stream end count
        as bad symbols, exactly as if the mobile stopped transmitting.
        After flush() the receiver is closed (push asserts)."""
        if self._flushed:
            return []
        self._flushed = True
        if self._last_block_len == 0:
            return []
        # one zero block of the last pushed block's length: satisfies the
        # step's shape contract by construction and its demod span covers
        # the full trigger+capture overlap for any pending burst
        zeros = np.zeros((self._last_block_len, 2), np.float32)
        self._flushed = False
        try:
            return self.push(zeros)
        finally:
            self._flushed = True


class ShardedTransceiver(ShardedReceiver):
    """Full-duplex sharded base-station stream: the multi-chip mirror of
    MultichannelTransmitter + MultichannelReceiver in ONE jitted step.

    TX side carries the reference's complete per-channel mix
    (grc/ampsbs.grc:841-904): FOCC superframes on control channels
    (host FoccStream word queues, exactly like MultichannelTransmitter),
    source baseband (voice+SAT / FVC blank-and-burst via
    runtime/sources.VoiceFvcSlot) on slots given a source, silence
    elsewhere.  RX side consumes external reverse-band wideband with the
    full ShardedReceiver report discipline.

    ``push(x_rx)`` -> (tx_wideband, reports): one block of the
    continuous TX stream (``superframes_per_block`` superframes — the
    smallest count whose hop stream divides the worker ring, so the
    wideband is gapless) and the decoded reverse-band bursts.
    """

    def __init__(self, mesh: Mesh, spec: MultichannelSpec,
                 system=None, control_channels=None,
                 superframes_per_block: Optional[int] = None,
                 **rx_kwargs):
        from math import gcd
        from amps_tpu.config import SystemConfig
        from amps_tpu.tx.focc import FoccStream

        self.system = system or SystemConfig()
        self._tx_step = None     # created lazily after super().__init__
        super().__init__(mesh, spec, **rx_kwargs)
        M = spec.num_channels
        Wk = mesh.shape["time"] * mesh.shape["chan"]
        ctrl = (list(control_channels) if control_channels is not None
                else list(range(M)))
        self.focc = {k: FoccStream(self.system, sps=self.sps)
                     for k in ctrl}
        any_stream = next(iter(self.focc.values()))
        F = any_stream.frames_per_superframe
        hops_per_sf = F * 463 * 2 * self.sps
        if superframes_per_block is None:
            superframes_per_block = Wk // gcd(hops_per_sf, Wk)
        assert superframes_per_block * hops_per_sf % Wk == 0
        self.superframes_per_block = superframes_per_block
        self.frames_per_block = F * superframes_per_block
        self.n_hops_block = hops_per_sf * superframes_per_block
        self._sources = {}
        self._mode = np.full((M,), 0, np.int32)          # TX_SILENT
        for k in ctrl:
            self._mode[k] = 1                            # TX_FOCC

    def _make_step(self):
        from amps_tpu.parallel.pipeline import make_sharded_bs_stream_step
        return make_sharded_bs_stream_step(
            self.mesh, self.spec, self.ovr, self.max_bursts,
            self.threshold, self.policy, rx_external=True,
            tx_sources=True, supervision_slots=self.supervision_slots)

    def set_channel_source(self, k: int, source) -> None:
        """Install a baseband source for slot k: source(n_hops) ->
        (n_hops, 2) riq (e.g. runtime/sources.VoiceFvcSlot)."""
        assert k not in self.focc, "slot already carries FOCC"
        self._sources[k] = source
        self._mode[k] = 2                                # TX_SOURCE

    def push(self, x_rx):
        """One full-duplex block: synthesize the next
        ``superframes_per_block`` superframes of the TX mix and decode
        one reverse-band block.  Returns (tx_wideband, reports)."""
        assert not self._flushed, "push after flush()"
        M = self.M
        wp = np.zeros((M, self.frames_per_block, 2, 28), np.uint8)
        for k, st in self.focc.items():
            wp[k] = np.concatenate(
                [st.next_word_pairs()
                 for _ in range(self.superframes_per_block)], axis=0)
        src = np.zeros((self.n_hops_block, M, 2), np.float32)
        for k, source in self._sources.items():
            src[:, k] = np.asarray(source(self.n_hops_block), np.float32)
        x = jnp.asarray(x_rx, jnp.float32)
        self._last_block_len = int(x.shape[0])
        out, self._state = self._step(
            jnp.asarray(wp), self._state, jnp.asarray(self._mode),
            jnp.asarray(src), x)
        host = self._fetch(out)
        self._push_supervision(host)
        reports = self._extract_reports(host, int(x.shape[0]))
        return np.asarray(host["tx_wideband"]), reports

    def flush(self) -> List[BurstReport]:
        """RX end-of-stream drain (see ShardedReceiver.flush).  The TX
        side synthesizes one more block while draining (it transmits
        continuously until shutdown, like the reference's always-on
        work() loop); that final wideband block is discarded."""
        if self._flushed:
            return []
        self._flushed = True
        if self._last_block_len == 0:
            return []
        zeros = np.zeros((self._last_block_len, 2), np.float32)
        self._flushed = False
        try:
            _, reports = self.push(zeros)
            return reports
        finally:
            self._flushed = True
