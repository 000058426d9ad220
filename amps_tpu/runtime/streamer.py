"""Streaming executor — the L3 runtime replacing the GR scheduler.

The reference relies on GNU Radio's thread-per-block scheduler with ring
buffers between blocks (SURVEY.md §1 L3).  Here the device pipeline is a
single fused program per block, and the host runtime's job is:

* feed the TX side superframe-by-superframe, mixing per-channel sources
  (FOCC / FVC blank-and-burst / voice+SAT) per the station's mute state;
* stream wideband RX blocks through the jitted pipeline, carry all
  filter/channelizer state, keep burst-detection overlap across blocks,
  deduplicate bursts found twice in overlapping windows, and hand decoded
  words to the control plane;
* do it all with bounded memory and without data-dependent recompiles
  (block shapes are static).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from amps_tpu.config import SystemConfig

from amps_tpu.dsp import channelizer as chz
from amps_tpu.dsp.fm import (fsk_manchester_baseband,
                             quadrature_demod_planar)
from amps_tpu.parallel.pipeline import MultichannelSpec
from amps_tpu.rx import correlator, decoder
from amps_tpu.tx.focc import FoccStream, focc_frame_bits
from amps_tpu.tx.recc_ms import CODED_DCC

# minimum-Hamming-distance decode of the 7-bit coded DCC (553 2.6.1.2)
_DCC_CODES = np.array([CODED_DCC[d] for d in range(4)], np.int32)


def decode_dcc(bits7) -> int:
    b = np.asarray(bits7, np.int32).reshape(1, 7)
    return int(np.argmin(np.abs(_DCC_CODES - b).sum(axis=1)))


def _compact_core(starts, valid, quality, words, ok, bad, dccs, rssi,
                  min_rssi, R: int, require_word_a: bool):
    """Device-side report compaction: select the top-R candidate slots
    (deliverable first, then by trigger quality) and gather their report
    fields, so the host fetches O(R) bytes instead of the whole
    (M, K, ...) report planes.

    'Deliverable' mirrors the host gates (min_rssi, require_word_a)
    EXACTLY, on the same f32 values the host would compare: a
    burst-heavy block in the bf16 FM-capture ghost regime
    (correlator.MAX_TRIGGER_ERRORS) can hold >R valid candidates where high-quality ghosts — which the
    host rssi/word-A gates would discard anyway — would otherwise evict
    a genuine weak burst from the top-R slots on device.  n_valid (and
    so report_overflows) counts only gate-passing candidates.

    At M=1024/K=4 the full planes are ~1.2 MB/block; the report fetch is
    the only per-block device->host transfer on the RX hot path, and
    bursts are sparse (the reference handles ONE burst at a time,
    lib/recc_decode_impl.cc).  Exact whenever n_valid <= R; overflow is
    reported via the returned n_valid so the caller can count it.

    Returns TWO arrays (every fetched array costs a device round trip,
    so the report fetch is packed into the minimum transfer count):
      meta:    f32 (R, 6)  [flat_idx, valid, start, quality, rssi,
                            n_valid] — all integer payloads < 2^24, so
                            f32 carries them exactly;
      payload: u8 (R, 274) [words(252) | ok(7) | bad(8) | dccs(7)] —
                            bad-pair counts are <= 240, u8-exact.
    flat_idx is the c*K+k slot index (host iterates in ascending idx
    order to reproduce the uncompacted (c, k) report order exactly)."""
    M, K = valid.shape
    deliverable = valid & (rssi.astype(jnp.float32) >=
                           jnp.float32(min_rssi))
    if require_word_a:
        deliverable = deliverable & ok[..., 0].astype(bool)
    prio = jnp.where(deliverable, 1.0 + quality.astype(jnp.float32), 0.0)
    vals, idx = jax.lax.top_k(prio.reshape(-1), R)

    def sel(a):
        return a.reshape((M * K,) + a.shape[2:])[idx]

    meta = jnp.stack([
        idx.astype(jnp.float32),
        (vals > 0.0).astype(jnp.float32),
        sel(starts).astype(jnp.float32),
        sel(quality).astype(jnp.float32),
        sel(rssi).astype(jnp.float32),
        jnp.broadcast_to(jnp.sum(deliverable.astype(jnp.int32)),
                         (R,)).astype(jnp.float32),
    ], axis=1)
    payload = jnp.concatenate([
        sel(words).reshape(R, -1).astype(jnp.uint8),
        sel(ok).reshape(R, -1).astype(jnp.uint8),
        sel(bad).reshape(R, -1).astype(jnp.uint8),
        sel(dccs).reshape(R, -1).astype(jnp.uint8),
    ], axis=1)
    return meta, payload


_compact_reports = jax.jit(_compact_core,
                           static_argnames=("R", "require_word_a"))


def deliver_supervision_frames(dem, carry, spec, slots, callback):
    """Shared supervision frame discipline (single-device AND sharded
    receivers — keep it single-source, r5 review finding): prepend the
    previous block's sub-frame leftover, measure whole 10 ms frames,
    deviation-normalize so tone amplitudes come out in the TX units
    SupervisionConfig's nominals are stated in, fan out per slot.
    ``dem``: (S, n) float32 demod rows, NEW samples only.  Returns the
    new sub-frame carry."""
    from amps_tpu.rx.voice import supervision_levels
    fs = float(spec.pipe.chan_rate)
    frame = int(fs * 0.01)                                # 10 ms frames
    dem = np.concatenate([carry, dem], axis=-1)
    nf = dem.shape[-1] // frame
    new_carry = dem[:, nf * frame:]
    if nf >= 1:
        sens = 2.0 * np.pi * spec.pipe.deviation_hz / fs
        lv, pw = supervision_levels(
            jnp.asarray(dem[:, : nf * frame]) / sens, frame, fs)
        lv, pw = np.asarray(lv), np.asarray(pw)
        if callback:
            for i, slot in enumerate(slots):
                callback(slot, lv[i], pw[i])
    return new_carry


def _parse_compact(meta, payload):
    """Unpack ONE compacted (meta (R, 6), payload (R, 274)) pair into
    the flat candidate arrays the delivery loops consume:
    (idx, cvalid, starts, quality, rssi, words, ok, bad, dccs).
    The payload layout is defined by _compact_core; this is its ONLY
    decoder (shared by MultichannelReceiver and the sharded
    receivers — keep layout knowledge single-source)."""
    idx = meta[:, 0].astype(np.int64)
    cvalid = meta[:, 1] > 0.5
    starts = meta[:, 2].astype(np.int64)
    quality = np.asarray(meta[:, 3], np.float32)
    rssi = np.asarray(meta[:, 4], np.float32)
    R = len(idx)
    words = payload[:, :252].reshape(R, 7, 36)
    ok = payload[:, 252:259] > 0
    bad = payload[:, 259:267]
    dccs = payload[:, 267:274]
    return idx, cvalid, starts, quality, rssi, words, ok, bad, dccs


def _flatten_full(planes):
    """Flatten fetched FULL (M, K, ...) report planes into the same
    tuple _parse_compact returns — the lossless overflow fallback path
    (idx = ascending flat c*K+k, so delivery order is identical)."""
    f_st, f_v, f_q, f_w, f_ok, f_bad, f_dcc, f_rs = planes
    MK = np.asarray(f_v).size
    idx = np.arange(MK)
    cvalid = np.asarray(f_v).reshape(MK)
    starts = np.asarray(f_st).reshape(MK).astype(np.int64)
    quality = np.asarray(f_q, np.float32).reshape(MK)
    rssi = np.asarray(f_rs, np.float32).reshape(MK)
    words = np.asarray(f_w).reshape(MK, 7, 36)
    ok = np.asarray(f_ok).reshape(MK, 7).astype(bool)
    bad = np.asarray(f_bad).reshape(MK, -1)
    dccs = np.asarray(f_dcc).reshape(MK, 7)
    return idx, cvalid, starts, quality, rssi, words, ok, bad, dccs


@functools.partial(jax.jit, static_argnames=("R", "require_word_a"))
def _compact_reports_rows(starts, valid, quality, words, ok, bad, dccs,
                          rssi, min_rssi, R: int, require_word_a: bool):
    """Per-time-row compaction for the sharded receiver: vmap of
    _compact_core over the leading (tsize,) row axis, so the multi-chip
    report fetch is O(tsize*R) bytes instead of the full
    (tsize, M, K, ...) planes — the sharded mirror of the single-device
    compaction (parallel/stream.py)."""
    return jax.vmap(
        lambda s, v, q, w, o, b, d, r_: _compact_core(
            s, v, q, w, o, b, d, r_, min_rssi, R, require_word_a)
    )(starts, valid, quality, words, ok, bad, dccs, rssi)


# hop_parity is STATIC: production blocks are whole-hop and even-hop
# (stream block lengths are multiples of M samples), so parity is 0
# forever and a constant parity constant-folds the (Nh, M) (-1)^{kn}
# sign plane into the analysis transform; an odd-hop block would merely
# compile the parity-1 variant once.
@functools.partial(jax.jit, static_argnames=("M", "T", "sps", "max_bursts",
                                             "want_demod", "bf16", "split",
                                             "fold", "io_bf16", "corr_bf16",
                                             "trig_gate", "hop_parity"))
def _rx_stream_block(x, hist, demod_carry, prev_iq, pw_carry,
                     M: int, T: int, sps: int, max_bursts: int,
                     threshold: float, want_demod: bool = False,
                     bf16: bool = False, split: int = 0,
                     fold: str = "conv", io_bf16: bool = False,
                     corr_bf16: bool = False,
                     trig_gate: int = correlator.MAX_TRIGGER_ERRORS,
                     hop_parity: int = 0):
    """One streaming RX step with carried state.

    x: (N, 2) wideband block.  hist: (L-P, 2) analyzer history.
    demod_carry: (M, OVR) demod overlap from the previous block.
    prev_iq: (M, 2) last channel sample for discriminator continuity.
    pw_carry: (M, OVR) envelope-power-series overlap (per-burst rssi
    over the same window coordinates as demod).
    Returns (starts, valid, quality, hard, new_hist,
    new_carry, new_prev, n_new_demod, chan_power, rssi, new_pw_carry,
    demod?); the caller advances hop parity host-side.
    """
    h = jnp.asarray(chz.prototype_taps(M, T))
    x_ext = jnp.concatenate([hist, x], axis=0)
    ypl = chz._analyze_block_chmajor(x_ext, h, M, T, hop_parity, bf16,
                                     split, fold, planar=True)  # (2, M, Nh)
    yr, yi = ypl[0], ypl[1]
    Nh = yr.shape[-1]
    # chan_power rides the demod pass (|x·conj(x[-1])| is the
    # instantaneous power of a constant-envelope FM signal): lets
    # callers reject FM "capture" ghosts (an idle channel demodulating
    # a strong neighbor's sideband leakage decodes cleanly but at
    # ~20+ dB lower power) with zero extra reads of the channel planes
    demod_new, (lr, li), pw_new = quadrature_demod_planar(
        yr, yi, 1.0, (prev_iq[:, 0], prev_iq[:, 1]),
        return_power="series")                             # (M, Nh)
    chan_power = jnp.sqrt(jnp.mean(pw_new, axis=-1))
    last = jnp.stack([lr, li], axis=-1)
    demod = jnp.concatenate([demod_carry, demod_new], axis=-1)
    # demod-aligned per-block power means, computed PIECEWISE so the
    # (M, Nh) power series stays a fusion intermediate (never
    # concatenated/materialized)
    pw_blk = correlator.window_power_blocks([pw_carry, pw_new])
    # one integrate-and-dump pass shared by symbol-domain detection and
    # capture (see correlator.find_bursts_phases); no zero pad — the
    # extractor zero-fills past the stream tail, and the completeness
    # guard below drops tail-cut bursts (re-found in the next block)
    # io_bf16/corr_bf16: same bf16 data/correlation planes as the block
    # pipeline (parallel/pipeline.py); the carried demod state and the
    # debug tap stay f32
    dsp = demod.astype(jnp.bfloat16) if io_bf16 else demod
    phases = correlator.symbol_phase_streams(dsp, sps)
    starts, valid, quality = correlator.find_bursts_phases(
        phases, sps, max_bursts, threshold, out_bf16=corr_bf16)
    # only report bursts whose full capture fits this window; one cut off
    # by the block edge is re-found complete in the next block's overlap
    valid = valid & (starts + correlator.CAPTURE_SYMBOLS * sps
                     <= demod.shape[-1])
    # per-burst band power over each candidate's own capture extent —
    # the block mean cannot separate an FM-capture ghost from a real
    # burst sharing the block (correlator.burst_rssi)
    rssi = correlator.burst_rssi_blocks(pw_blk, starts, sps)
    # trigger verification rides the capture extraction's plane read
    # (lead symbols; a standalone gate would re-read phases)
    lead = correlator.TRIGGER_SYMBOLS if trig_gate >= 0 else 0
    ext = correlator.extract_from_phases(
        phases, starts, sps,
        hard_dtype=jnp.bfloat16 if io_bf16 else jnp.uint8, lead=lead)
    hard = ext[0]
    if trig_gate >= 0:
        valid = correlator.apply_trigger_gate_soft(valid, ext[2],
                                                   trig_gate, starts, sps)
    ovr = demod_carry.shape[-1]
    new_carry = demod[:, -ovr:] if ovr > 0 else demod[:, :0]
    if ovr == 0:
        new_pw_carry = pw_new[:, :0]
    elif Nh >= ovr:
        new_pw_carry = pw_new[:, -ovr:]
    else:
        new_pw_carry = jnp.concatenate([pw_carry[:, Nh:], pw_new], axis=-1)
    new_hist = x_ext[-(M * T - M // 2):]
    return (starts, valid, quality, hard, new_hist,
            new_carry, last, Nh, chan_power, rssi, new_pw_carry,
            demod_new if want_demod else None)


def make_closed_loop_stream(spec: MultichannelSpec, nblocks: int,
                            frames: int = 2, max_bursts: int = 2,
                            threshold: float = 0.55, chunks: int = 1,
                            rx_external: bool = False):
    """Fused full-duplex closed-loop stream: ONE jitted program that
    lax.scans ``nblocks`` consecutive superframe blocks through the
    complete TX -> RF -> RX pipeline (FOCC framing -> FSK -> synthesis
    channelizer -> wideband -> analysis channelizer -> FM demod ->
    trigger correlate -> capture -> BCH decode) with ALL carried state
    device-resident — zero host involvement between blocks, so the
    sustained number does not depend on host transfers (the reference's
    implied always-on realtime operation, grc/ampsbs.grc samp_rate).

    Returns (run, block_samples): ``run(word_pairs)`` -> (n_valid,
    quality_max, n_word_ok) scalars; word_pairs (M, frames, 2, 28).
    Sustained Msps = nblocks * block_samples / wall_time.

    ``chunks`` > 1: split the scan into ``chunks`` back-to-back jitted
    invocations of nblocks/chunks iterations each, with the carried
    state DONATED between them — the host enqueues all chunk dispatches
    before the first finishes, while every block's state stays
    device-resident.  Block sequence and counts are identical to the
    single scan (tests/test_runtime.py::test_chunked_closed_loop_matches_single).

    ``rx_external``: the full-duplex shape with real reverse traffic.
    ``run(word_pairs, x_rx)`` with x_rx (nblocks, block_samples, 2):
    each iteration transmits one TX block AND decodes one reverse-band
    block in place of the FOCC loopback, and returns the per-block
    report planes stacked over blocks — starts/valid/quality/rssi
    (nblocks, M, K), words (nblocks, M, K, 7, 36), word_ok, dcc_bits,
    and the TX block's peak magnitude tx_peak (nblocks,).  starts index
    each block's demod window, which begins one trigger+capture overlap
    ((TRIGGER_SYMBOLS + CAPTURE_SYMBOLS) * sps samples) before the block,
    so a burst crossing a block boundary is found whole in the next
    window; rssi is the per-burst band power the receiver's ghost gate
    reads (correlator.burst_rssi).  Needs blocks of at least that
    overlap (frames >= 4) so every burst fits one window.
    """
    import jax
    from jax import lax
    from amps_tpu.rx import correlator as _corr

    M, T = spec.num_channels, spec.taps_per_phase
    sps = spec.chan_sps
    L, P = M * T, M // 2
    split = (chz.default_split(M) if spec.transform_split < 0
             else spec.transform_split)
    h = jnp.asarray(chz.prototype_taps(M, T))
    sens = 2.0 * np.pi * spec.pipe.deviation_hz / spec.pipe.chan_rate
    ovr = (_corr.TRIGGER_SYMBOLS + _corr.CAPTURE_SYMBOLS) * sps
    n_hops = frames * 463 * 2 * sps
    block_samples = n_hops * P
    # blocks are whole frames (463 bits * 2 Manchester * sps hops), so
    # the per-block hop count is even and hop parity is structurally 0
    # at every block start — a CONSTANT parity constant-folds the
    # (Nh, M) (-1)^{kn} sign plane into the transform
    assert n_hops % 2 == 0
    assert not rx_external or (n_hops >= ovr and chunks <= 1), \
        (n_hops, ovr, chunks)

    def _state0():
        st = {
            "syn_carry": jnp.zeros((L - P, 2), jnp.float32),
            "hist": jnp.zeros((L - P, 2), jnp.float32),
            "carry": jnp.zeros((M, min(ovr, n_hops)), jnp.float32),
            "prev": jnp.zeros((M, 2), jnp.float32),
        }
        if rx_external:
            st["pw_carry"] = jnp.zeros((M, ovr), jnp.float32)
        return st

    # framing + FSK hoisted out of the scan (the same superframe
    # repeats; the synthesis/analysis/decode chain still does full
    # per-block work on carried state)
    @jax.jit
    def _prep(word_pairs):
        bits = focc_frame_bits(word_pairs)                 # (M, nb)
        bb, _ = fsk_manchester_baseband(bits, sps, sens)   # (M, n, 2)
        return jnp.swapaxes(bb, 0, 1)                      # (n, M, 2)

    def _make_body(Y):
        def body(st, x_rx):
            x, syn_tail = chz._synthesize_block(
                Y, h, M, T, 0, st["syn_carry"],
                spec.transform_bf16, split)
            x_ext = jnp.concatenate([st["hist"],
                                     x if x_rx is None else x_rx], axis=0)
            ypl = chz._analyze_block_chmajor(
                x_ext, h, M, T, 0, spec.transform_bf16,
                split, spec.fold, planar=True)             # (2, M, Nh)
            prev = (st["prev"][:, 0], st["prev"][:, 1])
            if x_rx is None:
                demod_new, (lr, li) = quadrature_demod_planar(
                    ypl[0], ypl[1], 1.0, prev)
            else:
                demod_new, (lr, li), pw_new = quadrature_demod_planar(
                    ypl[0], ypl[1], 1.0, prev, return_power="series")
            demod = jnp.concatenate([st["carry"], demod_new], axis=-1)
            dsp = demod.astype(jnp.bfloat16) if spec.io_bf16 else demod
            phases = correlator.symbol_phase_streams(dsp, sps)
            starts, valid, quality = correlator.find_bursts_phases(
                phases, sps, max_bursts, threshold,
                out_bf16=spec.corr_bf16)
            valid = valid & (starts + correlator.CAPTURE_SYMBOLS * sps
                             <= demod.shape[-1])
            lead = (correlator.TRIGGER_SYMBOLS
                    if spec.max_trigger_errors >= 0 else 0)
            ext = correlator.extract_from_phases(
                phases, starts, sps,
                hard_dtype=jnp.bfloat16 if spec.io_bf16 else jnp.uint8,
                lead=lead)
            hard = ext[0]
            if spec.max_trigger_errors >= 0:
                valid = correlator.apply_trigger_gate_soft(
                    valid, ext[2], spec.max_trigger_errors, starts, sps)
            dec = decoder.decode_bursts(hard, repeat_gate=spec.decode_repeat_gate)
            nc = st["carry"].shape[-1]
            st2 = {
                "syn_carry": syn_tail,
                "hist": x_ext[-(L - P):],
                "carry": demod[:, -nc:] if nc else demod[:, :0],
                "prev": jnp.stack([lr, li], axis=-1),
            }
            if x_rx is None:
                return st2, (jnp.sum(valid),
                             jnp.max(quality.astype(jnp.float32)),
                             jnp.sum(dec.word_ok))
            pw_blk = correlator.window_power_blocks([st["pw_carry"],
                                                     pw_new])
            st2["pw_carry"] = pw_new[:, -ovr:]
            return st2, {
                "starts": starts, "valid": valid,
                "quality": quality.astype(jnp.float32),
                "rssi": correlator.burst_rssi_blocks(pw_blk, starts, sps),
                "words": dec.words, "word_ok": dec.word_ok,
                "dcc_bits": dec.dcc_bits,
                "tx_peak": jnp.max(jnp.abs(x)),
            }

        return body

    if rx_external:
        @jax.jit
        def run(word_pairs, x_rx):
            assert x_rx.shape == (nblocks, block_samples, 2), x_rx.shape
            _, outs = lax.scan(_make_body(_prep(word_pairs)), _state0(),
                               x_rx)
            return outs

        return run, block_samples

    if chunks <= 1:
        @jax.jit
        def run(word_pairs):
            Y = _prep(word_pairs)
            # unroll=2: less per-iteration scan overhead
            _, (v, q, wok) = lax.scan(_make_body(Y), _state0(), None,
                                      length=nblocks, unroll=2)
            return jnp.sum(v), jnp.max(q), jnp.sum(wok)

        return run, block_samples

    per = nblocks // chunks
    assert per * chunks == nblocks, (nblocks, chunks)

    # donate the carried state: each chunk writes its successor's state
    # into the same buffers, and the host can enqueue every chunk before
    # the first finishes
    @functools.partial(jax.jit, donate_argnums=(1,))
    def _chunk(Y, st):
        st2, (v, q, wok) = lax.scan(_make_body(Y), st, None,
                                    length=per, unroll=2)
        return st2, (jnp.sum(v), jnp.max(q), jnp.sum(wok))

    def run(word_pairs):
        Y = _prep(word_pairs)
        st = _state0()
        outs = []
        for _ in range(chunks):
            st, o = _chunk(Y, st)
            outs.append(o)
        return (jnp.sum(jnp.stack([o[0] for o in outs])),
                jnp.max(jnp.stack([o[1] for o in outs])),
                jnp.sum(jnp.stack([o[2] for o in outs])))

    return run, block_samples


@dataclasses.dataclass
class BurstReport:
    channel: int
    abs_symbol: int          # absolute Manchester-symbol index of capture
    quality: float
    words: np.ndarray        # (7, 36)
    word_ok: np.ndarray      # (7,)
    bad_symbols: np.ndarray  # (8,)
    rssi: float = 0.0        # mean channel band power over the block
    dcc: int = -1            # decoded digital color code (the reference
                             # prints it, lib/recc_decode_impl.cc:98)


class MultichannelReceiver:
    """Streaming wideband receiver over the channelizer bank."""

    def __init__(self, spec: MultichannelSpec,
                 on_burst: Optional[Callable[[BurstReport], None]] = None,
                 max_bursts: int = 4, threshold: float = 0.55,
                 policy: str = "majority",
                 tap_demod_path: Optional[str] = None,
                 pipeline_depth: int = 1,
                 min_rssi: float = 0.0,
                 require_word_a: bool = True,
                 supervision_slots: tuple = (),
                 on_supervision: Optional[Callable] = None,
                 max_reports: int = 64):
        """``tap_demod_path``: append raw per-channel FM-demod float32
        blocks to this file — the debug-tap role of the reference's
        /tmp/recc.syms file sink (grc/recctest.grc) and AMPS_DEBUG
        stream dumps (lib/focc_impl.cc:132-135).

        ``pipeline_depth``: device blocks kept in flight.  With depth
        K > 1, ``push(block_i)`` only forces the host sync for block
        i-K, so the device computes block i while the host decodes
        burst reports of earlier blocks (double buffering); call
        ``flush()`` to drain the tail.  Burst callbacks are then
        delayed by up to K blocks.

        ``policy``: 5-repeat word combining — "majority" (default;
        bit-wise majority vote before BCH, the spec-recommended
        combining: +0.28 word-success at +2 dB/sample SNR, docs/BER.md)
        or "first_ok" (reference-exact sequential fallback,
        lib/recc_decode_impl.cc:100-107).

        ``supervision_slots`` + ``on_supervision``: per-block SAT/ST
        supervision measurement on the given bank slots — the demod
        plane is already computed, so rx.voice.supervision_levels adds
        two small matmuls; the callback receives
        (slot, levels (F, 4), power (F,)) per block, ready for
        BaseStation.push_supervision.

        ``min_rssi``: drop reports whose mean channel band power is
        below this level.  FM is amplitude-invariant, so an idle
        channel "capturing" a strong neighbor's sideband leakage can
        decode cleanly at high correlation quality — but at 20+ dB
        lower band power than any real transmission; this is the
        knob that rejects those ghosts (BurstReport.rssi carries the
        measured value either way).

        ``require_word_a``: drop reports whose Word A failed BCH decode
        — the reference's early return on an invalid Word A
        (lib/recc_decode_impl.cc:107-110); no dispatch path can use a
        burst without it.  Adjacent-channel FM splatter that trips the
        trigger but carries no decodable payload is filtered here."""
        self.spec = spec
        M, T = spec.num_channels, spec.taps_per_phase
        self.M, self.T = M, T
        self.sps = spec.chan_sps
        self.max_bursts = max_bursts
        self._split = (chz.default_split(M) if spec.transform_split < 0
                       else spec.transform_split)
        self.threshold = threshold
        self.min_rssi = min_rssi
        self.require_word_a = require_word_a
        # device-side report compaction width (see _compact_reports):
        # the host fetches at most this many candidate slots per block
        self.max_reports = min(max_reports, M * max_bursts)
        self.report_overflows = 0
        self.policy = policy
        self.on_burst = on_burst
        # overlap: a burst (trigger + capture) must fit in carry so one
        # spanning a block boundary is fully inside the next window
        self.ovr = (correlator.TRIGGER_SYMBOLS
                    + correlator.CAPTURE_SYMBOLS) * self.sps
        self._hist = jnp.zeros((M * T - M // 2, 2), jnp.float32)
        self._parity = 0          # host int: static arg (see _rx_stream_block)
        self._carry = jnp.zeros((M, self.ovr), jnp.float32)
        self._pw_carry = jnp.zeros((M, self.ovr), jnp.float32)
        self._prev = jnp.zeros((M, 2), jnp.float32)
        self._abs_base = -self.ovr  # demod[0]'s absolute channel-sample idx
        self._last_seen = np.full(M, -10**12, np.int64)
        # rssi is measured per burst over the candidate's own capture
        # extent (pw_carry keeps the power series continuous across
        # blocks), which subsumes the old prev-block power vouching: a
        # burst deferred into the next block's carry is judged on its
        # own samples wherever they were received (the r2 420-burst
        # finding), and an idle-channel ghost cannot ride a louder
        # burst's block power (the stream64 probe finding)
        self.reports: List[BurstReport] = []
        self._tap = open(tap_demod_path, "ab") if tap_demod_path else None
        self.supervision_slots = tuple(supervision_slots)
        self.on_supervision = on_supervision
        # leftover demod samples (< one 10 ms frame) from the previous
        # block's supervision measurement: carried so supervision frames
        # are continuous across block boundaries (without it every block
        # drops n % frame_len samples and SAT/ST fade timers accrue ~5%
        # slower than wall time at typical block sizes)
        self._sup_carry = (np.zeros((len(self.supervision_slots), 0),
                                    np.float32)
                           if self.supervision_slots else None)
        self.depth = max(1, pipeline_depth)
        self._inflight: List[dict] = []
        self._last_block_len = 0
        # non-hop-multiple tail buffered between pushes (see push)
        self._residue = None

    def push(self, x_block) -> List[BurstReport]:
        """Process one wideband block ((N, 2), any N); returns new
        (deduplicated) burst reports — of this block at depth 1, of
        blocks up to ``pipeline_depth``-1 behind otherwise.

        The analyzer consumes whole hops (M//2 samples); a
        non-hop-multiple tail is BUFFERED and prepended to the next
        push (r5 review finding: it used to be silently dropped from
        the analysis while staying in the channelizer history, skewing
        the polyphase alignment of every later block — and
        RingIQSource/FileIQSource readily produce such lengths).
        Hop-aligned callers (all production paths) pay nothing."""
        x = jnp.asarray(x_block, jnp.float32)
        if self._residue is not None and int(self._residue.shape[0]):
            x = jnp.concatenate([jnp.asarray(self._residue, jnp.float32),
                                 x], axis=0)
        self._residue = None
        rem = int(x.shape[0]) % (self.M // 2)
        if rem:
            self._residue = x[int(x.shape[0]) - rem:]
            x = x[: int(x.shape[0]) - rem]
        if int(x.shape[0]) == 0:
            return []
        self._last_block_len = int(x.shape[0])
        (starts, valid, quality, hard, self._hist,
         self._carry, self._prev, _, chan_power, rssi, self._pw_carry,
         demod) = _rx_stream_block(
            x, self._hist, self._carry, self._prev,
            self._pw_carry,
            self.M, self.T, self.sps, self.max_bursts, self.threshold,
            want_demod=(self._tap is not None
                        or bool(self.supervision_slots)),
            bf16=self.spec.transform_bf16, split=self._split,
            fold=self.spec.fold, io_bf16=self.spec.io_bf16,
            corr_bf16=self.spec.corr_bf16,
            trig_gate=self.spec.max_trigger_errors,
            hop_parity=self._parity)
        dec = decoder.decode_bursts(hard, policy=self.policy, repeat_gate=self.spec.decode_repeat_gate)
        # compact the (M, K, ...) report planes to the top-R candidates
        # ON DEVICE (the host fetch is the RX hot path's only
        # device->host transfer; see _compact_reports)
        comp = _compact_reports(starts, valid, quality, dec.words,
                                dec.word_ok, dec.bad_symbols,
                                dec.dcc_bits, rssi,
                                np.float32(self.min_rssi),
                                self.max_reports, self.require_word_a)
        # supervision slots are sliced out ON DEVICE: the whole (M, Nh)
        # demod plane is 33.5 MB per block at M=1024, the sliced rows
        # ~0.5 MB
        sup_dem = (jnp.asarray(demod)[
            jnp.asarray(self.supervision_slots, jnp.int32)]
            if self.supervision_slots and demod is not None else None)
        # enqueue DEVICE arrays only — no host sync here; the sync
        # happens when the entry is drained, depth-1 blocks later.
        # ``full`` keeps the uncompacted report planes ALIVE on device
        # (no fetch — just references): if the drain finds n_valid > R
        # it falls back to fetching them, so compaction can never drop
        # a report, only cost an extra round trip in synthetic overload
        self._inflight.append(dict(comp=comp,
                                   full=(starts, valid, quality,
                                         dec.words, dec.word_ok,
                                         dec.bad_symbols, dec.dcc_bits,
                                         rssi),
                                   demod=demod if self._tap is not None
                                   else None,
                                   sup_dem=sup_dem,
                                   abs_base=self._abs_base))
        self._parity = (self._parity + int(x.shape[0]) // (self.M // 2)) % 2
        self._abs_base += x.shape[0] // (self.M // 2)
        out: List[BurstReport] = []
        while len(self._inflight) >= self.depth:
            out.extend(self._drain_one(self._inflight.pop(0)))
        return out

    def flush(self, pad_tail: bool = False) -> List[BurstReport]:
        """Drain every in-flight block (end of stream).

        ``pad_tail``: first push one zero block so a burst pending in
        the carried overlap (capture extending past the final block) is
        completed against trailing silence and reported — the
        reference's ring-buffer retention at shutdown
        (lib/recc_impl.cc:104-126); mirrors ShardedReceiver.flush()."""
        out: List[BurstReport] = []
        if pad_tail and self._last_block_len:
            out.extend(self.push(np.zeros((self._last_block_len, 2),
                                          np.float32)))
        elif self._residue is not None and int(self._residue.shape[0]):
            # flush a buffered sub-hop tail against just enough zeros
            # to complete one hop (push concatenates the residue)
            pad = (self.M // 2) - int(self._residue.shape[0]) % (self.M // 2)
            out.extend(self.push(np.zeros((pad, 2), np.float32)))
        while self._inflight:
            out.extend(self._drain_one(self._inflight.pop(0)))
        if self._tap is not None:
            self._tap.flush()
        return out

    def close(self) -> None:
        """Release host-side resources (the demod tap file — buffered
        tail data would otherwise be lost if the process exits without
        this receiver being garbage-collected).  Idempotent."""
        if self._tap is not None:
            self._tap.close()
            self._tap = None

    def _drain_one(self, e: dict) -> List[BurstReport]:
        # the batched report fetch runs FIRST: it is where a device
        # failure materializes (an asynchronous failure surfaces at the
        # array fetch), and ResilientReceiver's replay assumes a failed
        # block delivered NO supervision frames — delivering them
        # before a fetch that then raises would double-deliver on
        # replay (r4 review finding)
        meta, payload = jax.device_get(e["comp"])
        if int(meta[0, 5]) > len(meta):
            # OVERFLOW: more deliverable candidates than max_reports.
            # Fall back to the full (M, K, ...) report planes (kept
            # alive on device, zero cost until now) so no report is
            # ever dropped — only this block pays the big fetch.  Never
            # reached outside synthetic overload (the reference handles
            # ONE burst at a time, lib/recc_decode_impl.cc); the
            # counter lets soaks and deployments size max_reports and
            # is incremented AFTER the fallible fetch so a replayed
            # block cannot double-count (the r4 ordering discipline).
            cand = _flatten_full(jax.device_get(e["full"]))
            self.report_overflows += 1
        else:
            cand = _parse_compact(meta, payload)
        (idx, cvalid, starts, quality, rssi_pb,
         words, ok, bad, dccs) = cand
        if self._tap is not None and e["demod"] is not None:
            np.asarray(e["demod"]).astype(np.float32).tofile(self._tap)
        if self.supervision_slots and e["sup_dem"] is not None:
            # sup_dem is the device-sliced supervision rows of
            # demod_new: NEW samples only, contiguous and
            # non-overlapping across blocks
            dem = np.asarray(jax.device_get(e["sup_dem"]), np.float32)
            self._sup_carry = deliver_supervision_frames(
                dem, self._sup_carry, self.spec,
                self.supervision_slots, self.on_supervision)
        # (reports were fetched above in ONE batched device_get:
        # sequential np.asarray calls cost one device round trip EACH)
        quality = np.asarray(quality, np.float32)
        rssi_pb = np.asarray(rssi_pb, np.float32)
        out = []
        # ascending flat (c*K+k) index == the uncompacted (c, k) loop
        # order, so delivery order and dedup retention are unchanged
        for r in np.argsort(idx, kind="stable"):
            if not cvalid[r]:
                continue
            c = int(idx[r]) // self.max_bursts
            # per-burst rssi: measured over THIS candidate's own
            # capture extent on device (correlator.burst_rssi), so
            # carry-region bursts are judged on their own samples
            # and an idle-channel ghost cannot ride a louder
            # neighbor burst's block power
            rssi = float(rssi_pb[r])
            if rssi < self.min_rssi:
                continue
            # invalid Word A: nothing dispatchable in this burst
            # (lib/recc_decode_impl.cc:107-110 returns here)
            if self.require_word_a and not ok[r, 0]:
                continue
            abs_sample = e["abs_base"] + int(starts[r])
            # dedup: same burst found again in the overlap region
            if abs(abs_sample - self._last_seen[c]) < \
                    correlator.CAPTURE_SYMBOLS * self.sps // 2:
                continue
            self._last_seen[c] = abs_sample
            rep = BurstReport(c, abs_sample // self.sps,
                              float(quality[r]),
                              words[r], ok[r], bad[r],
                              rssi=rssi,
                              dcc=decode_dcc(dccs[r]))
            out.append(rep)
            if self.on_burst:
                self.on_burst(rep)
        self.reports.extend(out)
        return out


class MultichannelTransmitter:
    """Streaming wideband transmitter: one FOCC stream per control
    channel; remaining bank slots empty (voice/FVC sources plug into
    ``set_channel_source``)."""

    def __init__(self, spec: MultichannelSpec,
                 system: Optional[SystemConfig] = None,
                 control_channels: Optional[List[int]] = None):
        self.spec = spec
        self.system = system or SystemConfig()
        M = spec.num_channels
        self.M = M
        self.sps = spec.chan_sps
        ctrl = control_channels if control_channels is not None else list(range(M))
        self.focc: Dict[int, FoccStream] = {
            k: FoccStream(self.system, sps=self.sps) for k in ctrl}
        self._sources: Dict[int, Callable[[int], np.ndarray]] = {}
        self._state = chz.synthesizer_init(spec.chz_spec)
        self._sens = 2.0 * np.pi * spec.pipe.deviation_hz / spec.pipe.chan_rate
        self._accum = {k: 0 for k in ctrl}

    def set_channel_source(self, k: int,
                           source: Callable[[int], np.ndarray]) -> None:
        """Install a baseband source for slot k: source(n) -> (n, 2) riq
        (e.g. a voice+SAT generator or an FVC burst stream)."""
        self._sources[k] = source

    def next_block(self) -> np.ndarray:
        """Produce one superframe's worth of wideband samples."""
        n_hops = None
        chans = {}
        for k, st in self.focc.items():
            pairs = st.next_word_pairs()
            bits = focc_frame_bits(pairs)
            # Manchester bits are DC-balanced so the accumulator carry is
            # a fixed point — carried anyway for interface clarity
            bb, acc = fsk_manchester_baseband(bits, self.sps, self._sens,
                                              self._accum[k])
            self._accum[k] = acc
            chans[k] = bb
            n_hops = bb.shape[0]
        assert n_hops is not None, "no control channels configured"
        # batched scatter: ONE stack + ONE .at[].set per group, not one
        # device dispatch per channel (r5 review finding: the default
        # ctrl=range(M) at M=1024 issued ~1024 sequential eager .at[]
        # dispatches)
        Y = jnp.zeros((n_hops, self.M, 2), jnp.float32)
        if chans:
            ks = sorted(chans)
            Y = Y.at[:, jnp.asarray(ks, jnp.int32), :].set(
                jnp.stack([chans[k] for k in ks], axis=1))
        if self._sources:
            sk = sorted(self._sources)
            src_stack = np.stack(
                [np.asarray(self._sources[k](n_hops), np.float32)
                 for k in sk], axis=1)
            Y = Y.at[:, jnp.asarray(sk, jnp.int32), :].set(
                jnp.asarray(src_stack))
        x, self._state = chz.synthesize(Y, self.spec.chz_spec, self._state)
        return x
