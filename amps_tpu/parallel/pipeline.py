"""The multichannel base-station pipeline, single-device and sharded.

Data flow ("the model", cf. SURVEY.md §3.4/§3.5 but over M channels at
once instead of three hand-placed mixers):

  TX: per-channel FOCC word pairs (C, F, 2, 28)
      -> superframe symbols (C, n_sym)          [tx.focc, batched]
      -> FSK baseband at 60 ksps (C, n, 2)      [chan_sps = 3]
      -> synthesis channelizer -> wideband (n*M/2... , 2) at M x 30 kHz

  RX: wideband (N, 2)
      -> analysis channelizer -> (Nh, M, 2) per-channel baseband @60k
      -> quadrature demod (C, Nh)
      -> trigger correlation + burst capture    [rx.correlator, sps=3]
      -> batched BCH word decode                [rx.decoder]

Sharded version: shard_map over a ('time', 'chan') mesh.  The wideband
stream is sharded along time with an L-P sample halo (ppermute); the
per-channel stage shards channels across 'chan' ranks and exchanges a
demod-sample halo along 'time' so bursts spanning shard boundaries are
caught (the overlap discipline of lib/recc_impl.cc:104-107 d_windowsz,
reborn as device collectives).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from amps_tpu.config import PipelineConfig
from amps_tpu.dsp import channelizer as chz
from amps_tpu.dsp.fm import fsk_manchester_baseband, quadrature_demod_planar
from amps_tpu.parallel.halo import (halo_exchange_left_carry,
                                    overlap_add_with_carry)
from amps_tpu.rx import correlator, decoder
from amps_tpu.tx.focc import focc_frame_bits


@dataclasses.dataclass(frozen=True)
class MultichannelSpec:
    num_channels: int = 64        # C = channels actually carrying FOCC
    taps_per_phase: int = 8
    pipe: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    # channel-transform tuning (dsp/channelizer.py): bf16 matmuls with
    # f32 accumulation; two-stage split (-1 auto / 0 dense / M2); fold
    # strategy ("conv" grouped-conv or "shift" unrolled elementwise)
    transform_bf16: bool = False
    transform_split: int = -1
    fold: str = "conv"
    # io_bf16: carry the analyzer output planes and the demod stream in
    # bfloat16 (all arithmetic stays f32-accumulated): the per-channel
    # stages are bandwidth-bound, so this halves their data-plane bytes;
    # decode parity is covered by tests/test_bf16.py.
    io_bf16: bool = False
    # corr_bf16: also write the trigger-correlation matmul outputs and
    # the derived quality plane (the find stage's dominant HBM traffic)
    # in bfloat16; quality only feeds a threshold compare + argmax.
    corr_bf16: bool = False
    # post-capture trigger verification gate (correlator.trigger_errors):
    # candidates whose sliced trigger mismatches the exact 74-symbol
    # pattern in more than this many places are invalid — the memmem
    # exactness of lib/recc_impl.cc:118, restored after correlation
    # admitted rare pre-burst false triggers in the 64-block streaming
    # soak.  <0 disables.
    max_trigger_errors: int = correlator.MAX_TRIGGER_ERRORS
    # erasure gate for 5-repeat word combining (rx/decoder.py): a repeat
    # with more than this many Manchester violations (of 48 pairs) is
    # excluded from BCH selection and the majority vote — kills
    # word_ok=True aliased decodes of noise repeats (the (48,36) code
    # "decodes" pure noise with p~0.29; observed in the 64-block
    # streaming soak).  <0 disables.
    repeat_gate: int = 6

    @property
    def decode_repeat_gate(self) -> Optional[int]:
        return None if self.repeat_gate < 0 else int(self.repeat_gate)

    @property
    def chz_spec(self) -> chz.ChannelizerSpec:
        return chz.ChannelizerSpec(self.num_channels, self.taps_per_phase,
                                   self.pipe.channel_spacing_hz)

    @property
    def chan_sps(self) -> int:
        return self.pipe.chan_sps  # 3 samples/Manchester symbol @ 60k


# ---------------------------------------------------------------------------
# single-device pipeline pieces (shared by the sharded version)
# ---------------------------------------------------------------------------

def tx_multichannel_block(word_pairs, spec: MultichannelSpec):
    """(C, F, 2, 28) word pairs -> wideband riq ((F*463*2*sps)*M/2 .. , 2).

    Every channel transmits its own FOCC superframe (the ">=1000 channels"
    configuration of BASELINE.json is C FOCCs in parallel).
    """
    sps = spec.chan_sps
    bits = focc_frame_bits(word_pairs)                   # (C, nb)
    sens = 2.0 * np.pi * spec.pipe.deviation_hz / spec.pipe.chan_rate
    bb, _ = fsk_manchester_baseband(bits, sps, sens)     # (C, n, 2)
    Y = jnp.swapaxes(bb, 0, 1)                           # (n, C, 2)
    x, _ = chz.synthesize(Y, spec.chz_spec,
                          chz.synthesizer_init(spec.chz_spec))
    return x


@functools.partial(jax.jit,
                   static_argnames=("spec", "max_bursts", "policy"))
def rx_multichannel_block(x, spec: MultichannelSpec, max_bursts: int = 2,
                          threshold: float = 0.55,
                          policy: str = "first_ok"):
    """Wideband (N, 2) — or planar (2, N) planes — -> per-channel
    decoded RECC bursts.  Planar input (fold="bank" only) skips the
    on-device interleaved->planar transpose; SDR adapters can deliver
    planar planes directly (runtime/sdr.py).

    Returns dict with starts/valid/quality (C, K) and decoded words
    (C, K, 7, 36) + ok (C, K, 7).
    """
    planar_in = x.ndim == 2 and x.shape[0] == 2 and x.shape[1] != 2
    ypl, _ = chz.analyze(x, spec.chz_spec,
                         chz.analyzer_init(spec.chz_spec,
                                           planar_in=planar_in),
                         chmajor=True, bf16=spec.transform_bf16,
                         split=spec.transform_split,
                         fold=spec.fold, planar=True,
                         planar_in=planar_in)  # (2, C, Nh)
    if spec.io_bf16:
        ypl = ypl.astype(jnp.bfloat16)
    yr, yi = ypl[0], ypl[1]
    # chan_power rides the demod pass (same conjugate-product read):
    # per-channel mean band power rejects FM "capture" ghosts — an
    # idle channel demodulating a strong neighbor's (or numerical)
    # leakage decodes cleanly (FM is amplitude-invariant) but at
    # 20+ dB lower power; see runtime/streamer.BurstReport.rssi
    demod, _, pw_series = quadrature_demod_planar(
        yr, yi, return_power="series")               # (C, Nh) each
    # blocked in place: the series never hits HBM (the blocked sum
    # fuses into the demod producer instead of a materialized re-read)
    pw_blk = correlator.window_power_blocks([pw_series])
    chan_power = correlator.power_from_blocks(pw_blk,
                                              pw_series.shape[-1])
    if spec.io_bf16:
        demod = demod.astype(jnp.bfloat16)
    sps = spec.chan_sps
    # ONE integrate-and-dump pass feeds both symbol-domain trigger
    # detection and burst capture.  No zero pad: the one-hot extractor
    # zero-fills past the stream tail (a capture cut off by the block
    # edge decodes to word_ok=False, same as with an explicit pad)
    phases = correlator.symbol_phase_streams(demod, sps)
    starts, valid, quality = correlator.find_bursts_phases(
        phases, sps, max_bursts, threshold, out_bf16=spec.corr_bf16)
    # trigger verification rides the capture extraction's plane read
    # (lead symbols) instead of re-reading phases
    lead = correlator.TRIGGER_SYMBOLS if spec.max_trigger_errors >= 0 else 0
    ext = correlator.extract_from_phases(
        phases, starts, sps,
        hard_dtype=jnp.bfloat16 if spec.io_bf16 else jnp.uint8, lead=lead)
    hard = ext[0]
    if spec.max_trigger_errors >= 0:
        valid = correlator.apply_trigger_gate_soft(
            valid, ext[2], spec.max_trigger_errors, starts, sps)
    dec = decoder.decode_bursts(hard, policy, spec.decode_repeat_gate)  # batched (C, K, ...)
    rssi = correlator.burst_rssi_blocks(pw_blk, starts, sps)
    return {
        "starts": starts, "valid": valid, "quality": quality,
        "words": dec.words, "word_ok": dec.word_ok,
        "dcc_bits": dec.dcc_bits, "bad_symbols": dec.bad_symbols,
        "chan_power": chan_power, "rssi": rssi,
    }


@functools.partial(jax.jit,
                   static_argnames=("spec", "max_bursts", "policy"))
def rx_multichannel_block_batched(xs, spec: MultichannelSpec,
                                  max_bursts: int = 2,
                                  threshold: float = 0.55,
                                  policy: str = "first_ok"):
    """Batched small-bank RX: (G, N, 2) — G independent wideband
    streams through G copies of the M-channel bank in ONE program.

    A small bank's (Nh, M) transform matmuls and (M, ...) planes are
    too narrow to fill the device.  A realistic narrow-band deployment
    runs SEVERAL
    independent bands per chip; batching them restores full-width
    operands (G*M effective channels) with zero cross-band coupling.
    Every stage below is batch-polymorphic, so this is the single-
    stream XLA path with a leading G axis.
    """
    M = spec.num_channels
    T = spec.taps_per_phase
    G = xs.shape[0]
    hist = jnp.zeros((G, M * T - M // 2, 2), jnp.float32)
    x_ext = jnp.concatenate([hist, jnp.asarray(xs, jnp.float32)], axis=1)
    h = jnp.asarray(chz.prototype_taps(M, T))
    split = (chz.default_split(M) if spec.transform_split < 0
             else spec.transform_split)
    ypl = chz._analyze_block_chmajor(
        x_ext, h, M, T, 0, spec.transform_bf16, split, spec.fold,
        planar=True)                                     # (G, 2, M, Nh)
    if spec.io_bf16:
        ypl = ypl.astype(jnp.bfloat16)
    demod, _, pw_series = quadrature_demod_planar(
        ypl[:, 0], ypl[:, 1], return_power="series")     # (G, M, Nh)
    pw_blk = correlator.window_power_blocks([pw_series])
    chan_power = correlator.power_from_blocks(pw_blk, pw_series.shape[-1])
    if spec.io_bf16:
        demod = demod.astype(jnp.bfloat16)
    sps = spec.chan_sps
    phases = correlator.symbol_phase_streams(demod, sps)
    starts, valid, quality = correlator.find_bursts_phases(
        phases, sps, max_bursts, threshold, out_bf16=spec.corr_bf16)
    lead = correlator.TRIGGER_SYMBOLS if spec.max_trigger_errors >= 0 else 0
    ext = correlator.extract_from_phases(
        phases, starts, sps,
        hard_dtype=jnp.bfloat16 if spec.io_bf16 else jnp.uint8, lead=lead)
    hard = ext[0]
    if spec.max_trigger_errors >= 0:
        valid = correlator.apply_trigger_gate_soft(
            valid, ext[2], spec.max_trigger_errors, starts, sps)
    dec = decoder.decode_bursts(hard, policy, spec.decode_repeat_gate)  # (G, C, K, ...)
    rssi = correlator.burst_rssi_blocks(pw_blk, starts, sps)
    return {
        "starts": starts, "valid": valid, "quality": quality,
        "words": dec.words, "word_ok": dec.word_ok,
        "dcc_bits": dec.dcc_bits, "bad_symbols": dec.bad_symbols,
        "chan_power": chan_power, "rssi": rssi,
    }


# ---------------------------------------------------------------------------
# sharded pipeline (shard_map over ('time', 'chan'))
# ---------------------------------------------------------------------------
#
# Layout: the wideband stages (synthesis, analysis) mix ALL channels, so
# their natural parallel axis is time.  Both mesh axes act as ONE
# flattened time ring of tsize*csize workers for the wideband stages
# (worker w = tidx*csize + cidx handles the w-th contiguous sub-block;
# halos/overlap-add ride the flattened ring), and an all_to_all inside
# each time row reshards hops->channels for the per-channel stages: time
# row r then holds the r-th contiguous span of Nh_row demod samples with
# channels sharded across 'chan' ranks.  No rank duplicates wideband
# work.
#
# Streaming: every step carries explicit state exactly like the
# single-device streamer (runtime/streamer._rx_stream_block) — analyzer
# history and synthesis overlap-add carry at the flattened-ring level,
# per-channel IQ carry (demod-discriminator continuity + the full
# trigger+capture burst-overlap window) at the time-row level, and a hop
# parity scalar.  Successive step calls are bit-continuous: the N-block
# sharded stream decodes identically to the single-device
# MultichannelReceiver on the same continuous wideband
# (tests/test_parallel.py::test_sharded_stream_matches_single_device).


def full_demod_halo(spec: MultichannelSpec) -> int:
    """Demod-sample halo that guarantees a burst spanning a time-shard
    (or block) boundary is complete inside the right-hand window: the
    trigger + capture extent, the sharded mirror of the reference's
    d_windowsz retention (lib/recc_impl.cc:104-107) and of the
    single-device streamer's carry (runtime/streamer.py ovr)."""
    return (correlator.TRIGGER_SYMBOLS
            + correlator.CAPTURE_SYMBOLS) * spec.chan_sps


def sharded_stream_state(spec: MultichannelSpec, demod_halo: int):
    """Zero-initialized carried state for the sharded stream steps.

    hist:     (L-P, 2)  analyzer history = previous block's global tail
    iq_carry: (2, M, demod_halo+1) per-channel IQ tail of the previous
              block (halo+1: one extra sample seeds the discriminator)
    syn_carry:(L-P, 2)  synthesis overlap-add tail (TX streaming)
    parity:   ()        RX hop parity at the block start
    tx_parity:()        TX synthesis hop parity — separate from the RX
              parity because with rx_external the two streams advance
              by different hop counts (r2 advisor finding)
    """
    M, T = spec.num_channels, spec.taps_per_phase
    L, Phop = M * T, M // 2
    return {
        "hist": jnp.zeros((L - Phop, 2), jnp.float32),
        "iq_carry": jnp.zeros((2, M, demod_halo + 1), jnp.float32),
        "syn_carry": jnp.zeros((L - Phop, 2), jnp.float32),
        "parity": jnp.zeros((), jnp.int32),
        "tx_parity": jnp.zeros((), jnp.int32),
    }


def _mesh_consts(mesh: Mesh, spec: MultichannelSpec):
    M, T = spec.num_channels, spec.taps_per_phase
    tsize, csize = mesh.shape["time"], mesh.shape["chan"]
    assert M % csize == 0
    split = (chz.default_split(M) if spec.transform_split < 0
             else spec.transform_split)
    return M, T, M * T, M // 2, tsize, csize, M // csize, split


def make_sharded_rx_stream_step(mesh: Mesh, spec: MultichannelSpec,
                                demod_halo: Optional[int] = None,
                                max_bursts: int = 2,
                                threshold: float = 0.55,
                                policy: str = "first_ok",
                                supervision_slots: tuple = ()):
    """Jitted sharded streaming RX step: (x, state) -> (out, new_state).

    x: (N, 2) wideband riq, N % (tsize*csize*P) == 0, sharded over the
    flattened worker ring.  state: from ``sharded_stream_state``.
    out: dict of global arrays — starts/valid/quality (tsize, M, K) with
    starts local to each row's extended demod window (absolute demod
    sample = row*Nh_row - demod_halo + start), words (tsize, M, K, 7, 36),
    word_ok, chan_power (tsize, M).

    demod_halo defaults to ``full_demod_halo(spec)``; bursts whose
    capture extends past a row's window are marked invalid and re-found
    complete by the right neighbor (or the next block) via the halo —
    the same completeness discipline as the single-device streamer.

    ``supervision_slots``: static tuple of bank slots whose FRESH demod
    samples are additionally returned as out["sup_demod"]
    (tsize, n_slots, Nh_row) f32 — the sharded mirror of the
    single-device receiver's RVC supervision tap (runtime/streamer.py
    supervision_slots; the reference's RVC chain,
    grc/ampsbs_rvc.grc second freq_xlating_fir -> NBFM RX).  Selection
    is a one-hot (n_slots, c_loc) matmul on each chan rank + a psum —
    the full (M, Nh_row) demod plane never leaves the mesh.
    """
    M, T, L, Phop, tsize, csize, c_loc, split = _mesh_consts(mesh, spec)
    sps = spec.chan_sps
    if demod_halo is None:
        demod_halo = full_demod_halo(spec)
    halo_n = demod_halo + 1
    h = jnp.asarray(chz.prototype_taps(M, T))
    sup_sel = None
    if supervision_slots:
        sel = np.zeros((len(supervision_slots), M), np.float32)
        for i, s in enumerate(supervision_slots):
            assert 0 <= s < M, (s, M)
            sel[i, s] = 1.0
        sup_sel = sel

    def rx_local(xl, hist, iq_carry, parity):
        # xl: (N_sub, 2) this worker's wideband sub-block
        n_sub = xl.shape[0] // Phop
        assert n_sub * Phop == xl.shape[0], \
            "block length must be a multiple of workers * hop"
        assert xl.shape[0] >= L - Phop, \
            f"worker sub-block {xl.shape[0]} < analyzer history {L - Phop}"
        assert n_sub * csize >= halo_n, \
            (f"time-row demod span {n_sub * csize} < demod halo {halo_n}: "
             f"use bigger blocks or a smaller mesh time axis")
        w = lax.axis_index("time") * csize + lax.axis_index("chan")
        x_ext = halo_exchange_left_carry(xl, L - Phop, ("time", "chan"),
                                         hist)
        ypl = chz._analyze_block_chmajor(
            x_ext, h, M, T, (parity + w * n_sub) % 2, spec.transform_bf16,
            split, spec.fold, planar=True)               # (2, M, Nh_sub)
        # reshard channels<->hops within each time row: rank c keeps
        # channels [c*c_loc, (c+1)*c_loc) over the row's full span
        # (sub-blocks concatenate in source-rank = time order)
        ymine = lax.all_to_all(ypl, "chan", split_axis=1,
                               concat_axis=2, tiled=True)  # (2, c_loc, Nh_row)
        cidx = lax.axis_index("chan")
        my_carry = lax.dynamic_slice_in_dim(iq_carry, cidx * c_loc, c_loc,
                                            axis=1)
        # demod continuity + burst-capture overlap via the time halo
        yext = halo_exchange_left_carry(ymine, halo_n, "time", my_carry,
                                        sample_axis=2)
        if spec.io_bf16:
            yext = yext.astype(jnp.bfloat16)
        demod, _, pw = quadrature_demod_planar(yext[0], yext[1],
                                               return_power="series")
        demod = demod[:, 1:]                             # drop seed sample
        # blocked in place, aligned with demod (series never hits HBM)
        pw_blk = correlator.window_power_blocks([pw[:, 1:]])
        # fresh-only band power, the same discriminator conjugate
        # product the single-device streamer reports as rssi
        fr, fi = ymine[0], ymine[1]
        sr, si = yext[0][:, halo_n - 1:-1], yext[1][:, halo_n - 1:-1]
        re, im = fr * sr + fi * si, fi * sr - fr * si
        chan_power = jnp.sqrt(jnp.mean(
            (re * re + im * im).astype(jnp.float32), axis=-1))
        dsp = demod.astype(jnp.bfloat16) if spec.io_bf16 else demod
        phases = correlator.symbol_phase_streams(dsp, sps)
        starts, valid, quality = correlator.find_bursts_phases(
            phases, sps, max_bursts, threshold, out_bf16=spec.corr_bf16)
        # completeness guard: a capture cut off by this row's window is
        # re-found complete by the right neighbor (via its halo) or the
        # next block (via iq_carry)
        valid = valid & (starts + correlator.CAPTURE_SYMBOLS * sps
                         <= demod.shape[-1])
        # per-burst band power over each candidate's own capture extent
        # (the block mean cannot separate an FM-capture ghost from a
        # real burst sharing the block — correlator.burst_rssi)
        rssi = correlator.burst_rssi_blocks(pw_blk, starts, sps)
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
        dec = decoder.decode_bursts(hard, policy, spec.decode_repeat_gate)
        # carried state pieces: only the LAST worker's wideband tail and
        # the LAST time row's IQ tails survive (sliced outside shard_map)
        tail_x = x_ext[-(L - Phop):]
        tail_iq = ymine[:, :, -halo_n:].astype(jnp.float32)
        # leading local time axis so out_specs assemble global shapes
        outs = (starts[None], valid[None], quality[None],
                dec.words[None], dec.word_ok[None], chan_power[None],
                dec.dcc_bits[None], dec.bad_symbols[None], rssi[None],
                tail_x[None], tail_iq[None])
        if sup_sel is not None:
            # supervision tap: this row's FRESH demod samples on the
            # designated slots (one-hot over local channels + psum;
            # f32 like the single-device tap regardless of io_bf16)
            sel_loc = lax.dynamic_slice_in_dim(
                jnp.asarray(sup_sel), cidx * c_loc, c_loc, axis=1)
            fresh = demod[:, -(n_sub * csize):].astype(jnp.float32)
            sup = lax.psum(
                jnp.einsum("sc,cn->sn", sel_loc, fresh,
                           preferred_element_type=jnp.float32), "chan")
            outs = outs + (sup[None],)
        return outs

    out_specs = (P("time", "chan", None),
                 P("time", "chan", None),
                 P("time", "chan", None),
                 P("time", "chan", None, None, None),
                 P("time", "chan", None, None),
                 P("time", "chan"),
                 P("time", "chan", None, None),
                 P("time", "chan", None, None),
                 P("time", "chan", None),
                 P(("time", "chan"), None, None),
                 P("time", None, "chan", None))
    if sup_sel is not None:
        out_specs = out_specs + (P("time", None, None),)
    sharded = shard_map(
        rx_local, mesh=mesh,
        in_specs=(P(("time", "chan"), None), P(None, None),
                  P(None, None, None), P()),
        out_specs=out_specs)

    def step(x, state):
        res = sharded(x, state["hist"], state["iq_carry"], state["parity"])
        (starts, valid, quality, words, word_ok, chan_power, dcc_bits,
         bad_symbols, rssi, tails_x, tails_iq) = res[:11]
        # pass through TX-side state (syn_carry, tx_parity) untouched
        new_state = dict(state)
        new_state.update(
            hist=tails_x[-1],
            iq_carry=tails_iq[-1],
            parity=(state["parity"] + x.shape[0] // Phop) % 2,
        )
        out = {"starts": starts, "valid": valid, "quality": quality,
               "words": words, "word_ok": word_ok,
               "chan_power": chan_power, "dcc_bits": dcc_bits,
               "bad_symbols": bad_symbols, "rssi": rssi}
        if sup_sel is not None:
            out["sup_demod"] = res[11]
        return out, new_state

    return jax.jit(step)


TX_SILENT, TX_FOCC, TX_SOURCE = 0, 1, 2   # per-channel TX slot modes


def make_sharded_bs_stream_step(mesh: Mesh, spec: MultichannelSpec,
                                demod_halo: Optional[int] = None,
                                max_bursts: int = 2,
                                threshold: float = 0.55,
                                policy: str = "first_ok",
                                rx_external: bool = False,
                                tx_sources: bool = False,
                                supervision_slots: tuple = ()):
    """Jitted sharded streaming FULL step: TX words -> wideband -> decode.

    (word_pairs, state [, src_mode, src_bb] [, x_rx]) -> (out, new_state).
    word_pairs: (C, F, 2, 28) sharded over channels; the synthesized
    wideband is produced and consumed inside one jit so XLA overlaps the
    collectives with compute.  With ``rx_external`` the RX side consumes
    the extra ``x_rx`` wideband argument (reverse band traffic) instead
    of the TX loopback, while TX still synthesizes and carries its
    stream — the full-duplex base-station shape.

    With ``tx_sources`` the step takes two extra arguments and the TX
    side carries the reference's FULL per-channel mix
    (grc/ampsbs.grc:841-904: FOCC at its slot, FVC blank-and-burst /
    voice+SAT on voice slots via the mute pair, silence elsewhere):
      src_mode: (M,) int32 — TX_SILENT | TX_FOCC | TX_SOURCE per slot;
      src_bb:   (n_hops, M, 2) riq source baseband (voice+SAT or FVC
                burst FM, e.g. runtime/sources.VoiceFvcSlot output) used
                for TX_SOURCE slots.
    Without it every channel transmits FOCC (the ">=1000 FOCCs"
    bench shape).

    The TX hop count (frames * 463 * 2 * sps) must divide by the worker
    ring; in-stream zero padding is NOT allowed — it would insert
    silence gaps in the continuous wideband and break parity with the
    single-device transmitter (GR's gapless work() contract,
    lib/focc_impl.cc:583).

    Streaming: carries analyzer history, per-channel IQ (demod + burst
    overlap), synthesis overlap-add carry, and hop parities across calls
    — N consecutive steps form one continuous TX stream and one
    continuous RX stream.
    """
    M, T, L, Phop, tsize, csize, c_loc, split = _mesh_consts(mesh, spec)
    sps = spec.chan_sps
    if demod_halo is None:
        demod_halo = full_demod_halo(spec)
    halo_n = demod_halo + 1
    h = jnp.asarray(chz.prototype_taps(M, T))
    sens = 2.0 * np.pi * spec.pipe.deviation_hz / spec.pipe.chan_rate
    rx_step = make_sharded_rx_stream_step(mesh, spec, demod_halo,
                                          max_bursts, threshold, policy,
                                          supervision_slots)
    Wk = tsize * csize

    def tx_core(bb, syn_carry, parity):
        # bb: (c_loc, n, 2) this chan rank's per-channel TX baseband
        # gather all channels (the synthesis transform needs all M)
        bb_all = lax.all_gather(bb, "chan", axis=0, tiled=True)  # (M, n, 2)
        Y = jnp.swapaxes(bb_all, 0, 1)                   # (n, M, 2)
        n = Y.shape[0]
        assert n % Wk == 0, (
            f"TX hop stream ({n} = frames*463*2*sps) must divide by the "
            f"worker ring ({Wk}): pick a frame count with "
            f"frames*{463 * 2 * sps} % {Wk} == 0 — zero padding would "
            f"insert silence gaps in the continuous TX wideband")
        n_sub = n // Wk
        w = lax.axis_index("time") * csize + lax.axis_index("chan")
        Yl = lax.dynamic_slice_in_dim(Y, w * n_sub, n_sub, axis=0)
        xl, tail = chz._synthesize_block(
            Yl, h, M, T, (parity + w * n_sub) % 2,
            jnp.zeros((L - Phop, 2), jnp.float32),
            spec.transform_bf16, split)
        # overlap-add: my tail belongs at the head of the next worker's
        # sub-block (flattened ring crosses row boundaries); worker 0
        # receives the previous BLOCK's carry, and the last worker's
        # tail is emitted as the next block's carry
        xl = overlap_add_with_carry(xl, tail, ("time", "chan"), syn_carry)
        return xl, tail[None]

    def _focc_bb(wp):
        # wp: (c_loc, F, 2, 28) on this chan rank, replicated over
        # time: framing + FSK modulation is genuinely chan-sharded.
        # (The FSK phase accumulator needs no carry: Manchester bits
        # are DC-balanced so superframe boundaries are a fixed point.)
        bits = focc_frame_bits(wp)                       # (c_loc, nb)
        bb, _ = fsk_manchester_baseband(bits, sps, sens)  # (c_loc, n, 2)
        return bb

    if tx_sources:
        def tx_local(wp, mode, src, syn_carry, parity):
            sel = mode[:, None, None]                    # (c_loc, 1, 1)
            bb = (jnp.where(sel == TX_FOCC, _focc_bb(wp), 0.0)
                  + jnp.where(sel == TX_SOURCE,
                              jnp.swapaxes(src, 0, 1), 0.0))
            return tx_core(bb, syn_carry, parity)

        tx_sharded = shard_map(
            tx_local, mesh=mesh,
            in_specs=(P("chan", None, None, None), P("chan"),
                      P(None, "chan", None), P(None, None), P()),
            out_specs=(P(("time", "chan"), None),
                       P(("time", "chan"), None, None)))
    else:
        def tx_local(wp, syn_carry, parity):
            return tx_core(_focc_bb(wp), syn_carry, parity)

        tx_sharded = shard_map(
            tx_local, mesh=mesh,
            in_specs=(P("chan", None, None, None), P(None, None), P()),
            out_specs=(P(("time", "chan"), None),
                       P(("time", "chan"), None, None)))

    def step(word_pairs, state, tx_extra=(), x_rx=None):
        # TX parity is its own state entry: with rx_external the RX
        # stream advances parity by the RX block's hop count, which may
        # differ from the TX synthesis hop count (r2 advisor finding)
        tx_parity = state.get("tx_parity", state["parity"])
        xl, tails = tx_sharded(word_pairs, *tx_extra,
                               state["syn_carry"], tx_parity)
        out, new_state = rx_step(x_rx if rx_external else xl, state)
        n_tx = word_pairs.shape[1] * 463 * 2 * sps
        new_state["syn_carry"] = tails[-1]
        new_state["tx_parity"] = (tx_parity + n_tx) % 2
        out["tx_wideband"] = xl
        return out, new_state

    if tx_sources and rx_external:
        return jax.jit(lambda wp, st, mode, src, x_rx: step(
            wp, st, (mode, src), x_rx))
    if tx_sources:
        return jax.jit(lambda wp, st, mode, src: step(wp, st, (mode, src)))
    if rx_external:
        return jax.jit(lambda wp, st, x_rx: step(wp, st, (), x_rx))
    return jax.jit(lambda wp, st: step(wp, st))


def make_sharded_closed_loop_stream(mesh: Mesh, spec: MultichannelSpec,
                                    nblocks: int, frames: int = 2,
                                    max_bursts: int = 2,
                                    threshold: float = 0.55,
                                    demod_halo: Optional[int] = None,
                                    rx_external: bool = False):
    """Fused sharded closed loop: ONE jitted program that lax.scans
    ``nblocks`` consecutive full-duplex BS steps (FOCC framing -> FSK ->
    synthesis channelizer -> wideband -> sharded analysis -> demod ->
    correlate -> decode) over the ('time', 'chan') mesh with ALL carried
    state scan-resident on device — the multi-chip mirror of
    runtime/streamer.make_closed_loop_stream: zero host involvement
    between blocks, collectives (all_gather / all_to_all / halo
    ppermute) ride the mesh every block, and the sustained number does
    not depend on host transfers (GR's always-on work() contract,
    lib/focc_impl.cc:583, across devices).

    Returns (run, block_samples): ``run(word_pairs)`` with word_pairs
    (M, frames, 2, 28) -> per-block (n_valid, quality_max, n_word_ok)
    arrays of length nblocks; sustained Msps = nblocks * block_samples /
    wall_time.  Scan iteration k matches the k-th manual
    ``make_sharded_bs_stream_step`` call on the same state — counts
    exactly, analog quality to float rounding (XLA fuses the scan body
    differently from the standalone step)
    (tests/test_parallel.py::test_sharded_closed_loop_matches_steps).

    With ``rx_external`` the run takes a second argument x_rx of shape
    (nblocks, N_rx, 2): each scan iteration transmits one TX block AND
    decodes one reverse-band block — the full-duplex shape with real
    traffic instead of the FOCC loopback.
    """
    if demod_halo is None:
        demod_halo = full_demod_halo(spec)
    step = make_sharded_bs_stream_step(mesh, spec, demod_halo,
                                       max_bursts, threshold,
                                       rx_external=rx_external)
    Wk = mesh.shape["time"] * mesh.shape["chan"]
    Phop = spec.num_channels // 2
    n_hops = frames * 463 * 2 * spec.chan_sps
    assert n_hops % Wk == 0, (n_hops, Wk)
    block_samples = n_hops * Phop

    def _summary(out):
        return (jnp.sum(out["valid"]),
                jnp.max(out["quality"].astype(jnp.float32)),
                jnp.sum(out["word_ok"]))

    if rx_external:
        @jax.jit
        def run(word_pairs, x_rx):
            def body(st, xb):
                out, st2 = step(word_pairs, st, xb)
                return st2, _summary(out)
            _, outs = lax.scan(body,
                               sharded_stream_state(spec, demod_halo),
                               x_rx)
            return outs
    else:
        @jax.jit
        def run(word_pairs):
            def body(st, _):
                out, st2 = step(word_pairs, st)
                return st2, _summary(out)
            _, outs = lax.scan(body,
                               sharded_stream_state(spec, demod_halo),
                               None, length=nblocks)
            return outs

    return run, block_samples


def make_sharded_bs_step(mesh: Mesh, spec: MultichannelSpec,
                         demod_halo: Optional[int] = None,
                         max_bursts: int = 2,
                         threshold: float = 0.55):
    """One-shot sharded full step (zero-state stream step), kept for
    compile checks and mesh-consistency tests.  Returns a function
    (word_pairs) -> (starts, valid, quality, words, word_ok).
    Streaming callers use ``make_sharded_bs_stream_step``."""
    stream = make_sharded_bs_stream_step(mesh, spec, demod_halo,
                                         max_bursts, threshold)
    if demod_halo is None:
        demod_halo = full_demod_halo(spec)

    def step(word_pairs):
        out, _ = stream(word_pairs, sharded_stream_state(spec, demod_halo))
        return (out["starts"], out["valid"], out["quality"],
                out["words"], out["word_ok"])

    return jax.jit(step)
