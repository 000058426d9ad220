"""FOCC superframe synthesis — the reference's streaming state machine as a
pure batched function.

The reference (lib/focc_impl.cc) walks a per-frame segment list
(FOCC_BI_BIT/FOCC_MESSAGE/FOCC_END) in its work() loop, memcpy-ing
pre-Manchester-encoded segments.  Here the whole 463-bit frame interleave
(make_frame, lib/focc_impl.cc:178-218) is a precomputed gather pattern, so
a full superframe — or a batch of them across channels — synthesizes in one
fused XLA program: BCH matmul -> gather -> Manchester -> sps-repeat.

Word-queue injection (focc_words_message + filler replacement in
next_burst_state, lib/focc_impl.cc:501-506,522-563) happens on the host at
superframe granularity in FoccStream: queued message frames replace filler
slots in the next (18, 2, 28) word array.  Same worst-case latency (one
superframe, ~0.83 s) as the reference's slot-by-slot pop.

The busy/idle bit defaults to 1 (idle).  Unlike the reference (whose
``busy_idle_bit`` is set once at lib/focc_impl.cc:111 and never toggled;
README.md:54 calls it vestigial), ``FoccStream.mark_busy`` implements
553 §3.1.1 RECC-busy signaling at superframe granularity.
"""

from __future__ import annotations

import collections
import functools
import threading
from typing import Iterable, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from amps_tpu.codec.bch import focc_bch_encode
from amps_tpu.codec.manchester import manchester_encode_symbols
from amps_tpu.codec import words as W
from amps_tpu.config import SystemConfig

DOTTING = np.array([1, 0, 1, 0, 1, 0, 1, 0, 1, 0], dtype=np.uint8)
WORD_SYNC = np.array([1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0], dtype=np.uint8)
FRAME_BITS = 463
FRAMES_PER_SUPERFRAME = 18

# Streams, mirroring enum focc_streams (lib/amps_packet.h:30).
STREAM_A = 1
STREAM_B = 2
STREAM_BOTH = 3


def _frame_gather_indices() -> np.ndarray:
    """(463,) map: frame bit -> index into [dot(10)|ws(11)|A(40)|B(40)]
    (a length-101 message vector), or -1 for a busy-idle bit.

    Layout per make_frame (lib/focc_impl.cc:185-215): a BI bit precedes the
    dotting, the word sync, and every 10-bit word chunk; A and B words
    alternate in 10-bit chunks, 5 repeats each.
    """
    src: List[int] = []
    src.append(-1)
    src.extend(range(0, 10))            # dotting
    src.append(-1)
    src.extend(range(10, 21))           # word sync
    for _ in range(5):
        for base in (21, 61):           # word A, word B
            for c in range(4):
                src.append(-1)
                src.extend(range(base + c * 10, base + c * 10 + 10))
    out = np.array(src, dtype=np.int32)
    assert out.shape == (FRAME_BITS,)
    return out


_FRAME_SRC = _frame_gather_indices()


@functools.cache
def _frame_onehot_mats():
    """(101, 463) one-hot selection matrix G (frame position j takes
    message bit _FRAME_SRC[j]) and the (463,) BI-position mask."""
    G = np.zeros((101, 463), np.float32)
    for j, s in enumerate(_FRAME_SRC):
        if s >= 0:
            G[s, j] = 1.0
    return G, (_FRAME_SRC < 0).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("busy_idle",))
def focc_frame_bits(word_pairs, busy_idle: int = 1):
    """Frame bits before Manchester: (..., F, 2, 28) words -> (..., F*463).

    The pre-line-coding stage of focc_frames_symbols, exposed because the
    FSK baseband of Manchester data is a pure per-bit waveform map (see
    dsp.fm.fsk_manchester_baseband) — the TX hot path goes straight from
    these bits to IQ without materializing the ±1 symbol stream.
    """
    word_pairs = jnp.asarray(word_pairs, dtype=jnp.uint8)
    coded = focc_bch_encode(word_pairs)              # (..., F, 2, 40)
    batch = coded.shape[:-2]
    msg = jnp.concatenate(
        [
            jnp.broadcast_to(jnp.asarray(DOTTING), batch + (10,)),
            jnp.broadcast_to(jnp.asarray(WORD_SYNC), batch + (11,)),
            coded[..., 0, :],
            coded[..., 1, :],
        ],
        axis=-1,
    )                                                # (..., F, 101)
    # static scatter as a one-hot matmul in place of jnp.take over the
    # 463 frame positions (ROADMAP S6 compares the two on the GPU): the
    # (101, 463) selection matrix is one matmul and the BI bits become a
    # masked constant add.
    G, bi = _frame_onehot_mats()
    picked = jnp.matmul(msg.astype(jnp.bfloat16),
                        jnp.asarray(G, jnp.bfloat16),
                        preferred_element_type=jnp.float32)
    frame_bits = (picked
                  + jnp.float32(busy_idle) * jnp.asarray(bi)) \
        .astype(jnp.uint8)                           # (..., F, 463)
    return frame_bits.reshape(frame_bits.shape[:-2] + (-1,))


@functools.partial(jax.jit, static_argnames=("sps", "busy_idle"))
def focc_frames_symbols(word_pairs, sps: int, busy_idle: int = 1):
    """Synthesize FOCC frames.

    word_pairs: (..., F, 2, 28) uint8 unencoded (A, B) words per frame.
    Returns (..., F*463*2*sps) ±1 int8 symbol samples — bit-identical to
    the reference focc block's steady-state output stream.
    """
    return manchester_encode_symbols(focc_frame_bits(word_pairs, busy_idle),
                                     sps)


def superframe_word_pairs(system: Optional[SystemConfig] = None) -> np.ndarray:
    """(18, 2, 28) word pairs of the steady-state superframe
    (make_superframe, lib/focc_impl.cc:384-418): OHW1, OHW2, access-type,
    regid(end), 14x filler.  A==B in every frame."""
    sc = system or SystemConfig()
    rows = [
        W.overhead_word_1(sc.dcc, sc.sid, True, False, False, 3),
        W.overhead_word_2(sc.dcc, 1, 1, 1, 1, 0, 23, 1, 1, 23, 0),
        W.access_type_parameters_global_action(sc.dcc, False),
        W.registration_id(sc.dcc, 0, True),
    ] + [W.control_filler_word()] * 14
    arr = np.stack([np.stack([np.asarray(r)] * 2) for r in rows])
    assert arr.shape == (18, 2, 28)
    return arr


def registration_superframe_word_pairs(
    system: Optional[SystemConfig] = None,
) -> np.ndarray:
    """(38, 2, 28) aggressive-registration superframe
    (make_registration_superframe, lib/focc_impl.cc:421-480)."""
    sc = system or SystemConfig()

    def half(regid):
        return [
            W.overhead_word_1(sc.dcc, sc.sid, True, False, False, 4),
            W.overhead_word_2(sc.dcc, 1, 1, 1, 1, 0, 23, 1, 1, 23, 0),
            W.access_type_parameters_global_action(sc.dcc, False),
            W.registration_increment_global_action(sc.dcc, sc.regincr, False),
            W.registration_id(sc.dcc, regid, True),
        ] + [W.control_filler_word()] * 14

    rows = half(0) + half(500)
    arr = np.stack([np.stack([np.asarray(r)] * 2) for r in rows])
    assert arr.shape == (38, 2, 28)
    return arr


def symbols_from_bitfile(path: str, sps: int = 1) -> np.ndarray:
    """The queue_file debug injector (lib/focc_impl.cc:53-77) as a pure
    source: read '0'/'1' characters (or raw 0/1 bytes) from ``path`` and
    return the Manchester-encoded ±1 int8 symbol stream at ``sps`` samples
    per half-symbol.  Invalid bytes are skipped with a count, like the
    reference's "invalid value in bits file" warning.  Feed the result to
    a runtime source / modulator to transmit arbitrary bit captures."""
    raw = np.frombuffer(open(path, "rb").read(), dtype=np.uint8)
    bits = np.where((raw == 1) | (raw == ord("1")), 1,
                    np.where((raw == 0) | (raw == ord("0")), 0, -1))
    invalid = int(np.sum(bits < 0))
    if invalid:
        from amps_tpu.utils.logging import log_warning
        log_warning(f"symbols_from_bitfile: {invalid} invalid bytes skipped")
    bits = bits[bits >= 0].astype(np.uint8)
    return np.asarray(manchester_encode_symbols(bits, sps))


class FoccStream:
    """Host-side FOCC word-queue + superframe producer.

    Mirrors the focc block's message-injection contract: queued
    (stream, word28) messages become ephemeral message frames that replace
    filler slots (lib/focc_impl.cc:501-563).  Thread-safe like the
    reference's frame_queue_mutex (lib/focc_impl.cc:566-580).

    ``debug_sink``: when set, append the emitted ±1 symbol stream (int8
    bytes) to this file, capped at ``debug_limit`` samples — the
    AMPS_DEBUG /tmp/debug.bits dump (lib/focc_impl.cc:132-135,639-645,
    same 500000-sample default cap).
    """

    def __init__(self, system: Optional[SystemConfig] = None, sps: int = 5,
                 debug_sink: Optional[str] = None,
                 debug_limit: int = 500000):
        self.system = system or SystemConfig()
        self.sps = sps
        if self.system.aggressive_registration:
            self._template = registration_superframe_word_pairs(self.system)
        else:
            self._template = superframe_word_pairs(self.system)
        self._filler_slots = [
            i for i in range(self._template.shape[0])
            if np.array_equal(self._template[i, 0], W.CONTROL_FILLER)
        ]
        self._queue: collections.deque = collections.deque()
        # (remaining_repeats, pair) entries re-queued one per FUTURE
        # superframe — page repetition across superframes (a repeat in
        # the SAME superframe would ride the same busy flag and help
        # nobody)
        self._deferred: List = []
        self._busy_superframes = 0
        self._lock = threading.Lock()
        self._debug = open(debug_sink, "ab") if debug_sink else None
        self._debug_left = debug_limit

    @property
    def frames_per_superframe(self) -> int:
        return self._template.shape[0]

    def push_words(self, stream: int, words28: Iterable[np.ndarray],
                   repeats: int = 1) -> None:
        """Queue mobile-control words (focc_words_message,
        lib/focc_impl.cc:522-563): each word becomes one frame, paired with
        filler on the unused stream.

        repeats > 1 re-sends the words once per SUBSEQUENT superframe
        (pages are repeated so a mobile that deferred during a
        busy-marked superframe still hears one — the reference never
        repeats, its busy bit being vestigial)."""
        filler = np.asarray(W.CONTROL_FILLER)
        with self._lock:
            for word in words28:
                word = np.asarray(word, dtype=np.uint8)
                assert word.shape == (28,)
                if stream == STREAM_A:
                    pair = np.stack([word, filler])
                elif stream == STREAM_B:
                    pair = np.stack([filler, word])
                elif stream == STREAM_BOTH:
                    pair = np.stack([word, word])
                else:
                    raise ValueError(f"invalid stream {stream}")
                self._queue.append(pair)
                if repeats > 1:
                    self._deferred.append((repeats - 1, pair))

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def next_word_pairs(self) -> np.ndarray:
        """The (F, 2, 28) word array for the next superframe: the template
        with filler slots replaced by queued message frames, in order."""
        out = self._template.copy()
        with self._lock:
            for slot in self._filler_slots:
                if not self._queue:
                    break
                out[slot] = self._queue.popleft()
            # deferred repeats go out starting with the NEXT superframe
            nxt = []
            for n, pair in self._deferred:
                self._queue.append(pair)
                if n > 1:
                    nxt.append((n - 1, pair))
            self._deferred = nxt
        return out

    def mark_busy(self, superframes: int = 1) -> None:
        """Stream busy/idle = BUSY for the next N superframes.

        553 §3.1.1 has the land station mark the RECC busy while a
        mobile seizes it, so other mobiles defer; the reference never
        implements it (``volatile bool busy_idle_bit`` at
        lib/amps_common.h:7 is set once at lib/focc_impl.cc:111 and its
        own README calls it vestigial).  Block synthesis bounds our
        granularity to one superframe (~0.83 s) — coarse vs the spec's
        per-bit flip, but enough for its purpose of suppressing RECC
        collisions while a response is pending (BaseStation.handle_burst
        marks one superframe busy per detected seizure)."""
        with self._lock:
            self._busy_superframes = max(self._busy_superframes,
                                         int(superframes))

    def next_superframe_symbols(self) -> jax.Array:
        """±1 symbol samples for the next superframe (device array)."""
        with self._lock:
            busy = self._busy_superframes > 0
            if busy:
                self._busy_superframes -= 1
        syms = focc_frames_symbols(self.next_word_pairs(), self.sps,
                                   busy_idle=0 if busy else 1)
        if self._debug is not None and self._debug_left > 0:
            chunk = np.asarray(syms, np.int8)[: self._debug_left]
            self._debug.write(chunk.tobytes())
            self._debug.flush()
            self._debug_left -= chunk.size
        return syms
