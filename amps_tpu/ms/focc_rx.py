"""Mobile-side FOCC decoder: ±1 symbol stream -> per-frame words.

Implements the mobile's 553 §2.6.3 word-sync + 3-of-5 bit-majority
receive procedure against the frame layout of tx/focc.py (which is
bit-exact with make_frame, lib/focc_impl.cc:178-218): 463-bit frames of
[B/I | dotting(10) | B/I | wsync(11) | 5 x (B/I-interleaved A(40) and
B(40) chunks)], Manchester encoded to 926 symbols.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from amps_tpu.codec.bch import focc_bch_decode
from amps_tpu.tx.focc import _FRAME_SRC, DOTTING, FRAME_BITS, WORD_SYNC

FRAME_SYMBOLS = 2 * FRAME_BITS                     # 926


def _header_template() -> np.ndarray:
    """(46,) ±1/0 Manchester template of frame bits 0..22 with the two
    B/I symbol pairs zeroed (their value is unknown at the mobile)."""
    bits = np.zeros(23, np.uint8)
    bits[1:11] = DOTTING
    bits[12:23] = WORD_SYNC
    tmpl = np.zeros(46, np.float32)
    tmpl[0::2] = 1.0 - 2.0 * bits                  # bit b -> (1-2b, 2b-1)
    tmpl[1::2] = 2.0 * bits - 1.0
    mask = np.repeat((_FRAME_SRC[:23] >= 0), 2)
    return tmpl * mask


_HEADER = _header_template()

# positions of each message-bit occurrence inside a frame:
# word A message indices are 21..60, word B 61..100, each appearing
# 5 times (the in-frame repeats the mobile majority-votes over)
_A_POS = [np.where(_FRAME_SRC == m)[0] for m in range(21, 61)]
_B_POS = [np.where(_FRAME_SRC == m)[0] for m in range(61, 101)]
_A_POS = np.stack(_A_POS)                          # (40, 5)
_B_POS = np.stack(_B_POS)
_BI_POS = np.where(_FRAME_SRC < 0)[0]


@dataclasses.dataclass
class FoccFrame:
    word_a: np.ndarray        # (28,) decoded bits
    word_b: np.ndarray
    ok_a: bool
    ok_b: bool
    busy: bool                # B/I majority says RECC busy (bit == 0)
    sync_quality: float


def _dump(symbols, sps: int) -> np.ndarray:
    s = np.asarray(symbols, np.float32)
    nsym = len(s) // sps
    return s[: nsym * sps].reshape(nsym, sps).mean(-1)


def decode_focc_stream(symbols, sps: int = 1,
                       min_quality: float = 0.5,
                       return_consumed: bool = False):
    """±1 FOCC samples -> decoded frames (List[FoccFrame]).

    Alignment folds the header correlation over the 926-symbol frame
    period (every frame carries the same dotting+wsync header), so one
    superframe of input aligns even at low SNR.

    ``return_consumed``: also return the RAW-sample index just past the
    last decoded frame (0 when nothing decoded), so streaming callers
    can carry the undecoded tail into the next call — a frame
    straddling a block boundary is otherwise silently dropped (found by
    the 16-call soak: one mobile of sixteen missed its voice-channel
    assignment that way).
    """
    # search the sample phase too (an RF demod feed has arbitrary
    # symbol timing; integrate-and-dump at each of the sps phases and
    # keep the one whose folded header correlation is strongest)
    best = None
    for ph in range(sps):
        s_ph = _dump(np.asarray(symbols, np.float32)[ph:], sps)
        if len(s_ph) < FRAME_SYMBOLS + len(_HEADER):
            continue
        c = np.correlate(s_ph, _HEADER, "valid")
        nfold = len(c) // FRAME_SYMBOLS
        if nfold == 0:
            continue
        folded = c[: nfold * FRAME_SYMBOLS].reshape(
            nfold, FRAME_SYMBOLS).sum(0)
        p = int(np.argmax(folded))
        # select the phase by RAW folded correlation (a misaligned dump
        # phase strictly loses raw peak: partial symbol averaging cancels
        # adjacent ±1 halves); quality normalizes by amplitude only, so
        # the min_quality gate works for FM-demod inputs too
        nnz = int(np.count_nonzero(_HEADER))
        amp = max(float(np.mean(np.abs(s_ph))), 1e-9)
        raw = float(folded[p]) / nfold
        q = raw / (nnz * amp)
        if best is None or raw > best[0]:
            best = (raw, q, p, s_ph / amp, ph)
    if best is None:
        return ([], 0) if return_consumed else []
    _, quality, p, s, ph = best
    if quality < min_quality:
        return ([], 0) if return_consumed else []
    out: List[FoccFrame] = []
    start = p
    while start + FRAME_SYMBOLS <= len(s):
        fs = s[start: start + FRAME_SYMBOLS]
        # Manchester decode: bit = complement of first half-symbol
        bits = (fs[0::2] < 0).astype(np.uint8)     # (463,)
        a5 = bits[_A_POS]                          # (40, 5)
        b5 = bits[_B_POS]
        a40 = (a5.sum(-1) >= 3).astype(np.uint8)   # 3-of-5 majority
        b40 = (b5.sum(-1) >= 3).astype(np.uint8)
        dec, ok = focc_bch_decode(np.stack([a40, b40]))
        dec, ok = np.asarray(dec), np.asarray(ok)
        bi = bits[_BI_POS]
        out.append(FoccFrame(word_a=dec[0], word_b=dec[1],
                             ok_a=bool(ok[0]), ok_b=bool(ok[1]),
                             busy=bi.sum() * 2 < len(bi),
                             sync_quality=quality))
        start += FRAME_SYMBOLS
    if return_consumed:
        # dumped symbol j of phase ph covers raw [ph + j*sps, ph + (j+1)*sps)
        consumed = (ph + start * sps) if out else 0
        return out, consumed
    return out


def parse_focc_word(word28: np.ndarray) -> dict:
    """Mobile-side FOCC word classifier/parser (word layouts:
    codec/words.py, bit-exact with lib/amps_packet.cc:26-53 and
    lib/focc_impl.cc:252-381 overhead words)."""
    b = np.asarray(word28).astype(np.int64)

    def val(start, n):
        out = 0
        for i in range(n):
            out = (out << 1) | int(b[start + i])
        return out

    if b[0] == 0:                                  # Word 1 (address)
        return {"type": "word1", "MULTIWORD": int(b[1]),
                "DCC": val(2, 2), "MIN1": val(4, 24)}
    if b[1] == 1:                                  # overhead (T1T2=11)
        return {"type": "overhead", "OHD": val(25, 3)}
    scc = val(2, 2)
    if scc == 3:                                   # Word 2 order variant
        return {"type": "word2_order", "MIN2": val(4, 10),
                "MSG_TYPE": val(15, 5), "ORDQ": val(20, 3),
                "ORDER": val(23, 5)}
    return {"type": "word2_voice", "SCC": scc, "MIN2": val(4, 10),
            "VMAC": val(14, 3), "CHAN": val(17, 11)}
