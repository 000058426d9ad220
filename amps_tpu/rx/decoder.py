"""RECC burst decoding: Manchester + 5-repeat BCH word decode, batched.

Mirrors bursts_message (lib/recc_decode_impl.cc:81-118): a 3374-symbol
capture is DCC (7 bits Manchester = 14 symbols) + 7 words x 5 repeats x 48
coded bits (x2 symbols).  Per word the reference tries BCH decode on
successive repeats until one succeeds (sequential fallback,
lib/recc_decode_impl.cc:100-107).  We decode ALL 35 repeats of a burst in
one batched syndrome matmul and then select per policy:

* ``first_ok``   — reference-exact: first repeat whose decode succeeds;
* ``majority``   — bit-wise majority vote across the 5 repeats before BCH
  (the spec-recommended combining; strictly better at low SNR, and the
  behavior named in BASELINE.json).  If the majority word fails BCH we
  fall back to first_ok.

ERASURE-GATED COMBINING (``repeat_gate``): a repeat whose own 48
Manchester pairs violate the code in more than ``repeat_gate`` places is
noise (a clean repeat has ~0 violations; pure noise ~24 of 48, so a gate
of 6 sits >5 sigma below the noise mean) and is EXCLUDED from both the
first_ok ranking and the majority vote.  Rationale: the (48,36) code has
1177 decodable syndromes of 4096, so a *noise* repeat BCH-"succeeds"
with p~0.29 — the reference's sequential fallback
(lib/recc_decode_impl.cc:100-107) will then deliver an aliased word with
ok=True before ever reaching a later clean repeat.  Observed in the
64-block streaming soak on the device (word 1 selected with 73/240 bad
symbols, word_ok=True, wrong bits).  With the gate, noisy repeats are
erasures: first_ok picks the first *clean* decodable repeat, majority
votes only among clean repeats, and a word with zero clean decodable
repeats is honestly word_ok=False.

Parsing uses the BCH-corrected bits — the reference parses the *raw first
repeat* (lib/recc_decode_impl.cc:112,117) and ignores the corrected output
it just computed; SURVEY.md §7 marks that a bug to fix consciously.

SYMBOL-DOMAIN FORMULATION (the bit-domain decode spent its time on
dtype churn over ~7 MB of captures, not on math):

* everything consumes the 0/1 symbols through ONE bfloat16 cast;
* Manchester decode + per-repeat BCH syndromes collapse into a single
  (480, 60) matmul per word: bit b = 1 - s[2b] (lib/utils.cc:36-53), and
  syndromes are linear, so syn_r = (colsum(H) - s_word @ W_r) mod 2 with
  W_r[2*(48*r + i), 12*r + j] = H[i, j];
* the winning repeat is selected as SYMBOLS (one-hot einsum over the
  (..., 7, 5, 96) view), and only those 96 symbols become bits;
* Manchester bad counts are (1 - d^2) masked reductions on the adjacent
  difference d (exact for 0/1 symbols), never strided views;
* DCC bits ride a one-hot matmul over the full capture width (in place
  of a strided 7-column slice).

All arithmetic accumulates in f32 (counts <= 480: exact); outputs are
bit-identical to the bit-domain decode (tests/test_rx.py golden decode,
tests/test_bf16.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from amps_tpu.codec.bch import (apply_error_pattern, packed_lut_lookup,
                                recc_bch_decode, recc_decode_table_packed,
                                recc_syndrome_matrix)
from amps_tpu.codec.bits import packbits

NUM_WORDS = 7
NUM_REPEATS = 5
WORD_CODED_BITS = 48
DCC_BITS = 7
WORD_SYMBOLS = 2 * NUM_REPEATS * WORD_CODED_BITS      # 480
CAPTURE_SYMBOLS = 2 * DCC_BITS + NUM_WORDS * WORD_SYMBOLS  # 3374


class DecodedBurst(NamedTuple):
    dcc_bits: jax.Array      # (..., 7) uint8
    words: jax.Array         # (..., 7, 36) uint8 corrected info bits
    word_ok: jax.Array       # (..., 7) bool — any repeat decodable
    repeat_used: jax.Array   # (..., 7) int32 — repeat index selected
    bad_symbols: jax.Array   # (..., 8) int32 Manchester bad counts
                             # (DCC + 7 words, lib/recc_decode_impl.cc:90-98)


@functools.cache
def _word_syndrome_op():
    """(480, 60) W and (60,) c: per-word symbols -> all 5 repeats'
    12-bit syndromes as (c - s_word @ W) mod 2 (see module docstring)."""
    H = recc_syndrome_matrix().astype(np.float32)     # (48, 12)
    W = np.zeros((WORD_SYMBOLS, NUM_REPEATS * 12), np.float32)
    for r in range(NUM_REPEATS):
        for i in range(WORD_CODED_BITS):
            W[2 * (WORD_CODED_BITS * r + i), 12 * r: 12 * (r + 1)] = H[i]
    c = np.tile(H.sum(axis=0), NUM_REPEATS)           # (60,)
    return W, c


@functools.cache
def _bad_mask(n_sym: int) -> np.ndarray:
    """(n_sym - 1,) f32 mask of even adjacent-pair offsets."""
    return (1.0 - np.arange(n_sym - 1) % 2).astype(np.float32)


def _pair_bad(sym_f, n_sym: int):
    """Count Manchester pairs whose halves AGREE over the last axis
    (..., n_sym): bad = sum over even offsets of 1 - (s[i] - s[i+1])^2
    — contiguous reads only, exact for 0/1 symbols."""
    d = sym_f[..., : n_sym - 1] - sym_f[..., 1:n_sym]
    agree = 1.0 - d * d
    mask = jnp.asarray(_bad_mask(n_sym)).astype(sym_f.dtype)
    return jnp.einsum("...i,i->...", agree, mask,
                      preferred_element_type=jnp.float32).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("policy", "repeat_gate"))
def decode_bursts(symbols, policy: str = "first_ok",
                  repeat_gate: int | None = None) -> DecodedBurst:
    """Decode (..., 3374) sliced RECC captures.  ``symbols`` may be any
    0/1 dtype; bfloat16 input (e.g. straight from the burst extractor's
    one-hot capture matmul) is consumed with no cast at all.

    ``repeat_gate``: erasure gate — repeats with more than this many
    Manchester violations (of 48 pairs) are excluded from selection and
    voting (see module docstring); None disables (legacy behavior)."""
    s = jnp.asarray(symbols)
    if s.dtype != jnp.bfloat16:
        s = s.astype(jnp.bfloat16)
    batch = s.shape[:-1]
    sw = s[..., 2 * DCC_BITS:].reshape(batch + (NUM_WORDS, WORD_SYMBOLS))

    # all 35 repeat syndromes in one matmul per word
    W, c = _word_syndrome_op()
    raw = jnp.matmul(sw, jnp.asarray(W).astype(s.dtype),
                     preferred_element_type=jnp.float32)  # (..., 7, 60)
    syn = jnp.mod(jnp.asarray(c) - raw, 2.0)
    syn = syn.reshape(batch + (NUM_WORDS, NUM_REPEATS, 12)).astype(jnp.int32)
    idx = packbits(syn, jnp.int32)                        # (..., 7, 5)
    # gather-free packed-LUT lookup (codec/bch.py:packed_lut_lookup)
    g = packed_lut_lookup(idx, recc_decode_table_packed())

    swr = sw.reshape(batch + (NUM_WORDS, NUM_REPEATS, 2 * WORD_CODED_BITS))
    # per-repeat Manchester violation counts (48 pairs each); the legacy
    # per-word bad_symbols field is their sum (bit-identical: the word
    # slot's even pair offsets never straddle a repeat boundary)
    rep_bad = _pair_bad(swr, 2 * WORD_CODED_BITS)         # (..., 7, 5)
    elig = None
    if repeat_gate is not None:
        elig = rep_bad <= jnp.int32(repeat_gate)          # (..., 7, 5)

    # Select-then-correct: rank the 5 repeats on their packed syndrome
    # LUT values, one-hot select the winning repeat's SYMBOLS + LUT
    # value, and build the <=2-bit error pattern ONCE for the selected
    # repeat.  Correction commutes with selection (each repeat's
    # correction depends only on its own syndrome), so this is
    # output-identical to correcting all 5 repeats first.  Invalid
    # syndromes carry sentinel positions (255) that flip nothing, so
    # not-ok words still pass through their raw first-repeat bits.
    ok = (g & (1 << 16)) != 0
    if elig is not None:
        ok = ok & elig
    first_idx = jnp.argmax(ok, axis=-1)                   # (..., 7)
    any_ok = jnp.any(ok, axis=-1)
    onehot = (jnp.arange(NUM_REPEATS) == first_idx[..., None])
    g_sel = jnp.sum(g * onehot, axis=-1)                  # (..., 7)
    rep_sym = jnp.einsum("...r,...rs->...s", onehot.astype(s.dtype), swr,
                         preferred_element_type=jnp.float32)  # (..., 7, 96)
    rep_bits = (1.0 - rep_sym[..., 0::2]).astype(jnp.uint8)   # (..., 7, 48)
    first_words = apply_error_pattern(rep_bits, g_sel, 36)

    if policy == "first_ok":
        words, used, wok = first_words, first_idx, any_ok
    elif policy == "majority":
        # votes = sum over (eligible) repeats of bits = n - sum of even
        # symbols; with the gate, ineligible repeats are erasures and the
        # vote is among the clean repeats only
        if elig is None:
            ssum = jnp.sum(swr.astype(jnp.float32), axis=-2)  # (..., 7, 96)
            votes = NUM_REPEATS - ssum[..., 0::2]
            nvote = jnp.float32(NUM_REPEATS)
        else:
            # an even eligible count can TIE a bit vote; a tie that
            # resolved to a fixed value would hand BCH a systematic
            # vector that can alias (the legacy 5-repeat vote was
            # tie-free).  Per-repeat weights 1 + 2^-(r+3) have unique
            # subset sums, so ties break deterministically toward
            # earlier repeats — the reference's own preference order.
            # The epsilons use <= 7 mantissa bits so the weights are
            # EXACT IN BFLOAT16 (and so in TF32): default matmul
            # precision may round f32 operands to either (the
            # packed-LUT incident, codec/bch.py), which would silently
            # round finer epsilons back to 1.0 and defeat the tie-break.
            # Max total perturbation 2*0.242 + 0.242 < 1 = the minimum
            # non-tie margin, so true majorities can never flip
            # (tests/test_rx.py::test_majority_tie_break_weights).
            tie = (0.125 / 2.0 ** np.arange(NUM_REPEATS)
                   ).astype(np.float32)
            w_el = elig.astype(jnp.float32) * (1.0 + jnp.asarray(tie))
            ssum = jnp.einsum("...r,...rs->...s", w_el,
                              swr.astype(jnp.float32),
                              preferred_element_type=jnp.float32)
            n_el = jnp.sum(elig, axis=-1)                     # (..., 7)
            votes = jnp.sum(w_el, axis=-1)[..., None] - ssum
            votes = votes[..., 0::2]
            nvote = jnp.sum(w_el, axis=-1)[..., None]
        maj = (votes * 2 > nvote).astype(jnp.uint8)
        mdec, mok = recc_bch_decode(maj)
        if elig is not None:
            mok = mok & (n_el > 0)
        words = jnp.where(mok[..., None], mdec, first_words)
        used = jnp.where(mok, jnp.int32(-1), first_idx)   # -1 = majority
        wok = mok | any_ok
    else:
        raise ValueError(f"unknown repeat policy {policy!r}")

    # DCC bits via one-hot matmul over the full capture width (in place
    # of a stride-2 slice of 7 columns).  Bit value = complement of the
    # first half-symbol (lib/utils.cc:36-53).
    sel = np.zeros((s.shape[-1], DCC_BITS), np.float32)
    sel[np.arange(0, 2 * DCC_BITS, 2), np.arange(DCC_BITS)] = 1.0
    picked = jnp.matmul(s, jnp.asarray(sel).astype(s.dtype),
                        preferred_element_type=jnp.float32)
    dcc_bits = (1.0 - picked).astype(jnp.uint8)
    dcc_bad = _pair_bad(s[..., : 2 * DCC_BITS], 2 * DCC_BITS)
    word_bad = jnp.sum(rep_bad, axis=-1)                  # (..., 7)

    bad = jnp.concatenate([dcc_bad[..., None], word_bad], axis=-1)
    return DecodedBurst(dcc_bits, words, wok, used, bad.astype(jnp.int32))


def decode_burst(symbols, policy: str = "first_ok",
                 repeat_gate: int | None = None) -> DecodedBurst:
    """Single-capture convenience wrapper."""
    return decode_bursts(symbols, policy, repeat_gate)
