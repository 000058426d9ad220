"""Batched BCH(63,51,t=2) codec as GF(2) matmuls + syndrome-LUT gathers.

Array-first design (SURVEY.md §7 step 1): instead of the reference's per-word
IT++ polynomial arithmetic (itpp::BCH(63,2,true) at lib/focc_impl.cc:105),

* encode is a single (B, 28) @ (28, 12) int32 matmul mod 2 — the parity of
  a systematic cyclic code is a linear map of the info bits, so the whole
  FOCC/FVC word stream encodes in one matmul;
* decode is a (B, 48) @ (48, 12) syndrome matmul mod 2, a pack to a 12-bit
  index, and a gather from a precomputed (4096, 48) error-pattern table
  (t=2, n=63 has 1+48+C(48,2)=1177 correctable patterns; every other
  syndrome marks the word invalid, mirroring itpp::BCH::decode's flag used
  at lib/recc_decode_impl.cc:66).

Shortening conventions match lib/focc_impl.cc:157-176 (23-zero prefix,
keep bits 23..62 -> 40-bit forward word) and lib/recc_decode_impl.cc:53-79
(15-zero prefix, keep info bits -> 36-bit reverse word; the reference's
48-bit out-of-bounds read is consciously fixed, SURVEY.md §7 quirks).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from amps_tpu.codec.bits import packbits

N = 63
K = 51
NUM_PARITY = 12
# g(x) = x^12 + x^10 + x^8 + x^5 + x^4 + x^3 + 1 (TIA/EIA-553 §3.7.1)
_GEN = np.array([1, 0, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1], dtype=np.uint8)


def _poly_mod(dividend: np.ndarray) -> np.ndarray:
    rem = dividend.copy()
    for i in range(len(rem) - len(_GEN) + 1):
        if rem[i]:
            rem[i : i + len(_GEN)] ^= _GEN
    return rem[-(len(_GEN) - 1):]


@functools.cache
def _parity_matrix(k_info: int) -> np.ndarray:
    """(k_info, 12) P with parity = info @ P mod 2, for the code shortened
    to k_info info bits (leading zeros of the full 51 contribute nothing)."""
    P = np.zeros((k_info, NUM_PARITY), dtype=np.uint8)
    for i in range(k_info):
        m = np.zeros(k_info + NUM_PARITY, dtype=np.uint8)
        m[i] = 1  # x^(k_info-1-i) * x^12
        P[i] = _poly_mod(m)
    return P


@functools.cache
def _syndrome_matrix(n_code: int) -> np.ndarray:
    """(n_code, 12) H with syndrome = rx @ H mod 2 (remainder mod g)."""
    H = np.zeros((n_code, NUM_PARITY), dtype=np.uint8)
    for i in range(n_code):
        m = np.zeros(n_code, dtype=np.uint8)
        m[i] = 1
        H[i] = _poly_mod(m)
    return H


@functools.cache
def _decode_tables(n_code: int):
    """Syndrome-indexed tables for the code shortened to n_code bits:
    returns (err_patterns (4096, n_code) uint8, valid (4096,) bool).

    Patterns are enumerated over the FULL 63-bit codeword, not just the
    n_code transmitted bits: the reference decodes the zero-padded 63-bit
    word (lib/recc_decode_impl.cc:62-66), so a <=2-error pattern whose
    errors land in the zero prefix is still reported valid by IT++ (the
    prefix flips are invisible in the kept info bits).  We reproduce that
    acceptance behavior exactly; a strict shortened-code decoder would
    reject those patterns.
    """
    H63 = _syndrome_matrix(N)
    pad = N - n_code
    err = np.zeros((1 << NUM_PARITY, n_code), dtype=np.uint8)
    valid = np.zeros(1 << NUM_PARITY, dtype=bool)

    def syn_index(pattern63):
        s = pattern63.astype(np.uint8) @ H63 % 2
        return int(s @ (1 << np.arange(NUM_PARITY - 1, -1, -1)))

    valid[0] = True  # zero syndrome: no errors
    singles = []
    for i in range(N):
        p = np.zeros(N, dtype=np.uint8)
        p[i] = 1
        singles.append(p)
        idx = syn_index(p)
        err[idx] = p[pad:]
        valid[idx] = True
    for i in range(N):
        for j in range(i + 1, N):
            p = np.zeros(N, dtype=np.uint8)
            p[i] = 1
            p[j] = 1
            idx = syn_index(p)
            err[idx] = p[pad:]
            valid[idx] = True
    return err, valid


@functools.cache
def _decode_table_packed(n_code: int) -> np.ndarray:
    """(4096,) int32 syndrome LUT: pos1 | pos2 << 8 | valid << 16.

    Compact decode: a flat int32 lookup (no (4096, n) row gather,
    no separate bool-table gather) followed by an iota-compare that
    rebuilds the <=2-bit error pattern in place.  Positions are indices
    into the n_code TRANSMITTED bits; errors landing in the zero prefix
    of the shortened code (accepted as valid by the reference's
    full-63-bit decode, see _decode_tables) are stored as the sentinel
    255 — valid, but flipping nothing visible.
    """
    H63 = _syndrome_matrix(N)
    pad = N - n_code
    # default = invalid, no-op positions (sentinel 255 flips nothing)
    tab = np.full(1 << NUM_PARITY, 255 | (255 << 8), dtype=np.int32)
    weights = (1 << np.arange(NUM_PARITY - 1, -1, -1))

    def syn_index(pattern63):
        return int((pattern63.astype(np.uint8) @ H63 % 2) @ weights)

    def pos(i):  # full-codeword bit i -> transmitted index or sentinel
        return i - pad if i >= pad else 255

    tab[0] = 255 | (255 << 8) | (1 << 16)
    for i in range(N):
        p = np.zeros(N, dtype=np.uint8)
        p[i] = 1
        tab[syn_index(p)] = pos(i) | (255 << 8) | (1 << 16)
    for i in range(N):
        for j in range(i + 1, N):
            p = np.zeros(N, dtype=np.uint8)
            p[i] = 1
            p[j] = 1
            tab[syn_index(p)] = pos(i) | (pos(j) << 8) | (1 << 16)
    return tab


@functools.cache
def _split_component_tables(key: bytes, shape) -> np.ndarray:
    """(16, 256, 3) float32 component planes [pos1, pos2, valid] of a
    packed (4096,) LUT (see packed_lut_lookup; cached on table bytes)."""
    tab = np.frombuffer(key, dtype=np.int32).reshape(shape)
    comp = np.stack([tab & 0xFF, (tab >> 8) & 0xFF, (tab >> 16) & 1],
                    axis=-1).astype(np.float32)
    assert comp.max() <= 255, "component planes must stay bf16-exact"
    return comp.reshape(16, 256, 3)


def packed_lut_lookup(idx, table: np.ndarray):
    """table[idx] for a (4096,) packed int table (pos1 | pos2 << 8 |
    valid << 16) as three factored 16-way one-hot contractions instead
    of a per-element gather (whether a plain gather is faster on the GPU
    is open, ROADMAP S6).

    SPLIT-COMPONENT FORM (exact at DEFAULT matmul precision): default
    precision may round f32 matmul operands — to TF32 (11 significand
    bits) on an H100's tensor cores, to bf16 (8 bits) on other matrix
    units — and the packed 2^17-magnitude values do not survive either
    rounding (every BCH decode would be rejected on the device while
    the CPU accepts).
    Contracting the three component planes [pos1, pos2, valid] instead
    keeps every operand <= 255 — integers <= 256 are exact in bf16 and
    TF32 alike, one-hot selectors are 0/1, and accumulation is f32
    (sums <= 255: exact) — so default precision is exact and needs no
    Precision.HIGHEST (tests/test_codec.py::
    test_packed_lut_split_components_bf16_exact and
    test_integer_contractions_exact_in_tf32).  The packed value is
    rebuilt in f32 (<= 196 863 < 2^24: exact)."""
    T2 = jnp.asarray(_split_component_tables(table.tobytes(), table.shape))
    oh_a = ((idx >> 8)[..., None] == jnp.arange(16, dtype=jnp.int32)) \
        .astype(jnp.float32)
    oh_r = ((idx & 0xFF)[..., None] == jnp.arange(256, dtype=jnp.int32)) \
        .astype(jnp.float32)
    g1 = jnp.einsum("ard,...r->...ad", T2, oh_r,
                    preferred_element_type=jnp.float32)   # (..., 16, 3)
    comp = jnp.einsum("...ad,...a->...d", g1, oh_a,
                      preferred_element_type=jnp.float32)  # (..., 3)
    packed = (comp[..., 0] + 256.0 * comp[..., 1]
              + 65536.0 * comp[..., 2])
    return packed.astype(jnp.int32)


def _syndrome_packed(rx, n_code: int):
    """(..., n_code) received bits -> (...,) packed int32 LUT values
    (pos1 | pos2 << 8 | valid << 16, see _decode_table_packed).

    Split out so callers that only need SOME corrected words (e.g. the
    5-repeat first_ok policy, rx/decoder.py) can rank repeats on these
    cheap scalars and build the error pattern for the selected repeat
    only."""
    rx = jnp.asarray(rx, dtype=jnp.uint8)
    H = jnp.asarray(_syndrome_matrix(n_code), dtype=jnp.float32)
    syn_bits = jnp.mod(rx.astype(jnp.float32) @ H, 2.0).astype(jnp.int32)
    idx = packbits(syn_bits, jnp.int32)
    return packed_lut_lookup(idx, _decode_table_packed(n_code))


def apply_error_pattern(word, g, k_keep: int):
    """XOR the <=2-bit error pattern encoded in packed LUT value ``g``
    into (..., >=k_keep) received bits; returns (..., k_keep) corrected."""
    word = jnp.asarray(word, jnp.uint8)
    p1 = g & 0xFF
    p2 = (g >> 8) & 0xFF
    pos = jnp.arange(k_keep, dtype=jnp.int32)
    err = ((pos == p1[..., None]) | (pos == p2[..., None]))
    return jnp.bitwise_xor(word[..., :k_keep], err.astype(jnp.uint8))


def _decode(rx, n_code: int, k_keep: int):
    g = _syndrome_packed(rx, n_code)
    ok = (g & (1 << 16)) != 0
    return apply_error_pattern(rx, g, k_keep), ok


def recc_syndrome_packed(rx48):
    """(..., 48) received bits -> packed int32 LUT values (valid bit 16)."""
    return _syndrome_packed(rx48, 48)


def recc_syndrome_matrix() -> np.ndarray:
    """(48, 12) uint8 H with syndrome = rx48 @ H mod 2 — exported so the
    symbol-domain RECC decoder (rx/decoder.py) can compose H with the
    Manchester complement into one symbols->syndromes matmul."""
    return _syndrome_matrix(48)


def recc_decode_table_packed() -> np.ndarray:
    """(4096,) int32 packed syndrome LUT for the (48, 36) reverse code
    (see _decode_table_packed)."""
    return _decode_table_packed(48)


def _encode(info, k_info: int, n_out: int):
    info = jnp.asarray(info, dtype=jnp.uint8)
    # f32 matmul of 0/1 operands: counts <= 51 are exact at any
    # operand rounding (bf16, TF32) since accumulation is f32
    P = jnp.asarray(_parity_matrix(k_info), dtype=jnp.float32)
    parity = jnp.mod(info.astype(jnp.float32) @ P, 2.0)
    return jnp.concatenate([info, parity.astype(jnp.uint8)], axis=-1)


def focc_bch_encode(info28):
    """(..., 28) info bits -> (..., 40) coded forward word."""
    return _encode(info28, 28, 40)


def recc_bch_encode(info36):
    """(..., 36) info bits -> (..., 48) coded reverse word (mobile side;
    used to synthesize receiver test vectors and the MS simulator)."""
    return _encode(info36, 36, 48)


def recc_bch_decode(rx48):
    """(..., 48) received bits -> ((..., 36) corrected info bits, (...) ok).

    ok=False where the syndrome matches no <=2-error pattern.
    """
    return _decode(rx48, 48, 36)


def focc_bch_decode(rx40):
    """(..., 40) received bits -> ((..., 28) corrected info bits, (...) ok).

    The reference never decodes the forward code (mobiles do); provided for
    loopback tests and the MS simulator.
    """
    return _decode(rx40, 40, 28)
