"""Vectorized Manchester codec.

Conventions (bit-exact with the reference):
* encode (focc_segment ctor, lib/amps_packet.h:47-76): bit 0 -> (+1, -1),
  bit 1 -> (-1, +1), each half repeated sps times;
* decode (manchester_decode_binbuf, lib/utils.cc:28-59) on sliced 0/1
  symbols: (1,0) -> 0, (0,1) -> 1, (1,1) -> 0 + bad, (0,0) -> 1 + bad;
  the bad-symbol count is the reference's only link-quality metric
  (printed at lib/recc_decode_impl.cc:98) and is kept as a first-class
  output here.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def manchester_encode_symbols(bits, sps: int = 1):
    """(..., n) bits -> (..., n*2*sps) ±1 int8 symbol samples."""
    bits = jnp.asarray(bits)
    first = jnp.where(bits == 0, jnp.int8(1), jnp.int8(-1))
    pair = jnp.stack([first, -first], axis=-1)  # (..., n, 2)
    if sps > 1:
        pair = jnp.repeat(pair, sps, axis=-1)  # (..., n, 2*sps)
    return pair.reshape(*bits.shape[:-1], -1)


def manchester_decode_bits(symbols01):
    """(..., 2n) sliced 0/1 symbols -> ((..., n) bits, (...,) bad count)."""
    s = jnp.asarray(symbols01)
    # stride-2 slices, not a (..., 2)-minor reshape (a minor dim of 2
    # makes every downstream op work on narrow rows)
    a = s[..., 0::2].astype(jnp.int32)
    # (1,0)->0 (0,1)->1 (1,1)->0+bad (0,0)->1+bad: the output bit is always
    # the complement of the first half-symbol (lib/utils.cc:36-53).
    bits = (1 - a).astype(jnp.uint8)
    # bad count = pairs whose halves AGREE.  Computed from a CONTIGUOUS
    # adjacent-xor masked to even offsets — a==b on two stride-2 views
    # is a strided gather pass; the masked form reads the symbols once,
    # fully vectorized.
    n2 = s.shape[-1]
    agree = 1 - jnp.bitwise_xor(s[..., :-1], s[..., 1:]).astype(jnp.int32)
    mask = jnp.asarray((1 - np.arange(n2 - 1) % 2).astype(np.int32))
    bad = jnp.sum(agree * mask, axis=-1)
    return bits, bad


def slice_symbols(soft):
    """±soft symbols -> 0/1 hard symbols (binary_slicer_fb: >=0 -> 1)."""
    return (jnp.asarray(soft) >= 0).astype(jnp.uint8)
