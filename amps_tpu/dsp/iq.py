"""Real-pair IQ representation ("riq"): float32 arrays with trailing dim 2.

The device data path uses no complex dtypes (whether complex64 with
jnp.fft is faster on the GPU is ROADMAP D6).  All IQ signals in this framework are float32
(..., n, 2) arrays (I = [..., 0], Q = [..., 1]); XLA fuses the explicit
real arithmetic at least as well as its own complex lowering.

Complex ndarrays appear only at the numpy/test boundary via to_complex /
from_complex.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def from_complex(z):
    """numpy/jax complex (..., n) -> riq float32 (..., n, 2)."""
    z = jnp.asarray(z)
    return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1).astype(jnp.float32)


def to_complex(riq):
    """riq (..., n, 2) -> complex64 (..., n).  Host/test use only."""
    r = np.asarray(riq)
    return r[..., 0] + 1j * r[..., 1]


def expj(phase):
    """riq of exp(j*phase): (...,) float -> (..., 2)."""
    phase = jnp.asarray(phase, jnp.float32)
    return jnp.stack([jnp.cos(phase), jnp.sin(phase)], axis=-1)


def mul(a, b):
    """Complex multiply in riq: (..., 2) x (..., 2) -> (..., 2)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return jnp.stack([ar * br - ai * bi, ar * bi + ai * br], axis=-1)


def mul_conj(a, b):
    """a * conj(b) in riq."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return jnp.stack([ar * br + ai * bi, ai * br - ar * bi], axis=-1)


def conj(a):
    return jnp.stack([a[..., 0], -a[..., 1]], axis=-1)


def angle(a):
    """arg(a): (..., 2) -> (...,) float32 in (-pi, pi]."""
    return jnp.arctan2(a[..., 1], a[..., 0]).astype(jnp.float32)


def abs2(a):
    return a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]


def scale(a, s):
    return a * jnp.asarray(s, jnp.float32)[..., None]
