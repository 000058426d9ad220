"""Native runtime (libampsrt) tests: bit-exact vs the NumPy oracle."""

import numpy as np
import pytest

from amps_tpu.runtime import native_rt
from amps_tpu.ref import bch_ref, frames_ref



@pytest.fixture(autouse=True)
def native():
    """Availability is decided when a test runs (building the library
    on first use), never while the module is imported."""
    if not native_rt.available():
        pytest.skip("native toolchain unavailable")


def test_bch_encode_matches_oracle(rng):
    for _ in range(20):
        info = rng.integers(0, 2, 28).astype(np.uint8)
        assert np.array_equal(native_rt.focc_bch_encode(info),
                              bch_ref.focc_bch_encode(info))
        info36 = rng.integers(0, 2, 36).astype(np.uint8)
        assert np.array_equal(native_rt.recc_bch_encode(info36),
                              bch_ref.recc_bch_encode(info36))


def test_bch_decode_matches_oracle(rng):
    # clean, 1-2 errors, and random garbage
    for nerr in (0, 1, 2):
        for _ in range(10):
            info = rng.integers(0, 2, 36).astype(np.uint8)
            tx = bch_ref.recc_bch_encode(info)
            rx = tx.copy()
            pos = rng.choice(48, size=nerr, replace=False)
            rx[pos] ^= 1
            got, ok = native_rt.recc_bch_decode(rx)
            assert ok
            assert np.array_equal(got, info)
    for _ in range(30):
        rx = rng.integers(0, 2, 48).astype(np.uint8)
        got, ok = native_rt.recc_bch_decode(rx)
        want, wok = bch_ref.recc_bch_decode(rx)
        assert ok == wok
        if wok:
            assert np.array_equal(got, want)


def test_manchester_roundtrip(rng):
    bits = rng.integers(0, 2, 200).astype(np.uint8)
    syms = native_rt.manchester_encode(bits, 3)
    want = frames_ref.manchester_symbols(bits, 3)
    assert np.array_equal(syms, want)
    hard = (syms[::3] > 0).astype(np.uint8)  # one sample per half-symbol
    out, bad = native_rt.manchester_decode(hard)
    assert bad == 0
    assert np.array_equal(out, bits)


def test_trigger_scan():
    trig = frames_ref.manchester_symbols(frames_ref.RECC_TRIGGER_BITS)
    trig01 = (trig > 0).astype(np.uint8)
    hay = np.concatenate([np.tile([1, 0], 100).astype(np.uint8), trig01,
                          np.tile([0, 1], 50).astype(np.uint8)])
    off = native_rt.trigger_scan(hay, trig01)
    # memmem semantics: first match; dotting prefix overlaps the trigger's
    # own leading dotting, so the match lands earlier than 200
    assert off >= 0
    assert np.array_equal(hay[off:off + len(trig01)], trig01)
    assert native_rt.trigger_scan(np.zeros(50, np.uint8), trig01) == -1


def test_ring_buffer():
    r = native_rt.Ring(1 << 10)
    assert r.readable == 0
    assert r.write(b"hello world") == 11
    assert r.readable == 11
    assert r.read(5) == b"hello"
    assert r.read(100) == b" world"
    # wraparound
    blob = bytes(range(256)) * 3
    total = 0
    for _ in range(10):
        w = r.write(blob)
        total += w
        got = r.read(len(blob))
        assert got == blob[:len(got)]
    # overflow: writes cap at capacity
    big = bytes(2048)
    w = r.write(big)
    assert w == 1024
    assert r.writable == 0


def test_library_builds_from_source_into_ignored_dir(tmp_path):
    """The shared object is built from ampsrt.cc (nothing binary is
    tracked), atomically, and its default home is a directory that
    .gitignore lists."""
    import ctypes
    import os
    so = tmp_path / "build" / "libampsrt.so"
    assert native_rt.build(str(so))
    assert so.exists()
    assert [p.name for p in so.parent.iterdir()
            if p.name.endswith(".tmp")] == []
    lib = ctypes.CDLL(str(so))
    assert hasattr(lib, "amps_recc_bch_decode")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rel = os.path.relpath(os.path.dirname(native_rt._SO), repo)
    ignored = open(os.path.join(repo, ".gitignore")).read().split()
    assert rel + "/" in ignored, rel
