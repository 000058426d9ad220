"""Device-time profile of the streaming RX block on a GPU.

    python tools/profile_rx_block.py [--channels 1024] [--iters 20]

At the bench's production spec and 2^22-sample blocks it prints one
JSON object with:

* the served RX path (MultichannelReceiver.push, compacted report fetch
  at depth 1) traced with jax.profiler: device busy time per block, the
  device's idle share over the window, and the kernels that take the
  most device time;
* the analysis bank alone (the channelizer step of that block) traced
  the same way, and its share of the block's device time;
* the bytes of the (2, M, Nh) analysis planes the bank hands to the
  demodulator, computed from the shapes;
* an interleaved A/B of the channel transform's split factor (0 = one
  dense M x M matmul pair, 128 = two-stage Cooley-Tukey) on the TX
  synthesis block of the bench (3 frames, f32 operands at default
  precision), host clock around block_until_ready.  The RX bank fold
  absorbs the permutation into dense (M, M/2) matrices and takes no
  split; synthesis is where default_split acts.

Runs on a GPU only; traces go under chiprun_out/ (or --out).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_busy(trace_dir: str) -> dict:
    """Reduce one jax.profiler trace to device busy time: the union of
    the kernel intervals on the GPU planes' stream lines, the window
    they span, and device time per kernel name."""
    from jax.profiler import ProfileData
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    ivals, per_kernel, lines = [], {}, {}
    for plane in ProfileData.from_file(path).planes:
        if "/device:GPU" not in plane.name:
            continue
        plines = list(plane.lines)
        streams = [ln for ln in plines if ln.name.startswith("Stream")]
        for ln in streams or plines:
            evs = list(ln.events)
            lines[f"{plane.name}/{ln.name}"] = (
                len(evs), sum(e.duration_ns for e in evs) / 1e6)
            for e in evs:
                ivals.append((e.start_ns, e.start_ns + e.duration_ns))
                per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                      + e.duration_ns / 1e6)
    if not ivals:
        raise RuntimeError(f"no device events in {path}")
    ivals.sort()
    busy, (cs, ce) = 0.0, ivals[0]
    for s, e in ivals[1:]:
        if s > ce:
            busy += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    busy += ce - cs
    window = ivals[-1][1] - ivals[0][0]
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]
    return {"busy_ms": busy / 1e6, "window_ms": window / 1e6,
            "lines": {k: {"events": n, "ms": round(ms, 3)}
                      for k, (n, ms) in lines.items()},
            "top_kernels_ms": {k: round(v, 3) for k, v in top}}


def _trace(fn, iters: int, out_dir: str, name: str) -> dict:
    import jax
    fn()                                      # compile + warm
    jax.block_until_ready(fn())
    d = os.path.join(out_dir, name)
    t0 = time.perf_counter()
    with jax.profiler.trace(d):
        for _ in range(iters):
            r = fn()
        jax.block_until_ready(r)
    wall = time.perf_counter() - t0
    res = device_busy(d)
    res["host_wall_ms"] = wall * 1e3
    res["busy_ms_per_iter"] = res["busy_ms"] / iters
    return res


def profile(num_channels: int = 1024, block: int = 1 << 22,
            iters: int = 20, ab_rounds: int = 4, out_dir: str = "") -> dict:
    import jax
    import jax.numpy as jnp
    from amps_tpu.dsp import channelizer as chz
    from amps_tpu.parallel.pipeline import MultichannelSpec
    from amps_tpu.runtime.streamer import MultichannelReceiver

    out_dir = out_dir or tempfile.mkdtemp()
    spec = MultichannelSpec(num_channels=num_channels, taps_per_phase=8,
                            fold="bank", io_bf16=True, corr_bf16=True,
                            transform_bf16=True)
    M, T, sps = num_channels, 8, spec.chan_sps
    P = M // 2
    block -= block % P
    nh = block // P
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(0, 0.1, (block, 2)).astype(np.float32))

    rx = MultichannelReceiver(spec, threshold=0.6, max_bursts=6,
                              min_rssi=0.05)
    served = _trace(lambda: rx.push(x) and None, iters, out_dir, "served")
    served["idle_share"] = 1.0 - served["busy_ms"] / max(
        served["host_wall_ms"], 1e-9)

    h = jnp.asarray(chz.prototype_taps(M, T))
    x_ext = jnp.concatenate([jnp.zeros((M * T - P, 2), jnp.float32), x])
    split = chz.default_split(M)

    def analyze():
        return chz._analyze_block_chmajor(x_ext, h, M, T, 0, True, split,
                                          "bank", planar=True)

    bank = _trace(analyze, iters, out_dir, "analysis")
    share = bank["busy_ms_per_iter"] / served["busy_ms_per_iter"]

    Y = jnp.asarray(rng.normal(0, 0.5, (3 * 463 * 2 * sps, M, 2))
                    .astype(np.float32))
    carry = jnp.zeros((M * T - P, 2), jnp.float32)

    def synth(sp):
        return chz._synthesize_block(Y, h, M, T, 0, carry, False, sp)

    def timed(fn, n=iters):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn()
        jax.block_until_ready(r)
        return (time.perf_counter() - t0) / n * 1e3

    splits = sorted({0, split} | ({128} if M % 128 == 0 else set()))
    ab = {s: [] for s in splits}
    for rnd in range(ab_rounds):
        for s in (splits if rnd % 2 == 0 else splits[::-1]):
            ab[s].append(timed(lambda: synth(s)))
    ab = {str(s): {"synthesis_ms_median": float(np.median(v)), "runs": v,
                   "hops": int(Y.shape[0])} for s, v in ab.items()}

    plane_elems = 2 * M * nh
    return {"channels": M, "block_samples": block, "hops": nh,
            "default_split": split,
            "served_rx_block": served, "analysis_bank": bank,
            "analysis_share_of_block_device_time": share,
            "analysis_planes": {"shape": [2, M, nh],
                                "bytes_f32": plane_elems * 4,
                                "bytes_bf16": plane_elems * 2},
            "split_ab": ab}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--channels", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chiprun_out", "traces"))
    args = ap.parse_args(argv)
    from amps_tpu.utils.compile_cache import enable_compile_cache
    from amps_tpu.utils.device import gpu_devices, gpu_name_and_power
    dev = gpu_devices(1)[0]
    enable_compile_cache()
    res = profile(args.channels, iters=args.iters, out_dir=args.out)
    res["device"] = {"kind": dev.device_kind, "card": gpu_name_and_power()}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
