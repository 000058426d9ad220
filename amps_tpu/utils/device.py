"""The accelerator a measurement runs on.

Scripts that measure or smoke-test the device path (bench.py,
chip_smoke.py) run only on a GPU: a run that finds none fails instead
of carrying on on the CPU, and every result names the card it came from.
"""

from __future__ import annotations

import subprocess


def gpu_devices(count: int = 1) -> list:
    """The first ``count`` JAX devices; raises RuntimeError unless JAX's
    default backend is a GPU with at least that many."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise RuntimeError(f"needs {count} GPU(s); JAX found "
                           f"{[str(d) for d in devs]}")
    return devs[:count]


def gpu_name_and_power() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them, read
    by a child process that does not touch the device through JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
