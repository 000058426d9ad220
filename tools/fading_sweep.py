"""Rayleigh-fading link sweep (docs/BER.md fading section)."""
import os, sys; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_platforms", "cpu")
from amps_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
from amps_tpu.eval.ber import recc_fading_curve

SNRS = [20.0, 14.0, 10.0, 6.0]
for fd in (5.0, 77.0):
    for policy in ("first_ok", "majority"):
        r = recc_fading_curve(SNRS, doppler_hz=fd, trials=128,
                              policy=policy, seed=1)
        for snr in SNRS:
            d = r[snr]
            print(f"fd={fd:5.1f} Hz  policy={policy:9s}  SNR={snr:4.0f} dB"
                  f"  detect={d['detect_rate']:.3f}"
                  f"  word_success={d['word_success_rate']:.3f}")
