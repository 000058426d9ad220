"""amps_tpu — an array-native AMPS base-station signal-processing framework.

A from-scratch JAX/XLA rebuild of the capabilities of the
``unsynchronized/gr-amps`` GNU Radio module (TIA/EIA-553-A analog cellular
base station): FOCC/FVC forward-channel transmitters, RECC reverse-channel
receiver/decoder, command processor, and the surrounding DSP (FM modulation,
channelization, clock recovery) — redesigned for an accelerator:

* data plane: batched/array superframe synthesis, GF(2)-matmul BCH codecs,
  polyphase channelizers and overlap-save FIRs as XLA programs;
* control plane: a host-side call-state machine and TCP command server
  mirroring the reference's PMT message-port topology;
* scale: ``jax.sharding`` meshes over (time, channels) with ``ppermute``
  halo exchange for overlap-save boundaries.

Layer map (mirrors SURVEY.md §1):
  codec/    L0+L1  bit/word builders+parsers, BCH, Manchester
  tx/       L2 TX  FOCC superframe + FVC burst synthesis, FSK/FM modulator
  rx/       L2 RX  RECC front end, timing recovery, correlator, word decode
  dsp/      L4     FIR design, polyphase channelizer, FM primitives
  parallel/ —      mesh/sharding/halo exchange (new: reference had none)
  control/  L2/L4  call control, command processing, TCP server
  runtime/  L3     streaming executor + native C++ host runtime
  ref/      —      pure-NumPy oracle for golden vectors (test-only)
"""

__version__ = "0.1.0"

from amps_tpu.config import SystemConfig, PipelineConfig  # noqa: F401
