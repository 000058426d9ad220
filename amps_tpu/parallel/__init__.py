"""Sharding & distribution: device meshes, halo exchange, sharded
pipelines.

The reference is a single-process GNU Radio app (SURVEY.md §2: no
DP/TP/PP, one mutex, one scheduler); scale-out is new capability.  The
mapping of classic parallelism onto this domain:

  data parallel   -> the 'chan' mesh axis: independent AMPS channels
  sequence parallel / context parallel -> the 'time' mesh axis: IQ
     streams sharded in time with ntaps-1 / capture-length halo exchange
     between neighbor shards (jax.lax.ppermute) — the
     overlap-save discipline of streaming FIR/correlators
  tensor parallel -> the channelizer's M-point transform stays local per
     time shard (an (M, M) matmul is small; splitting it would trade
     one matmul for two collectives)
  pipeline parallel -> the TX->channelize->RX stage chain double-buffered
     over blocks (runtime/streamer)
"""

from amps_tpu.parallel.mesh import make_mesh, MeshSpec  # noqa: F401
from amps_tpu.parallel.halo import halo_exchange_left  # noqa: F401
