"""Distribution layer: mesh setup, shard_map data parallelism, multi-host.

All parallelism here is new design — the reference C codec is
single-threaded (SURVEY.md §2.2). The axes that exist for a codec workload:

  - data parallelism over independent meter streams/blocks (`streams` mesh
    axis, the primary axis mandated by the north star [B:5]),
  - intra-stream parallelism via associative scans (inside the codec body),
  - prefix-sum offset parallelism for bitstream layout (inside the kernels),
  - replicated-state broadcast of predictor/code tables to every device,
  - ordered gather of compressed payloads back into stream order.

TP/PP/EP/attention-style parallelism is deliberately N/A for a codec.
"""

from dctpu.dist.mesh import make_mesh  # noqa: F401
from dctpu.dist.sharded import (  # noqa: F401
    compress_sharded,
    decode_blocks_sharded,
    decompress_sharded,
    encode_blocks_sharded,
)
