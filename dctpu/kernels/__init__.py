"""Bit pack/unpack kernels: the codec's hot layer (SURVEY.md §2.1).

Interchangeable backends behind one interface (dispatch in
dctpu.kernels.api):
  - pack_scan / unpack_scan: the production formulations ("auto" picks).
  - pack_merge: the unrolled merge-tree packer pack_scan builds on.
  - pack_xla / unpack_xla: scatter/gather v0 — the executable kernel spec.
"""

from dctpu.kernels.api import pack, unpack  # noqa: F401
from dctpu.kernels.pack_xla import pack_xla, padded_words  # noqa: F401
from dctpu.kernels.unpack_xla import unpack_xla  # noqa: F401
