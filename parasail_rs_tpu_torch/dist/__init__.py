"""Scale-out over ``torch.distributed``: the port of
``parasail_rs_tpu.dist``.

Two kinds.  Data parallelism (:mod:`.sharded`, :mod:`.multihost`): every
rank of a process group aligns its slice of a pair batch through the
engine's own dispatch, and the per-pair outputs are all-gathered.
Sequence parallelism (:mod:`.seqpar_scan`, :mod:`.seqpar`): the reference
axis of long pairs is cut into column shards, query chunks go down the
shards as a pipeline of tiles (the tile kernel, ``csrc/scan_rowseg.cu``),
and the shards are ranks of a group (halo ``send`` / ``recv``: NCCL on
GPUs, gloo on the CPU) or, with no group, virtual shards of one device.

One card shows that this layer is correct, not that it scales: NCCL puts
one rank on a device, so on one card the group has one rank and the
shards are virtual.
"""

from .sharded import make_device_mesh, sharded_align
from .seqpar import seqpar_align, seqpar_cigars
from .seqpar_scan import seqpar_align_scan, seqpar_scan_fits

__all__ = ["make_device_mesh", "seqpar_align", "seqpar_align_scan",
           "seqpar_cigars", "seqpar_scan_fits", "sharded_align"]
