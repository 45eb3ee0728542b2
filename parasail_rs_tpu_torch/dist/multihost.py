"""Process-group setup and cross-process gathering.

The port of ``parasail_rs_tpu.dist.multihost``: one Python process per
device, joined by ``torch.distributed.init_process_group`` (NCCL when the
processes' devices are cards, gloo on the CPU); each process feeds its
own slice of a pair batch and every process gets the whole result.
Nothing tells a program of a cluster here: the caller gives the
coordinator's address, the number of processes and this process's rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.aligner import resolve_device
from .sharded import DeviceMesh, gather_scores, run_local


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str | None = None,
               device=None) -> None:
    """Join the process group at ``tcp://coordinator_address`` as rank
    ``process_id`` of ``num_processes``.  ``backend`` None picks ``nccl``
    when ``device`` (None: the card) is a CUDA device, else ``gloo``."""
    import torch.distributed as td

    if backend is None:
        dev = resolve_device("cuda" if device is None else device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        dev = resolve_device("cuda" if device is None else device)
        if dev.index is not None:         # else: the current device
            torch.cuda.set_device(dev)
    td.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))


def global_mesh() -> DeviceMesh:
    """A 1-D mesh over every process of the default group."""
    import torch.distributed as td

    return DeviceMesh(td.get_world_size(), td.group.WORLD)


def host_local_to_global(mesh: DeviceMesh, arrays: dict) -> dict:
    """Each process passes ITS slice of the batch (same order across
    processes); every process gets the whole arrays, concatenated in rank
    order."""
    return gather_scores(arrays, mesh)


def global_to_host_local(mesh: DeviceMesh, out: dict) -> dict:
    """The full (concatenated) per-pair outputs on every process."""
    return gather_scores(out, mesh)


def align_global(mesh: DeviceMesh, profile, qidx, ridx, qlen, rlen, *,
                 open_, ext, mode, free, outputs, width="32", route="auto",
                 device=None) -> dict:
    """Process-local shards in, full results out on every process.

    Each process aligns the pairs it was given through the engine's
    dispatch (:func:`~.sharded.run_local`: the card's kernel, or on the
    CPU its plain version) and the outputs are all-gathered in rank
    order.  Nothing is padded and nothing dropped: the shards may differ
    in size."""
    local = run_local(profile, qidx, ridx, np.asarray(qlen, np.int32),
                      np.asarray(rlen, np.int32), open_=open_, ext=ext,
                      mode=mode, free=free, outputs=outputs, width=width,
                      route=route, device=device)
    return global_to_host_local(mesh, local)
