"""Multi-process asset-pipeline sharding: BASELINE config 5 over hosts.

Texture encoding has no cross-image coupling, so a fleet splits over
processes, one a host:

  * processes partition the ASSET LIST (round-robin by global index); no
    image bytes cross processes;
  * each process encodes its partition on its LOCAL devices through the
    ordinary :class:`~texcomp_torch.dist.pipeline.AssetPipeline`;
  * results stay in the process that made them. The only traffic between
    processes is ``torch.distributed``'s (gloo) control plane and the two
    floats a process contributes to the fleet's PSNR.

Tested by a two-process run on the CPU (tests/test_torch_multihost.py)
and on one card (chip_smoke.py): the processes encode disjoint
partitions whose union is byte-identical to a single-process run.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from texcomp_torch.dist.mesh import Mesh, visible_devices
from texcomp_torch.dist.pipeline import (AssetPipeline, TextureAsset,
                                         psnr_from_sums, quality_sums)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, timeout_s: float = 300.0) -> None:
    """Join the process group (gloo, the control plane) whose rank 0
    listens on ``coordinator_address`` ("host:port")."""
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))


def _rank_world() -> tuple[int, int]:
    """This process's index and the process count (0 and 1 outside a
    process group, as a single process is)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_mesh(device: str = "cuda") -> Mesh:
    """1-D "data" mesh over THIS process's devices: every visible CUDA
    device, or the CPU when the caller asks for it."""
    devices = [torch.device("cpu")] if device == "cpu" else visible_devices()
    return Mesh(devices, ("data",))


def partition(assets: Sequence[TextureAsset]) -> list[TextureAsset]:
    """This process's round-robin share of the global asset list.

    Round-robin (not contiguous slabs) so size-skewed fleets balance:
    consecutive assets of one size class spread across processes."""
    idx, n = _rank_world()
    return [a for i, a in enumerate(assets) if i % n == idx]


def run_fleet(assets: Sequence[TextureAsset], *, mipmaps: bool = False,
              batch_size: int = 64, pipeline: AssetPipeline | None = None,
              device: str = "cuda"):
    """Encode this process's partition of a global asset fleet.

    Every process passes the SAME global asset list; each encodes only its
    partition on its local devices and returns those results. The union
    over processes covers the fleet exactly once."""
    if pipeline is None:
        pipeline = AssetPipeline(mesh=local_mesh(device), batch_size=batch_size)
    return pipeline.run(partition(assets), mipmaps=mipmaps)


def fleet_quality(images: np.ndarray, codec: str = "dxt1", *,
                  pipeline: AssetPipeline | None = None,
                  device: str = "cuda") -> float:
    """Global-fleet PSNR across every process: each encodes and decodes
    its round-robin partition of ``images`` on its local devices
    (pipeline.quality_sums), then the processes all-gather their (sum of
    squared error, count) pairs as float64 and combine them before the
    log. Every process passes the SAME image batch and returns the SAME
    PSNR; a mean of per-process PSNRs would be wrong."""
    if pipeline is None:
        pipeline = AssetPipeline(mesh=local_mesh(device))
    idx, n = _rank_world()
    mine = images[idx::n]
    se, cnt = quality_sums(pipeline, mine, codec) if len(mine) else (0.0, 0.0)
    pair = torch.tensor([se, cnt], dtype=torch.float64)
    pairs = [pair]
    if n > 1:
        pairs = [torch.empty_like(pair) for _ in range(n)]
        dist.all_gather(pairs, pair)
    sums = torch.stack(pairs)
    return psnr_from_sums(float(sums[:, 0].sum()), float(sums[:, 1].sum()))
