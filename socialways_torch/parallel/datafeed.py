"""Multi-host data feeding (counterpart of socialways_tpu/parallel/
datafeed.py).

The single-host trainer packs every chunk on every rank and copies its own
column to its device (``mesh.shard_packed_for_mesh``).  Here each process
holds only its own rows of each chunk group, as JAX's multi-host feed
does: one device a process in torch, so a process's share of a group is
one chunk.  The "global batch" of a group is the union of the ranks'
chunks in rank order; no rank materializes it.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from socialways_torch.parallel.mesh import Mesh


def _process(process_index: Optional[int], process_count: Optional[int]
             ) -> Tuple[int, int]:
    """(index, count) of this process: the group's rank and world size,
    or (0, 1) outside a group, unless given."""
    live = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if live else 0) if process_index is None \
        else process_index
    pc = (dist.get_world_size() if live else 1) if process_count is None \
        else process_count
    return pi, pc


def local_group_slice(n_groups: int, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """The contiguous slice of chunk groups this process is responsible
    for (JAX's arithmetic: ceil split); with one process slice(0, n)."""
    pi, pc = _process(process_index, process_count)
    per = -(-n_groups // pc)
    return slice(pi * per, min((pi + 1) * per, n_groups))


def global_batch_from_local(mesh: Mesh, local: Dict[str, np.ndarray]
                            ) -> Dict[str, torch.Tensor]:
    """This process's rows of a group on its device.  The group's global
    batch is the ranks' rows concatenated in rank order (JAX assembles it
    as one sharded array; here each rank keeps its part)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
            for k, v in local.items()}


def host_chunk_feed(packed, mesh: Mesh,
                    process_index: Optional[int] = None,
                    process_count: Optional[int] = None
                    ) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
    """Stream (group index, this process's rows of the group), holding only
    them in host memory.  ``packed`` is a ``PackedBatches`` (chunk axis
    first); group g holds chunks [g D, (g + 1) D), filler chunks (scene
    ids -1, valid False) padding the last.  Each yielded batch is this
    rank's batch for ``make_dp_train_step``."""
    pi, pc = _process(process_index, process_count)
    n_dev_global = mesh.size
    n_dev_local = n_dev_global // pc
    width, n = packed.width, packed.n_chunks
    n_groups = -(-n // n_dev_global)
    arrs = {"obsvs": packed.obsvs, "preds": packed.preds,
            "scene_ids": packed.scene_ids, "valid": packed.valid}

    def chunk(idx):
        """Chunk ``idx`` of the padded stream."""
        if idx < n:
            return {k: v[idx] for k, v in arrs.items()}
        return {"obsvs": np.zeros_like(arrs["obsvs"][0]),
                "preds": np.zeros_like(arrs["preds"][0]),
                "scene_ids": np.full((width,), -1,
                                     arrs["scene_ids"].dtype),
                "valid": np.zeros((width,), bool)}

    for g in range(n_groups):
        base = g * n_dev_global + pi * n_dev_local
        local = [chunk(base + j) for j in range(n_dev_local)]
        cat = {k: np.concatenate([c[k] for c in local]) for k in arrs}
        yield g, global_batch_from_local(mesh, cat)
