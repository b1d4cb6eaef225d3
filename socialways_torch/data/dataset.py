"""Dataset loading, splitting, normalization, and static-shape packing.

Mirrors the reference's startup data path (train.py:89-124): load the
``{obsvs, preds, times, batches}`` npz, keep the first 4/5 of scene batches
for training, fit a global keep-ratio Scale over obs∪pred and normalize.

A numpy-only copy of socialways_tpu/data/dataset.py:25-191.
:func:`pack_scene_batches` reproduces the reference's greedy grouping of
ragged scene sub-batches up to ``batch_size`` (train.py:446-456), then pads
every chunk to one fixed width and carries a validity mask + per-sample
scene ids (sorted, -1 padding at the end); scene membership masks replace
the reference's per-scene Python loops in attention.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from socialways_torch.data.scale import Scale


@dataclasses.dataclass
class TrajectoryDataset:
    """Normalized dataset resident as host numpy; device placement is the
    engine's job."""

    obsvs: np.ndarray            # [N, n_past, 2], normalized
    preds: np.ndarray            # [N, n_next, 2], normalized
    times: np.ndarray            # [N]
    batches: np.ndarray          # [B, 2] scene ranges [start, end)
    scale: Scale
    train_size: int              # number of scene batches used for training

    @property
    def n_past(self) -> int:
        return self.obsvs.shape[1]

    @property
    def n_next(self) -> int:
        return self.preds.shape[1]

    @property
    def n_train_samples(self) -> int:
        return int(self.batches[self.train_size - 1][1])

    @property
    def n_test_samples(self) -> int:
        n = self.obsvs.shape[0] - self.n_train_samples
        return max(n, 1)

    @property
    def train_batches(self) -> np.ndarray:
        return self.batches[: self.train_size]

    @property
    def test_batches(self) -> np.ndarray:
        return self.batches[self.train_size:]

    @property
    def ss(self) -> float:
        """Error de-normalization factor (meters per unit), reference
        train.py:121."""
        return self.scale.sx

    def scene_ids_for_rows(self, start: int, count: int) -> np.ndarray:
        """Per-sample scene ids for rows [start, start+count), derived
        from the npz scene-batch ranges.

        Rows outside every batch get -1 (treated as padding by the social
        mask).  Use this wherever an eval slice feeds a use_social model —
        a zeros placeholder would pool attention over ONE giant scene of
        every eval agent, which is not the scene structure the model
        trained on (the bug this helper fixed in the round-4 coverage
        evals)."""
        ids = np.full(count, -1, np.int32)
        for b, (s, e) in enumerate(self.batches):
            lo, hi = max(int(s), start), min(int(e), start + count)
            if lo < hi:
                ids[lo - start:hi - start] = b
        return ids


def load_npz_dataset(path: str) -> TrajectoryDataset:
    data = np.load(path)
    obsvs = np.array(data["obsvs"], dtype=np.float32)
    preds = np.array(data["preds"], dtype=np.float32)
    times = np.array(data["times"])
    batches = np.array(data["batches"], dtype=np.int64)

    train_size = max(1, (len(batches) * 4) // 5)

    scale = Scale()
    scale.fit(obsvs.reshape(-1, 2)).fit(preds.reshape(-1, 2))
    scale.calc_scale(keep_ratio=True)
    obsvs = scale.normalize(obsvs)
    preds = scale.normalize(preds)

    return TrajectoryDataset(obsvs=obsvs, preds=preds, times=times,
                             batches=batches, scale=scale,
                             train_size=train_size)


@dataclasses.dataclass
class PackedBatches:
    """Fixed-shape padded scene chunks, indexed by chunk on axis 0."""

    obsvs: np.ndarray      # [n_chunks, width, n_past, 2]
    preds: np.ndarray      # [n_chunks, width, n_next, 2]
    scene_ids: np.ndarray  # [n_chunks, width] int32; -1 marks padding
    valid: np.ndarray      # [n_chunks, width] bool
    n_valid: np.ndarray    # [n_chunks] int32 — samples per chunk
    row_map: np.ndarray = None  # [n_chunks, width] int64 — original window
    #                             index of each packed row; -1 for padding
    #                             (lets consumers unpack per-row outputs,
    #                             e.g. cli predict)

    @property
    def n_chunks(self) -> int:
        return self.obsvs.shape[0]

    @property
    def width(self) -> int:
        return self.obsvs.shape[1]


def greedy_chunks(batches: np.ndarray, batch_size: int) -> List[List[int]]:
    """Group scene-batch indices greedily so each chunk's sample count stays
    ≤ batch_size where possible (reference accumulation, train.py:446-456).
    A single scene larger than batch_size still becomes its own chunk."""
    chunks: List[List[int]] = []
    cur: List[int] = []
    accum = 0
    n = len(batches)
    for ii in range(n):
        size = int(batches[ii][1] - batches[ii][0])
        cur.append(ii)
        accum += size
        nxt = int(batches[ii + 1][1] - batches[ii + 1][0]) if ii + 1 < n else 0
        if ii == n - 1 or accum + nxt > batch_size:
            chunks.append(cur)
            cur, accum = [], 0
    return chunks


def pack_scene_batches(
    obsvs: np.ndarray,
    preds: np.ndarray,
    batches: np.ndarray,
    batch_size: int,
    pad_chunks_to: int | None = None,
) -> PackedBatches:
    """Greedy-pack scene batches into padded fixed-width chunks.

    ``pad_chunks_to``: round n_chunks up (with fully-invalid chunks) so the
    chunk axis divides a device-mesh size.
    """
    chunk_groups = greedy_chunks(batches, batch_size)
    sizes = [sum(int(batches[b][1] - batches[b][0]) for b in grp)
             for grp in chunk_groups]
    width = max(batch_size, max(sizes)) if sizes else batch_size

    n_chunks = len(chunk_groups)
    if pad_chunks_to is not None and n_chunks % pad_chunks_to != 0:
        n_chunks += pad_chunks_to - (n_chunks % pad_chunks_to)

    n_past, n_next = obsvs.shape[1], preds.shape[1]
    out_obs = np.zeros((n_chunks, width, n_past, 2), np.float32)
    out_pred = np.zeros((n_chunks, width, n_next, 2), np.float32)
    scene_ids = np.full((n_chunks, width), -1, np.int32)
    valid = np.zeros((n_chunks, width), bool)
    n_valid = np.zeros((n_chunks,), np.int32)
    row_map = np.full((n_chunks, width), -1, np.int64)

    for ci, grp in enumerate(chunk_groups):
        cursor = 0
        for local_scene, bi in enumerate(grp):
            s, e = int(batches[bi][0]), int(batches[bi][1])
            k = e - s
            out_obs[ci, cursor:cursor + k] = obsvs[s:e]
            out_pred[ci, cursor:cursor + k] = preds[s:e]
            scene_ids[ci, cursor:cursor + k] = local_scene
            valid[ci, cursor:cursor + k] = True
            row_map[ci, cursor:cursor + k] = np.arange(s, e)
            cursor += k
        n_valid[ci] = cursor

    return PackedBatches(obsvs=out_obs, preds=out_pred, scene_ids=scene_ids,
                         valid=valid, n_valid=n_valid, row_map=row_map)
