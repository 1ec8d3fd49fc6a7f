"""Host-side batch assembly: pad variable-size pairs to the static capacity
contract and stack them.

Replaces the reference's DataLoader + registration_collate_fn_stack_mode
(utils/data.py:143-254) with a crucial difference: no neighbor computation
happens on the host. The loader ships only padded raw clouds + masks +
transforms; the multi-resolution pyramid (voxel subsample + radius searches)
is built on the device by the step (engine/steps.py), so DataLoader
workers and the C++ extension disappear entirely. The worker thread of
`PairLoader.__iter__` makes numpy arrays only; the steps move them to the
device in the main thread.

A copy of `ref_geotransformer_tpu/data/loader.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
import queue as queue_mod
from typing import Dict, Iterator, Optional

import numpy as np

from ref_geotransformer_tpu_torch.config import GeoTransformerConfig
from ref_geotransformer_tpu_torch.data.pyramid import pad_points


def pack_single(data: Dict, capacity: int) -> Dict:
    """Pad a single-cloud item (utils/data.py:84-140's single collate role)."""
    points, masks = pad_points(data["points"], capacity)
    packed = {"points": points, "masks": masks}
    if "feats" in data:
        feats = np.zeros((capacity, data["feats"].shape[1]), np.float32)
        feats[: data["feats"].shape[0]] = data["feats"]
        packed["feats"] = feats
    return packed


def _fit_capacity(points: np.ndarray, capacity: int) -> np.ndarray:
    """Random-truncate a cloud that exceeds the static capacity (deterministic
    per cloud: seeded from its size) — the capacity analogue of the
    reference's dataset point_limit truncation; raising would kill val/test
    runs whose configs set point_limit=None."""
    n = points.shape[0]
    if n <= capacity:
        return points
    rng = np.random.default_rng(n)
    return points[rng.permutation(n)[:capacity]]


def pack_pair(data: Dict, capacity: int) -> Dict:
    """Pad one dataset item to the raw-cloud capacity."""
    ref_points, ref_masks = pad_points(_fit_capacity(data["ref_points"], capacity), capacity)
    src_points, src_masks = pad_points(_fit_capacity(data["src_points"], capacity), capacity)
    packed = {
        "ref_points": ref_points,
        "ref_masks": ref_masks,
        "src_points": src_points,
        "src_masks": src_masks,
    }
    if "transform" in data:
        packed["transform"] = np.asarray(data["transform"], np.float32)
    return packed


class PairLoader:
    """Iterates batches of padded pairs: dict of (B, ...) numpy arrays.

    A background thread overlaps disk IO/augmentation with device compute
    (the reference's num_workers analogue; one thread suffices because the
    heavy per-pair precompute moved on-device).
    """

    def __init__(
        self,
        dataset,
        cfg: GeoTransformerConfig,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        self.dataset = dataset
        self.capacity = cfg.capacities.points[0]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        # per-host sharding (the DistributedSampler analogue)
        self.num_shards = num_shards
        self.shard_index = shard_index

    def __len__(self) -> int:
        # per-shard index count: equal across shards by wrap-padding (_indices)
        n = -(-len(self.dataset) // self.num_shards)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            indices = self.rng.permutation(indices)
        if self.num_shards > 1:
            # Wrap-pad so every shard has the same length (reference
            # DistributedSampler, utils/torch.py:62-66). Unequal shard
            # lengths deadlock multihost SPMD: the processes holding an
            # extra batch block in a collective the others never join.
            total = -(-len(indices) // self.num_shards) * self.num_shards
            pad = total - len(indices)
            if pad:
                indices = np.concatenate([indices, indices[:pad]])
        return indices[self.shard_index :: self.num_shards]

    def _make_batches(self) -> Iterator[Dict]:
        indices = self._indices()
        for start in range(0, len(indices), self.batch_size):
            chunk = indices[start : start + self.batch_size]
            real = len(chunk)
            if real < self.batch_size:
                if self.drop_last:
                    return
                # repeat-pad the final batch to the static batch size; the
                # '_pair_masks' entry lets steps down-weight the duplicates
                chunk = np.concatenate([chunk, chunk[: self.batch_size - real]])
            items = [pack_pair(self.dataset[int(i)], self.capacity) for i in chunk]
            batch = {k: np.stack([it[k] for it in items], 0) for k in items[0]}
            pair_masks = np.zeros(self.batch_size, bool)
            pair_masks[:real] = True
            batch["_pair_masks"] = pair_masks
            yield batch

    def iter_single(self) -> Iterator[tuple]:
        """Yield (packed_pair, metadata) one pair at a time — the SingleTester
        protocol (metadata carries scene_name/frame ids for feature dumps)."""
        meta_keys = ("scene_name", "ref_frame", "src_frame", "overlap")
        for i in self._indices():
            item = self.dataset[int(i)]
            meta = {k: item[k] for k in meta_keys if k in item}
            yield pack_pair(item, self.capacity), meta

    def __iter__(self) -> Iterator[Dict]:
        if self.prefetch <= 0:
            yield from self._make_batches()
            return

        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            try:
                for batch in self._make_batches():
                    q.put(batch)
                q.put(sentinel)
            except BaseException as exc:  # propagate dataset errors to the consumer
                q.put(exc)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
