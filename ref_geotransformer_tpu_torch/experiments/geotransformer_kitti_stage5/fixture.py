"""A synthetic KITTI odometry tree for fixture runs of the CLI chain.

`make_fixture_tree(root, ...)` writes float32 `.npy` scans and the metadata
pickles in the reader's on-disk layout (data/datasets/kitti.py:
metadata[pcd0/pcd1/seq_id/frame0/frame1/transform]); point
REF_GT_KITTI_ROOT at `root` to train, test and evaluate on it. A copy of
`tools/train_kitti_fixture.py::make_fixture_tree` (the same random draws, so
its defaults give the tool's tree byte for byte), with the scan's size as
parameters: the tool imports the JAX package, which the port does not.
"""

import os
import os.path as osp
import pickle
import shutil

import numpy as np

DEFAULT_SPLITS = ((("00", 2), ("01", 2)), (("06", 2),), (("08", 2),))


def _scan(rng, n, radius, falloff):
    """Synthetic LiDAR-ish scan of n points: a ground disc of `radius`
    metres (70% of the points) and six vertical structures up to 3 m. The
    ground is uniform over the disc, or with `falloff` as a spinning LiDAR's
    rings fall on flat ground: beams at evenly spaced elevations hit it at
    ranges of density ~ 1/r^2 along a ray, ~ 1/r^3 per square metre (here
    from 1 m out)."""
    n_ground = int(n * 0.7)
    if falloff:
        r = 1.0 / (1.0 - rng.uniform(0.0, 1.0 - 1.0 / radius, n_ground))
    else:
        r = np.sqrt(rng.uniform(1.0, 1.0 + radius**2, n_ground) - 1.0)
    th = rng.uniform(0, 2 * np.pi, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th), rng.normal(0, 0.05, n_ground)], axis=1)
    structures = []
    for _ in range(6):
        cx, cy = rng.uniform(-radius * 0.8, radius * 0.8, 2)
        w = rng.uniform(0.5, 2.0)
        m = (n - n_ground) // 6
        structures.append(np.stack([
            cx + rng.uniform(-w, w, m),
            cy + rng.uniform(-w, w, m),
            rng.uniform(0.0, 3.0, m),
        ], axis=1))
    return np.concatenate([ground] + structures, axis=0).astype(np.float32)


def _transform(rng):
    """Odometry-like motion: yaw + small pitch/roll, few-meter translation."""
    from scipy.spatial.transform import Rotation

    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = Rotation.from_euler(
        "zyx", [rng.uniform(-20, 20), rng.uniform(-2, 2), rng.uniform(-2, 2)], degrees=True
    ).as_matrix()
    t[:3, 3] = [rng.uniform(-3, 3), rng.uniform(-3, 3), rng.uniform(-0.2, 0.2)]
    return t


def make_fixture_tree(root, pairs_per_split=DEFAULT_SPLITS, points=1800, radius=10.0, falloff=False):
    """Scans of `points` points over a disc of `radius` metres (ref, and a
    90% subset of the same scan moved into the earlier frame as src) for
    the train, val and test splits: (sequence id, number of pairs) each.
    `falloff` thins the ground with range (`_scan`), so a scan of a few tens
    of metres fills the KITTI capacities level by level as an odometry scan
    does, where a uniform disc overflows the fine levels first."""
    rng = np.random.default_rng(11)
    if osp.isdir(root):
        shutil.rmtree(root)
    os.makedirs(osp.join(root, "metadata"))

    for split, seqs in zip(("train", "val", "test"), pairs_per_split):
        metadata = []
        for seq_id, n_pairs in seqs:
            os.makedirs(osp.join(root, "downsampled", seq_id), exist_ok=True)
            for k in range(n_pairs):
                frame0, frame1 = 2 * k, 2 * k + 1
                gt = _transform(rng)
                base = _scan(rng, points, radius, falloff)
                ref = base + rng.normal(0, 0.01, base.shape).astype(np.float32)
                # ref ~= gt @ src: src lives in the earlier frame
                sel = base[rng.permutation(len(base))[: int(len(base) * 0.9)]]
                src = ((sel - gt[:3, 3]) @ gt[:3, :3]).astype(np.float32)
                pcd0 = f"downsampled/{seq_id}/{frame0:06d}.npy"
                pcd1 = f"downsampled/{seq_id}/{frame1:06d}.npy"
                np.save(osp.join(root, pcd0), ref.astype(np.float32))
                np.save(osp.join(root, pcd1), src)
                metadata.append({
                    "seq_id": seq_id, "frame0": frame0, "frame1": frame1,
                    "transform": gt, "pcd0": pcd0, "pcd1": pcd1,
                })
        with open(osp.join(root, "metadata", f"{split}.pkl"), "wb") as f:
            pickle.dump(metadata, f)
