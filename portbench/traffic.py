"""The one traffic generator: a pool of pairs and the order they are sent in.

A traffic mix is a JSON file under `portbench/traffic/` whose "pool" names a
kind of pair and its parameters; this module is the only code that reads it.
Everything is drawn from the run's seed with numpy, on the host, in bulk:

* "fragments": pairs cut from two real 3DMatch fragments and their
  ground truth. Pair i keeps a seeded subset of each cloud, the share of
  kept points stepping evenly over `keep` = [lo, hi] across the pool (so
  every seed sends the same set of sizes, in another order). The source is
  turned by a uniform random rotation about its centroid and moved by up to
  `max_translation` metres; its ground truth is composed to match.
* "scans": synthetic LiDAR scans (a frozen copy of the KITTI fixture's
  `_scan` and `_transform` in the port's experiments): a ground disc of
  `radius` metres thinned with range, six structures, `points` points. The
  reference is the scan plus noise, the source a `keep` share of it moved
  into the earlier frame by an odometry motion (yaw, small tilt, a few
  metres).

Every cloud is padded to the configuration's level-0 capacity, as the
program takes it. The send order walks the pool in a fresh seeded
permutation each round, so any window sees each pair about equally often.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List

import numpy as np


def load(root: str, name: str) -> dict:
    with open(os.path.join(root, "portbench", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _pad(points: np.ndarray, capacity: int):
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"a cloud of {n} points exceeds the capacity {capacity}")
    padded = np.zeros((capacity, 3), np.float32)
    padded[:n] = points
    masks = np.zeros(capacity, bool)
    masks[:n] = True
    return padded, masks


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    """A uniform rotation, from a uniform unit quaternion."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _euler_zyx(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """Rotation of extrinsic angles about z, then y, then x, in degrees
    (scipy's `Rotation.from_euler("zyx", ...)`)."""
    a, b, c = (math.radians(v) for v in (yaw, pitch, roll))
    rz = np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]])
    ry = np.array([[math.cos(b), 0, math.sin(b)], [0, 1, 0], [-math.sin(b), 0, math.cos(b)]])
    rx = np.array([[1, 0, 0], [0, math.cos(c), -math.sin(c)], [0, math.sin(c), math.cos(c)]])
    return rz @ ry @ rx


def _fragments(root: str, spec: dict, rng: np.random.Generator) -> List[Dict[str, np.ndarray]]:
    ref = np.load(os.path.join(root, spec["ref"])).astype(np.float64)
    src = np.load(os.path.join(root, spec["src"])).astype(np.float64)
    gt = np.load(os.path.join(root, spec["gt"])).astype(np.float64)
    n = spec["pairs"]
    lo, hi = spec["keep"]
    shares = lo + (hi - lo) * np.arange(n) / max(n - 1, 1)
    pairs = []
    for share in rng.permutation(shares):
        ref_keep = rng.permutation(len(ref))[: int(round(share * len(ref)))]
        src_keep = rng.permutation(len(src))[: int(round(share * len(src)))]
        sub_ref, sub_src = ref[np.sort(ref_keep)], src[np.sort(src_keep)]
        # src' = R (src - c) + c + t, so the ground truth mapping src' onto ref is gt @ inverse(move)
        move = np.eye(4)
        centroid = sub_src.mean(axis=0)
        move[:3, :3] = _random_rotation(rng)
        direction = rng.normal(size=3)
        move[:3, 3] = centroid - move[:3, :3] @ centroid + direction / np.linalg.norm(direction) * rng.uniform(
            0.0, spec["max_translation"])
        moved = sub_src @ move[:3, :3].T + move[:3, 3]
        pairs.append({"ref": sub_ref, "src": moved, "transform": gt @ np.linalg.inv(move)})
    return pairs


def _scan(rng: np.random.Generator, n: int, radius: float, falloff: bool) -> np.ndarray:
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
        structures.append(np.stack([cx + rng.uniform(-w, w, m), cy + rng.uniform(-w, w, m),
                                    rng.uniform(0.0, 3.0, m)], axis=1))
    return np.concatenate([ground] + structures, axis=0)


def _scans(spec: dict, rng: np.random.Generator) -> List[Dict[str, np.ndarray]]:
    pairs = []
    tilt = spec["max_tilt_deg"]
    tx, ty, tz = spec["max_translation"]
    for _ in range(spec["pairs"]):
        gt = np.eye(4)
        gt[:3, :3] = _euler_zyx(rng.uniform(-spec["max_yaw_deg"], spec["max_yaw_deg"]),
                                rng.uniform(-tilt, tilt), rng.uniform(-tilt, tilt))
        gt[:3, 3] = [rng.uniform(-tx, tx), rng.uniform(-ty, ty), rng.uniform(-tz, tz)]
        base = _scan(rng, spec["points"], spec["radius"], spec["falloff"])
        ref = base + rng.normal(0, spec["noise"], base.shape)
        sel = base[rng.permutation(len(base))[: int(len(base) * spec["keep"])]]
        src = (sel - gt[:3, 3]) @ gt[:3, :3]  # ref ~= gt @ src
        pairs.append({"ref": ref, "src": src, "transform": gt})
    return pairs


def make_pool(root: str, traffic: dict, seed: int, capacity: int) -> List[Dict[str, np.ndarray]]:
    """The pool of padded pairs: ref/src points (capacity, 3) float32 and
    masks (capacity,) bool, "transform" (4, 4) float32 mapping src onto ref."""
    spec = traffic["pool"]
    rng = np.random.default_rng([seed, 1])
    if spec["kind"] == "fragments":
        raw = _fragments(root, spec, rng)
    elif spec["kind"] == "scans":
        raw = _scans(spec, rng)
    else:
        raise ValueError(f"unknown pool kind {spec['kind']!r}")
    pool = []
    for pair in raw:
        ref_points, ref_masks = _pad(pair["ref"].astype(np.float32), capacity)
        src_points, src_masks = _pad(pair["src"].astype(np.float32), capacity)
        pool.append({"ref_points": ref_points, "ref_masks": ref_masks, "src_points": src_points,
                     "src_masks": src_masks, "transform": pair["transform"].astype(np.float32)})
    return pool


def send_order(seed: int, pool_size: int, count: int) -> List[int]:
    """`count` pool indices: a fresh seeded permutation of the pool per round."""
    rng = np.random.default_rng([seed, 2])
    rounds = -(-count // pool_size)
    return [int(i) for _ in range(rounds) for i in rng.permutation(pool_size)][:count]
