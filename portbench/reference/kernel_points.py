"""KPConv kernel-point dispositions.

The `dispositions/k_*_3D.npy` files are byte-for-byte copies of the JAX
package's (`ref_geotransformer_tpu/models/dispositions`), so both packages
start from the same kernel points; a checkpoint's `kernel_points` buffers
override them.
"""

from __future__ import annotations

import os

import numpy as np

_DISPOSITIONS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dispositions")


def load_kernels(radius: float, num_kernel_points: int, dimension: int = 3) -> np.ndarray:
    """(num_kernel_points, dimension) kernel points scaled to `radius`."""
    path = os.path.join(_DISPOSITIONS, f"k_{num_kernel_points:03d}_{dimension}D.npy")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no kernel disposition for {num_kernel_points} points in {dimension}D: {path}")
    return (np.load(path) * radius).astype(np.float32)
