"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_port_*.py).

Inputs are made with numpy from a seed and handed to both packages; results
are compared in float64 on the host. Importing this module imports no JAX,
so the card-only tests can run where JAX is not installed.
"""

import contextlib
import dataclasses
import os

import numpy as np
import torch

from ref_geotransformer_tpu_torch.utils.neighbor_tables import table_mismatches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5
RTOL = 2e-5


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def scaled_error(ours, theirs, atol=ATOL, rtol=RTOL) -> float:
    """max |a - b| / (|b| * rtol / atol + 1): absolute error near zero,
    relative error (rtol) for large values."""
    a = to_np(ours).astype(np.float64)
    b = to_np(theirs).astype(np.float64)
    assert a.shape == b.shape, f"shape {a.shape} vs {b.shape}"
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b) / (np.abs(b) * rtol / atol + 1.0)))


def assert_close(ours, theirs, atol=ATOL, rtol=RTOL, name=""):
    err = scaled_error(ours, theirs, atol, rtol)
    assert err <= atol, f"{name}: max scaled error {err:.3e} > {atol}"


def assert_tables_match(ours, theirs, q_points, s_points, name="", tie_tol=1e-6):
    """Neighbor/patch tables (M, H), sentinel = len(s_points): equal up to
    ties within `tie_tol` (`utils/neighbor_tables.py::table_mismatches`)."""
    _, bad, _ = table_mismatches(to_np(ours), to_np(theirs), to_np(q_points), to_np(s_points), tie_tol)
    assert not bad, f"{name}: {len(bad)} rows differ beyond ties; {bad[0]}"


def to_torch(tree, device="cpu"):
    """Nested dict/tuple of JAX or numpy arrays -> the same structure of torch tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(to_torch(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


@contextlib.contextmanager
def jax_target_keys(keys: np.ndarray):
    """Within the block, the JAX package's target sampler draws its uniform
    keys from `keys` (S, M * N): the i-th distinct PRNG key that
    `jax.random.uniform` meets at shape keys.shape[1:] gets keys[i] (a host
    callback hands them out in order; other shapes draw as usual). Yields
    the dict of keys met, whose length counts the draws."""
    import jax
    import jax.numpy as jnp
    import pytest

    order = {}

    def host_keys(key_data):
        index = order.setdefault(tuple(np.asarray(key_data).ravel().tolist()), len(order))
        return keys[index]

    uniform = jax.random.uniform

    def patched_uniform(key, shape=(), *args, **kwargs):
        if tuple(shape) != keys.shape[1:]:
            return uniform(key, shape, *args, **kwargs)
        key_data = jax.random.key_data(key) if jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key) else key
        return jax.pure_callback(host_keys, jax.ShapeDtypeStruct(keys.shape[1:], jnp.float32), key_data,
                                 vmap_method="sequential")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", patched_uniform)
        yield order


@contextlib.contextmanager
def port_target_keys(keys: np.ndarray, next_index):
    """Within the block, the port's target sampler takes keys[next_index()]
    for each draw."""
    import pytest
    import ref_geotransformer_tpu_torch.models.geotransformer as port_geotransformer

    sample = port_geotransformer.superpoint_target_sample

    def sample_with_keys(*args, generator=None):
        return sample(*args, keys=torch.from_numpy(keys[next_index()]))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_geotransformer, "superpoint_target_sample", sample_with_keys)
        yield


def tiny4_config(dtype="float32"):
    """4-stage variant of tests/utils.py::tiny_config (narrow widths, small
    caps): the shape of the 3DMatch model at a size that runs in seconds."""
    from ref_geotransformer_tpu.config import CapacityConfig, GeoTransformerModuleConfig
    from tests.utils import tiny_config

    cfg = tiny_config()
    return cfg.replace(
        capacities=CapacityConfig(
            points=(512, 256, 128, 64),
            neighbor_limits=(40, 40, 40, 40),  # no row fills up: no truncation ties
            gt_candidates=256,
            correspondence_limit=512,
            search_chunk=128,
        ),
        backbone=dataclasses.replace(cfg.backbone, num_stages=4, init_voxel_size=0.05, dtype=dtype),
        geotransformer=GeoTransformerModuleConfig(
            input_dim=256, hidden_dim=48, output_dim=64, num_heads=4,
            blocks=("self", "cross", "self", "cross"), sigma_d=0.2, sigma_a=15.0, angle_k=3,
        ),
    )


def tiny3_config():
    """The shape of the LineMod encoder model (3 stages, decoders down to
    level 0, patches of level-0 points) at tests/utils.py::tiny_config's
    narrow widths: decoder2 a UnaryBlock, decoder1 the LastUnaryBlock."""
    from ref_geotransformer_tpu.config import CapacityConfig, ModelConfig
    from tests.utils import tiny_config

    cfg = tiny_config()
    return cfg.replace(
        capacities=CapacityConfig(
            points=(512, 192, 64),
            neighbor_limits=(40, 40, 40),  # no row fills up: no truncation ties
            gt_candidates=256,
            correspondence_limit=512,
            search_chunk=128,
        ),
        backbone=dataclasses.replace(cfg.backbone, fine_level=0),
        model=ModelConfig(ground_truth_matching_radius=0.05, num_points_in_patch=16, num_sinkhorn_iterations=20),
    )


def port_config(cfg):
    """The JAX package's config dataclasses -> the port's (same fields)."""
    from ref_geotransformer_tpu_torch import config as tc

    def conv(obj):
        if not dataclasses.is_dataclass(obj):
            return obj
        cls = getattr(tc, type(obj).__name__)
        return cls(**{f.name: conv(getattr(obj, f.name)) for f in dataclasses.fields(obj)})

    return conv(cfg)


def demo_crop(n_points: int, seed: int = 0, radius: float = 0.6):
    """A crop of the 3DMatch demo pair: the points of each cloud within
    `radius` of a common centre, subsampled to at most n_points."""
    rng = np.random.default_rng(seed)
    ref = np.load(os.path.join(ROOT, "data", "demo", "ref.npy")).astype(np.float32)
    src = np.load(os.path.join(ROOT, "data", "demo", "src.npy")).astype(np.float32)
    centre = ref[rng.integers(len(ref))]
    out = []
    for cloud in (ref, src):
        near = cloud[np.linalg.norm(cloud - centre, axis=1) < radius]
        out.append(near[rng.permutation(len(near))[:n_points]])
    return out


def tiny5_config():
    """The shape of the KITTI stage-5 model (5 stages, decoders from level 4
    up to level 1, patches of level-1 points) at tests/utils.py::tiny_config's
    narrow widths (init_dim 16, so the transformer's input is 16 * 2^5 = 512
    wide), on a voxel that gives tests/test_torch_port_model.py::surface_pair
    some 10-20 level-4 nodes."""
    from ref_geotransformer_tpu.config import CapacityConfig, GeoTransformerModuleConfig
    from tests.utils import tiny_config

    cfg = tiny_config()
    return cfg.replace(
        capacities=CapacityConfig(
            points=(512, 512, 256, 128, 64),
            neighbor_limits=(40, 40, 40, 40, 40),  # no row fills up: no truncation ties
            gt_candidates=256,
            correspondence_limit=512,
            search_chunk=128,
        ),
        backbone=dataclasses.replace(cfg.backbone, num_stages=5, init_voxel_size=0.02),
        geotransformer=GeoTransformerModuleConfig(
            input_dim=512, hidden_dim=48, output_dim=64, num_heads=4,
            blocks=("self", "cross", "self", "cross"), sigma_d=0.2, sigma_a=15.0, angle_k=3,
        ),
    )
