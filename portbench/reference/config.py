"""Config dataclasses.

Field names deliberately mirror the reference experiment configs
(experiments/geotransformer.3dmatch.../config.py:33-141 et al.) so that a
user of the reference can map every knob 1:1. One addition is TPU-specific:
`CapacityConfig`, the static-shape contract — per-pyramid-level point
capacities and neighbor limits that replace the reference's data-dependent
stack-mode tensors (and its offline neighbor calibration,
utils/data.py:196-221, whose output becomes `neighbor_limits` here).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Static-shape contract for one experiment.

    Attributes:
        points: per-level point capacity for ONE cloud (ref and src share it).
        neighbor_limits: per-level neighbor slots (calibrated like the
            reference's calibrate_neighbors_stack_mode; e.g. 3DMatch uses
            [38, 36, 36, 38], demo.py:52).
        gt_candidates: cap on node pairs that get exact overlap computation in
            get_node_correspondences (enclosing-sphere-intersecting pairs).
        correspondence_limit: cap on the dense-correspondence verification set
            in local-to-global registration.
        search_chunk: query rows per radius-search step (memory knob).
    """

    points: Tuple[int, ...]
    neighbor_limits: Tuple[int, ...]
    gt_candidates: int = 2048
    correspondence_limit: int = 8192
    search_chunk: int = 2048


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    num_stages: int = 4
    init_voxel_size: float = 0.025
    kernel_size: int = 15
    base_radius: float = 2.5
    base_sigma: float = 2.0
    group_norm: int = 32
    input_dim: int = 1
    init_dim: int = 64
    output_dim: int = 256
    fine_level: int = 1  # pyramid level of the finest decoder output
    # compute dtype for the KPConv aggregation einsums ('float32' or
    # 'bfloat16'; f32 accumulation either way)
    dtype: str = "float32"
    # end-to-end activation dtype inside the backbone ('float32' or
    # 'bfloat16'): inter-block features, gather tables, Dense matmuls and
    # norm outputs stay narrow (norm stats + params stay f32; outputs are
    # cast back to f32 at the backbone boundary). Halves the gather/HBM
    # traffic that dominates the backbone.
    act_dtype: str = "float32"

    @property
    def init_radius(self) -> float:
        return self.base_radius * self.init_voxel_size

    @property
    def init_sigma(self) -> float:
        return self.base_sigma * self.init_voxel_size


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    ground_truth_matching_radius: float = 0.05
    num_points_in_patch: int = 64
    num_sinkhorn_iterations: int = 100


@dataclasses.dataclass(frozen=True)
class CoarseMatchingConfig:
    num_targets: int = 128
    overlap_threshold: float = 0.1
    num_correspondences: int = 256
    dual_normalization: bool = True


@dataclasses.dataclass(frozen=True)
class GeoTransformerModuleConfig:
    input_dim: int = 1024
    hidden_dim: int = 256
    output_dim: int = 256
    num_heads: int = 4
    blocks: Tuple[str, ...] = ("self", "cross", "self", "cross", "self", "cross")
    sigma_d: float = 0.2
    sigma_a: float = 15.0
    angle_k: int = 3
    reduction_a: str = "max"


@dataclasses.dataclass(frozen=True)
class FineMatchingConfig:
    topk: int = 3
    acceptance_radius: float = 0.1
    mutual: bool = True
    confidence_threshold: float = 0.05
    use_dustbin: bool = False
    use_global_score: bool = False
    correspondence_threshold: int = 3
    correspondence_limit: Optional[int] = None
    num_refinement_steps: int = 5


@dataclasses.dataclass(frozen=True)
class CoarseLossConfig:
    positive_margin: float = 0.1
    negative_margin: float = 1.4
    positive_optimal: float = 0.1
    negative_optimal: float = 1.4
    log_scale: float = 24.0
    positive_overlap: float = 0.1


@dataclasses.dataclass(frozen=True)
class FineLossConfig:
    positive_radius: float = 0.05


@dataclasses.dataclass(frozen=True)
class LossWeights:
    weight_coarse_loss: float = 1.0
    weight_fine_loss: float = 1.0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    acceptance_overlap: float = 0.0
    acceptance_radius: float = 0.1
    inlier_ratio_threshold: float = 0.05
    rmse_threshold: float = 0.2
    rre_threshold: float = 15.0
    rte_threshold: float = 0.3
    # RR acceptance: 'rmse' (3DMatch, loss.py:133-145) or 'rre_rte' (KITTI/
    # ModelNet: RRE < rre_threshold AND RTE < rte_threshold)
    recall_criterion: str = "rmse"


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    distance_threshold: float = 0.05
    num_points: int = 3
    num_iterations: int = 1000


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    lr_decay: float = 0.95
    lr_decay_steps: int = 1
    weight_decay: float = 1e-6
    max_epoch: int = 40
    grad_acc_steps: int = 1
    # iteration-based schedule (fork's encoder/DDPM training,
    # modelnet config.py:86-94): warmup-cosine over max_iteration steps
    max_iteration: int = 100000
    snapshot_steps: int = 2000
    warmup_steps: int = 10000
    eta_init: float = 0.1
    eta_min: float = 0.1


@dataclasses.dataclass(frozen=True)
class DDPMConfig:
    """Cordi diffusion config (modelnet config.py:148-173)."""

    batch_size: int = 1
    num_steps: int = 100
    beta_1: float = 1e-4
    beta_T: float = 0.02
    sched_mode: str = "linear"
    ref_sample_num: int = 40
    src_sample_num: int = 80
    sample_topk: int = 32
    sample_topk_1_2: int = 16
    sample_topk_1_4: int = 8
    time_emb_dim: int = 512
    # denoiser transformer (modelnet config.py ddpm_transformer block)
    n_layers: int = 8
    n_heads: int = 8
    query_dimensions: int = 64
    feed_forward_dimensions: int = 2048
    activation: str = "gelu"


@dataclasses.dataclass(frozen=True)
class TrainDataConfig:
    batch_size: int = 1
    num_workers: int = 8
    point_limit: Optional[int] = 30000
    use_augmentation: bool = True
    augmentation_noise: float = 0.005
    augmentation_rotation: float = 1.0


@dataclasses.dataclass(frozen=True)
class TestDataConfig:
    batch_size: int = 1
    num_workers: int = 8
    point_limit: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class GeoTransformerConfig:
    """Top-level experiment config (the analogue of the reference's edict)."""

    seed: int = 7351
    capacities: CapacityConfig = dataclasses.field(
        default_factory=lambda: CapacityConfig(points=(30720, 10240, 3072, 1024), neighbor_limits=(38, 36, 36, 38))
    )
    backbone: BackboneConfig = dataclasses.field(default_factory=BackboneConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    coarse_matching: CoarseMatchingConfig = dataclasses.field(default_factory=CoarseMatchingConfig)
    geotransformer: GeoTransformerModuleConfig = dataclasses.field(default_factory=GeoTransformerModuleConfig)
    fine_matching: FineMatchingConfig = dataclasses.field(default_factory=FineMatchingConfig)
    coarse_loss: CoarseLossConfig = dataclasses.field(default_factory=CoarseLossConfig)
    fine_loss: FineLossConfig = dataclasses.field(default_factory=FineLossConfig)
    loss: LossWeights = dataclasses.field(default_factory=LossWeights)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    ransac: RansacConfig = dataclasses.field(default_factory=RansacConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    train: TrainDataConfig = dataclasses.field(default_factory=TrainDataConfig)
    test: TestDataConfig = dataclasses.field(default_factory=TestDataConfig)

    def replace(self, **kwargs) -> "GeoTransformerConfig":
        return dataclasses.replace(self, **kwargs)


def config_from_dict(values: dict) -> GeoTransformerConfig:
    """A `GeoTransformerConfig` from the nested dict a configuration file
    holds (lists where the dataclasses hold tuples)."""
    fields = {}
    for field in dataclasses.fields(GeoTransformerConfig):
        if field.name not in values:
            continue
        value = values[field.name]
        if isinstance(value, dict):
            sub = {k: tuple(v) if isinstance(v, list) else v for k, v in value.items()}
            value = {f.name: f.type for f in dataclasses.fields(GeoTransformerConfig)}[field.name]
            value = globals()[value](**sub) if isinstance(value, str) else value(**sub)
        fields[field.name] = value
    return GeoTransformerConfig(**fields)
