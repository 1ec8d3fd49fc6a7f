"""GeoTransformer assembly: the forward, for inference and for training.

Counterpart of `ref_geotransformer_tpu/models/geotransformer.py`
(`GeometricTransformer` and `GeoTransformer.__call__`). The backbone runs
once over the stacked (2, N, ...) ref/src pair, so its GroupNorm moments are
joint over both clouds, like the JAX package's `pair_norm` vmap. Each
`.detach()` stands where the JAX package has a `stop_gradient`. The forward
runs in the span `gt.forward` (`utils/timer.py::span`), each of its steps in
a span of its own: `gt.partition`, `gt.ground_truth`, `gt.backbone`,
`gt.transformer` (the embeddings in `gt.embedding`), `gt.coarse_matching`,
`gt.patch_gather`, `gt.optimal_transport` and `gt.lgr`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ref_geotransformer_tpu_torch.config import GeoTransformerConfig
from ref_geotransformer_tpu_torch.models.attention import RPEConditionalTransformer
from ref_geotransformer_tpu_torch.models.backbone import KPConvFPN
from ref_geotransformer_tpu_torch.models.embedding import GeometricStructureEmbedding
from ref_geotransformer_tpu_torch.models.matching import superpoint_matching, superpoint_target_sample
from ref_geotransformer_tpu_torch.models.registration import get_node_correspondences, local_to_global_registration
from ref_geotransformer_tpu_torch.models.sinkhorn import LearnableLogOptimalTransport
from ref_geotransformer_tpu_torch.ops.index import masked_gather
from ref_geotransformer_tpu_torch.ops.partition import point_to_node_partition
from ref_geotransformer_tpu_torch.utils.timer import span


class GeometricTransformer(nn.Module):
    """Geometric embedding + in_proj + RPE conditional transformer + out_proj.

    `dropout` (None in every shipped configuration) is the attention
    dropout of `models/attention.py`, drawn from the `generator` that
    `forward` is given; the JAX package's `GeometricTransformer` has no such
    argument (its attention modules do)."""

    def __init__(self, input_dim, output_dim, hidden_dim, num_heads, blocks, sigma_d, sigma_a, angle_k,
                 reduction_a="max", use_kernel=True, dropout=None):
        super().__init__()
        self.embedding = GeometricStructureEmbedding(hidden_dim, sigma_d, sigma_a, angle_k, reduction_a, use_kernel)
        self.in_proj = nn.Linear(input_dim, hidden_dim)
        self.transformer = RPEConditionalTransformer(blocks, hidden_dim, num_heads, dropout=dropout)
        self.out_proj = nn.Linear(hidden_dim, output_dim)

    def forward(self, ref_points, src_points, ref_feats, src_feats, ref_masks=None, src_masks=None, generator=None):
        """All tensors batched (B, N, ...); masks (B, N) validity."""
        with span("gt.embedding"):
            ref_embeddings = self.embedding(ref_points, ref_masks)
            src_embeddings = self.embedding(src_points, src_masks)
        ref_feats, src_feats = self.transformer(
            self.in_proj(ref_feats), self.in_proj(src_feats), ref_embeddings, src_embeddings,
            masks0=ref_masks, masks1=src_masks, generator=generator,
        )
        return self.out_proj(ref_feats), self.out_proj(src_feats)


def _stack_pair(ref: Dict, src: Dict) -> Dict:
    return {key: tuple(torch.stack([r, s], dim=0) for r, s in zip(ref[key], src[key])) for key in ref}


class GeoTransformer(nn.Module):
    """Point-cloud registration model; `forward(data)` takes the dict of
    `data.pyramid.build_registration_inputs` and returns the output dict,
    whose `estimated_transform` (4, 4) maps src onto ref. With a
    ground-truth "transform" in `data` the output also holds the dense
    node overlap and ambiguity maps; `training=True` (which needs it)
    replaces the coarse proposals by targets sampled with `generator`.

    `use_kernels=False` runs the plain PyTorch versions of the CUDA kernels
    on every device (the reference the kernels are held against).
    `dropout` sets the transformer's attention dropout, drawn in training
    from `generator` (before the targets are sampled from it).
    """

    def __init__(self, cfg: GeoTransformerConfig, use_kernels: bool = True, dropout: Optional[float] = None):
        super().__init__()
        self.cfg = cfg
        self.dropout = dropout
        bb = cfg.backbone
        dtypes = {"float32": None, "bfloat16": torch.bfloat16}
        if bb.dtype not in dtypes or bb.act_dtype not in dtypes:
            raise ValueError(f"unsupported backbone dtypes: dtype={bb.dtype}, act_dtype={bb.act_dtype}")
        self.backbone = KPConvFPN(
            bb.input_dim, bb.output_dim, bb.init_dim, bb.kernel_size, bb.init_radius, bb.init_sigma,
            bb.group_norm, bb.num_stages, bb.fine_level, compute_dtype=dtypes[bb.dtype],
            act_dtype=dtypes[bb.act_dtype],
        )
        gt = cfg.geotransformer
        self.transformer = GeometricTransformer(
            gt.input_dim, gt.output_dim, gt.hidden_dim, gt.num_heads, tuple(gt.blocks), gt.sigma_d, gt.sigma_a,
            gt.angle_k, gt.reduction_a, use_kernel=use_kernels, dropout=dropout,
        )
        self.optimal_transport = LearnableLogOptimalTransport(cfg.model.num_sinkhorn_iterations,
                                                              use_kernel=use_kernels)

    def forward(self, data: Dict, training: bool = False, generator: Optional[torch.Generator] = None) -> Dict:
        """Autograd records the forward only when `training` is set."""
        if training and self.dropout and generator is None:
            raise ValueError("training with attention dropout needs a generator")
        with torch.set_grad_enabled(training), span("gt.forward"):
            return self._forward(data, training, generator)

    def _forward(self, data: Dict, training: bool, generator: Optional[torch.Generator]) -> Dict:
        cfg = self.cfg
        fine_level = cfg.backbone.fine_level
        k_patch = cfg.model.num_points_in_patch
        ref, src = data["ref"], data["src"]
        transform = data.get("transform")

        ref_points_c, src_points_c = ref["points"][-1], src["points"][-1]
        ref_masks_c, src_masks_c = ref["masks"][-1], src["masks"][-1]
        ref_points_f, src_points_f = ref["points"][fine_level], src["points"][fine_level]
        ref_masks_f, src_masks_f = ref["masks"][fine_level], src["masks"][fine_level]
        output: Dict = {
            "ref_points_c": ref_points_c,
            "src_points_c": src_points_c,
            "ref_points_f": ref_points_f,
            "src_points_f": src_points_f,
            "ref_points": ref["points"][0],
            "src_points": src["points"][0],
            "ref_point_masks": ref["masks"][0],
            "src_point_masks": src["masks"][0],
            "ref_masks_f": ref_masks_f,
            "src_masks_f": src_masks_f,
        }

        # 1. patch partition
        with span("gt.partition"):
            _, ref_node_masks, ref_node_knn_indices, ref_node_knn_masks = point_to_node_partition(
                ref_points_f, ref_points_c, k_patch, ref_masks_f, ref_masks_c
            )
            _, src_node_masks, src_node_knn_indices, src_node_knn_masks = point_to_node_partition(
                src_points_f, src_points_c, k_patch, src_masks_f, src_masks_c
            )
            ref_node_knn_points = masked_gather(ref_points_f, ref_node_knn_indices, 0.0)
            src_node_knn_points = masked_gather(src_points_f, src_node_knn_indices, 0.0)
        output["ref_node_masks"] = ref_node_masks
        output["src_node_masks"] = src_node_masks

        # ground-truth node correspondences (training labels, evaluation)
        if transform is not None:
            with span("gt.ground_truth"):
                output["gt_node_overlap_map"], output["gt_node_ambiguous_map"] = get_node_correspondences(
                    ref_points_c, src_points_c, ref_node_knn_points, src_node_knn_points, transform,
                    cfg.model.ground_truth_matching_radius, ref_node_masks, src_node_masks, ref_node_knn_masks,
                    src_node_knn_masks, candidate_limit=cfg.capacities.gt_candidates,
                )

        # 2. KPConv-FPN backbone over the stacked pair
        with span("gt.backbone"):
            feats = torch.stack([data["ref_feats"], data["src_feats"]], dim=0)
            feats_list = self.backbone(feats, _stack_pair(ref, src))
        feats_c, feats_f = feats_list[-1], feats_list[0]
        ref_feats_f, src_feats_f = feats_f[0], feats_f[1]

        # 3. geometric transformer over the superpoints
        with span("gt.transformer"):
            ref_h, src_h = self.transformer(
                ref_points_c[None], src_points_c[None], feats_c[0][None], feats_c[1][None],
                ref_masks_c[None], src_masks_c[None], generator=generator if training else None,
            )
            ref_feats_c = ref_h[0] / torch.clamp(torch.linalg.norm(ref_h[0], dim=1, keepdim=True), min=1e-12)
            src_feats_c = src_h[0] / torch.clamp(torch.linalg.norm(src_h[0], dim=1, keepdim=True), min=1e-12)
        output["ref_feats_c"] = ref_feats_c
        output["src_feats_c"] = src_feats_c
        output["ref_feats_f"] = ref_feats_f
        output["src_feats_f"] = src_feats_f

        # 4. coarse proposals
        with span("gt.coarse_matching"):
            ref_node_corr_indices, src_node_corr_indices, node_corr_scores = superpoint_matching(
                ref_feats_c.detach(), src_feats_c.detach(), ref_node_masks, src_node_masks,
                cfg.coarse_matching.num_correspondences, cfg.coarse_matching.dual_normalization,
            )
            output["ref_node_corr_indices"] = ref_node_corr_indices
            output["src_node_corr_indices"] = src_node_corr_indices
            node_corr_masks = torch.ones_like(node_corr_scores, dtype=torch.bool)

            # training: sampled ground-truth targets replace the proposals
            if training:
                if transform is None:
                    raise ValueError("training needs the ground-truth transform in data['transform']")
                ref_node_corr_indices, src_node_corr_indices, node_corr_scores, node_corr_masks = (
                    superpoint_target_sample(output["gt_node_overlap_map"], cfg.coarse_matching.num_targets,
                                             cfg.coarse_matching.overlap_threshold, generator=generator)
                )
        output["node_corr_masks"] = node_corr_masks

        # 5. patch gather
        with span("gt.patch_gather"):
            ref_idx, src_idx = ref_node_corr_indices.long(), src_node_corr_indices.long()
            ref_node_corr_knn_indices = ref_node_knn_indices[ref_idx]  # (P, K)
            src_node_corr_knn_indices = src_node_knn_indices[src_idx]
            ref_node_corr_knn_masks = ref_node_knn_masks[ref_idx] & node_corr_masks[:, None]
            src_node_corr_knn_masks = src_node_knn_masks[src_idx] & node_corr_masks[:, None]
            ref_node_corr_knn_points = ref_node_knn_points[ref_idx]
            src_node_corr_knn_points = src_node_knn_points[src_idx]
            ref_node_corr_knn_feats = masked_gather(ref_feats_f, ref_node_corr_knn_indices, 0.0)
            src_node_corr_knn_feats = masked_gather(src_feats_f, src_node_corr_knn_indices, 0.0)
        output["ref_node_corr_knn_points"] = ref_node_corr_knn_points
        output["src_node_corr_knn_points"] = src_node_corr_knn_points
        output["ref_node_corr_knn_masks"] = ref_node_corr_knn_masks
        output["src_node_corr_knn_masks"] = src_node_corr_knn_masks

        # 6. optimal transport
        with span("gt.optimal_transport"):
            matching_scores = torch.matmul(ref_node_corr_knn_feats, src_node_corr_knn_feats.transpose(1, 2))
            matching_scores = matching_scores / ref_feats_f.shape[1] ** 0.5
            matching_scores = self.optimal_transport(matching_scores, ref_node_corr_knn_masks,
                                                     src_node_corr_knn_masks, training=training)
        output["matching_scores"] = matching_scores

        # 7. local-to-global registration
        fm = cfg.fine_matching
        with span("gt.lgr"):
            lgr = local_to_global_registration(
                ref_node_corr_knn_points.detach(), src_node_corr_knn_points.detach(), ref_node_corr_knn_masks,
                src_node_corr_knn_masks, matching_scores.detach(), node_corr_scores.detach(), k=fm.topk,
                acceptance_radius=fm.acceptance_radius, mutual=fm.mutual,
                confidence_threshold=fm.confidence_threshold, use_dustbin=fm.use_dustbin,
                use_global_score=fm.use_global_score, correspondence_threshold=fm.correspondence_threshold,
                correspondence_limit=cfg.capacities.correspondence_limit,
                num_refinement_steps=fm.num_refinement_steps,
            )
        output["ref_corr_points"] = lgr.ref_corr_points
        output["src_corr_points"] = lgr.src_corr_points
        output["corr_scores"] = lgr.corr_scores
        output["corr_masks"] = lgr.corr_masks
        output["estimated_transform"] = lgr.estimated_transform
        return output
