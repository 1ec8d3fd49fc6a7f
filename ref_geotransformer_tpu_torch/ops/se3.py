"""SE(3) helpers, batch-polymorphic. Counterpart of
`ref_geotransformer_tpu/ops/se3.py` (ref parity:
modules/ops/transformation.py:7-253)."""

from __future__ import annotations

import torch


def apply_transform(points: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform: points (*, N, 3) with transform (4, 4), or
    points (B, N, 3) with transform (B, 4, 4)."""
    rotation = transform[..., :3, :3]
    translation = transform[..., :3, 3]
    if transform.dim() == 2:
        return points @ rotation.T + translation
    return torch.einsum("...ij,...nj->...ni", rotation, points) + translation[..., None, :]


def apply_rotation(points: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """Apply a rotation matrix to points (the batching of `apply_transform`)."""
    if rotation.dim() == 2:
        return points @ rotation.T
    return torch.einsum("...ij,...nj->...ni", rotation, points)


def get_transform_from_rotation_translation(rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """(*, 3, 3) rotation and (*, 3) translation -> (*, 4, 4) transform."""
    batch_shape = rotation.shape[:-2]
    transform = torch.zeros(batch_shape + (4, 4), dtype=rotation.dtype, device=rotation.device)
    transform[..., :3, :3] = rotation
    transform[..., :3, 3] = translation
    transform[..., 3, 3].fill_(1.0)  # assigning a Python number to one element of a card tensor reads back
    return transform


def get_rotation_translation_from_transform(transform: torch.Tensor):
    """(*, 4, 4) transform -> rotation (*, 3, 3), translation (*, 3)."""
    return transform[..., :3, :3], transform[..., :3, 3]


def inverse_transform(transform: torch.Tensor) -> torch.Tensor:
    """The inverse rigid transform: R' = R^T, t' = -R^T t."""
    rotation, translation = get_rotation_translation_from_transform(transform)
    inv_rotation = rotation.transpose(-1, -2)
    inv_translation = -torch.einsum("...ij,...j->...i", inv_rotation, translation)
    return get_transform_from_rotation_translation(inv_rotation, inv_translation)


def compose_transforms(*transforms: torch.Tensor) -> torch.Tensor:
    """The first applied first: compose_transforms(T0, T1, ..., Tn) == Tn @ ... @ T1 @ T0."""
    out = transforms[0]
    for t in transforms[1:]:
        out = t @ out
    return out


def skew_symmetric_matrix(vector: torch.Tensor) -> torch.Tensor:
    """Cross-product matrices of (*, 3) vectors -> (*, 3, 3)."""
    x, y, z = vector[..., 0], vector[..., 1], vector[..., 2]
    zero = torch.zeros_like(x)
    rows = [torch.stack([zero, -z, y], dim=-1), torch.stack([z, zero, -x], dim=-1), torch.stack([-y, x, zero], dim=-1)]
    return torch.stack(rows, dim=-2)


def _rodrigues(omega: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(omega.shape)
    return eye + sin[..., None, None] * omega + (1.0 - cos)[..., None, None] * (omega @ omega)


def rodrigues_rotation_matrix(axis: torch.Tensor, angle: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation matrix from (*, 3) axes and (*,) angles (Rodrigues' formula)."""
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + eps)
    return _rodrigues(skew_symmetric_matrix(axis), torch.sin(angle), torch.cos(angle))


def rodrigues_alignment_matrix(src_vector: torch.Tensor, tgt_vector: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation taking the direction of src_vector onto tgt_vector. Parallel
    vectors (sin below eps) rotate about an axis orthogonal to src by 0 or
    pi, with the sign of their cosine, as the JAX package does."""
    src = src_vector / (torch.linalg.norm(src_vector, dim=-1, keepdim=True) + eps)
    tgt = tgt_vector / (torch.linalg.norm(tgt_vector, dim=-1, keepdim=True) + eps)
    axis = torch.linalg.cross(src, tgt)
    sin = torch.linalg.norm(axis, dim=-1)
    cos = torch.sum(src * tgt, dim=-1)
    degenerate = sin < eps
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=src.dtype, device=src.device)
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=src.dtype, device=src.device)
    helper = torch.where(torch.abs(src[..., :1]) < 0.9, e_x, e_y)
    ortho = torch.linalg.cross(src, helper.expand(src.shape))
    ortho = ortho / (torch.linalg.norm(ortho, dim=-1, keepdim=True) + eps)
    axis = torch.where(degenerate[..., None], ortho, axis / torch.clamp(sin, min=eps)[..., None])
    sin_b = torch.where(degenerate, torch.zeros_like(sin), sin)
    cos_b = torch.where(degenerate, torch.sign(cos), cos)
    return _rodrigues(skew_symmetric_matrix(axis), sin_b, cos_b)
