"""Learnable log-domain optimal transport (SuperGlue-style Sinkhorn).

Counterpart of `ref_geotransformer_tpu/models/sinkhorn.py`, with the
empty-patch dustbin clamp and the final `- norm`. The iterations run in
`cuda_kernels.sinkhorn_log_norm` (the CUDA kernel on the card, the plain
loop on the CPU). In training they run the plain loop, which autograd
differentiates: the kernel has no backward, and the JAX package likewise
trains through its `lax.scan` loop, not its Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ref_geotransformer_tpu_torch.models import cuda_kernels

_INF = 1e12  # masked entries get -_INF: finite, so no NaN can arise


class LearnableLogOptimalTransport(nn.Module):
    """scores (B, M, N) with row (B, M) / col (B, N) validity masks ->
    (B, M+1, N+1) log assignment with a dustbin row and column.

    `use_kernel=False`, or `training=True` in the call, runs the plain loop.
    """

    def __init__(self, num_iterations: int, use_kernel: bool = True):
        super().__init__()
        self.num_iterations = num_iterations
        self.use_kernel = use_kernel
        self.alpha = nn.Parameter(torch.tensor(1.0))

    def forward(self, scores: torch.Tensor, row_masks: Optional[torch.Tensor] = None,
                col_masks: Optional[torch.Tensor] = None, training: bool = False) -> torch.Tensor:
        padded_scores, log_mu, log_nu, norm = self.prepare(scores, row_masks, col_masks)
        use_kernel = self.use_kernel and not training
        fn = cuda_kernels.sinkhorn_log_norm if use_kernel else cuda_kernels.sinkhorn_log_norm_plain
        return fn(padded_scores, log_mu, log_nu, self.num_iterations) - norm[:, None, None]

    def prepare(self, scores: torch.Tensor, row_masks: Optional[torch.Tensor] = None,
                col_masks: Optional[torch.Tensor] = None):
        """Dustbin-padded scores (B, M+1, N+1), marginals log_mu (B, M+1) and
        log_nu (B, N+1) (masked entries -inf'd to -1e12), and norm (B,)."""
        b, m, n = scores.shape
        dev = scores.device
        if row_masks is None:
            row_masks = torch.ones((b, m), dtype=torch.bool, device=dev)
        if col_masks is None:
            col_masks = torch.ones((b, n), dtype=torch.bool, device=dev)
        ones = torch.ones((b, 1), dtype=torch.bool, device=dev)
        padded_row_valid = torch.cat([row_masks, ones], dim=1)  # (B, M+1)
        padded_col_valid = torch.cat([col_masks, ones], dim=1)  # (B, N+1)
        score_valid = padded_row_valid[:, :, None] & padded_col_valid[:, None, :]

        padded_scores = torch.cat([scores, self.alpha.expand(b, m, 1)], dim=-1)
        padded_scores = torch.cat([padded_scores, self.alpha.expand(b, 1, n + 1)], dim=1)
        padded_scores = torch.where(score_valid, padded_scores, -_INF)

        num_valid_row = row_masks.to(scores.dtype).sum(dim=1)
        num_valid_col = col_masks.to(scores.dtype).sum(dim=1)
        # a patch with no valid row and no valid column would give the dustbin
        # marginal log(0) - log(0); clamping inside the logs changes only such
        # degenerate patches
        norm = -torch.log(torch.clamp(num_valid_row + num_valid_col, min=1.0))  # (B,)
        log_mu = torch.cat(
            [norm[:, None].expand(b, m), (torch.log(torch.clamp(num_valid_col, min=1.0)) + norm)[:, None]], dim=1
        )
        log_mu = torch.where(padded_row_valid, log_mu, -_INF)
        log_nu = torch.cat(
            [norm[:, None].expand(b, n), (torch.log(torch.clamp(num_valid_row, min=1.0)) + norm)[:, None]], dim=1
        )
        log_nu = torch.where(padded_col_valid, log_nu, -_INF)

        return padded_scores.contiguous(), log_mu.contiguous(), log_nu.contiguous(), norm
