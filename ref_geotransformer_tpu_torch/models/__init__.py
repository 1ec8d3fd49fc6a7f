"""Model modules (torch counterparts of `ref_geotransformer_tpu/models`)."""

from ref_geotransformer_tpu_torch.models.cordi import (
    Cordi,
    DenoisingTransformer,
    SinusoidalTimeEmbedding,
    VarianceSchedule,
    cordi_downsample,
    get_corr_from_matrix_topk,
)
