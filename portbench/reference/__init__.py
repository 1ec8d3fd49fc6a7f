"""The benchmark's plain reference of GeoTransformer.

A frozen copy of the plain PyTorch paths of `ref_geotransformer_tpu_torch`
at commit 14ca209 (config, ops, pyramid, models with `use_kernels=False`),
with every import pointed inside this package and every CUDA kernel left
out: `plain_kernels.py` holds the plain versions only. It imports nothing
of the program, so a later change to the program cannot move the yardstick.
"""
