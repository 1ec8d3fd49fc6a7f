"""The benchmark of the PyTorch/CUDA port (`ref_geotransformer_tpu_torch`).

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>` runs one cell of
`BENCHMARK.json` once; `python3 -m portbench.control` reads the numbers the limits of `correct` are
set from. Nothing here imports JAX or the JAX package.
"""
