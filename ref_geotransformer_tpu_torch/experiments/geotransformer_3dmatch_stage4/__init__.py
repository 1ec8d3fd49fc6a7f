"""3DMatch stage 4: `trainval`, `test` and `eval` (the counterparts of
`experiments/geotransformer_3dmatch_stage4/{trainval,test,eval}.py`), with
`config`, `dataset` and the synthetic `fixture` tree."""
