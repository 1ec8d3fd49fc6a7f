"""ModelNet rpmnet stage 4, trained on LineMod: the encoder phase
(`trainval_encoder`), Cordi's DDPM phase on the frozen encoder
(`train_cordi`) and `test` (the counterparts of
`experiments/geotransformer_modelnet_rpmnet_stage4/{trainval_encoder,train_cordi,test}.py`),
with `config`, `dataset` and the synthetic `fixture` trees."""
