"""The JAX repository's tools on the port: the quality tools
(tools/evaluate.py, tools/quality_table.py, tools/convert_vgg19.py), the
reverse interop (tools/export_h5.py), the engine profiler
(tools/profile_engine.py) and the cross-oracle eval (tools/
cross_oracle_eval.py: the exact libjpeg round trip of the port's codec
beside the training's DCT approximation).  Each runs as ``python3 -m
denoise_gan_tpu_torch.tools.<name>``, with the JAX tool's flags and
defaults, plus ``--device`` (the card unless ``cpu`` is asked for) where
it runs a model."""
