"""The JAX repository's tools on the port: the quality tools
(tools/evaluate.py, tools/quality_table.py, tools/convert_vgg19.py), the
reverse interop (tools/export_h5.py) and the engine profiler
(tools/profile_engine.py).  Each runs as ``python3 -m
denoise_gan_tpu_torch.tools.<name>``, with the JAX tool's flags and
defaults, plus ``--device`` (the card unless ``cpu`` is asked for) where
it runs a model."""
