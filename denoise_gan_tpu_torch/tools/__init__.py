"""The JAX repository's quality tools (tools/evaluate.py,
tools/quality_table.py, tools/convert_vgg19.py) on the port: each runs as
``python3 -m denoise_gan_tpu_torch.tools.<name>``, with the JAX tool's
flags and defaults plus ``--device`` (the card unless ``cpu`` is asked
for)."""
