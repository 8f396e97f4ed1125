"""Examples, run as modules (``python -m
bevy_gaussian_splatting_tpu_torch.examples.minimal``): the JAX package's
``examples/`` on the port.  Each runs on the card unless ``--device cpu`` is
given, and writes its PNG to ``--out`` (``streaming_lod`` its flyby frames
to ``FLY_OUT``)."""
