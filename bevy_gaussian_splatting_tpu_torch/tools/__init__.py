"""The tool CLIs of the JAX package's ``tools/`` on the port, run as modules
(``python -m bevy_gaussian_splatting_tpu_torch.tools.surfel_plane``).  Each
runs on the card unless ``--device cpu`` is given.  The JAX package's TPU
measurement scripts (``probe_*``, ``profile_*``, ``bench_io``) have no
counterpart: the port is measured by ``chip_smoke.py``."""
