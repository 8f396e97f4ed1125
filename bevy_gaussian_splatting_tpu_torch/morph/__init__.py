"""Cloud morphing: interpolation between two clouds
(``morph/interpolate.py``) and particle behaviours (``morph/particle.py``)."""
