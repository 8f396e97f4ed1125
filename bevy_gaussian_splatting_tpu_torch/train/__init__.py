"""Training: losses and the optimizer step (``train/losses.py``,
``train/step.py``), adaptive density control (``train/densify.py``) and the
convergence benchmark (``train/quality.py``)."""
