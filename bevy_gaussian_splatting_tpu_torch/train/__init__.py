"""Training: losses and the optimizer step (``train/losses.py``,
``train/step.py``).  Densification and the convergence benchmark come with
the training-loop slice."""
