"""Utilities: images, PNG and GIF files (``utils/image.py``), training
checkpoints (``utils/checkpoint.py``) and tracing (``utils/trace.py``)."""
