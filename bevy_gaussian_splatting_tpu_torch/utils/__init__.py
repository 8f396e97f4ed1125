"""Utilities: image encoding and PNG files (``utils/image.py``)."""
