"""Selections (``query/select.py``), sparse-outlier selection
(``query/sparse.py``) and point-in-mesh tests (``query/raycast.py``)."""
