"""Front ends: the headless renderer CLI (``viewer.headless``) and the
browser viewer (``viewer.serve``), run as modules with ``python -m``."""
