"""Cloud and scene files: PLY (``io/ply.py``), ``.gcloud`` / ``.gc4d`` in
FlexBuffers or bincode2 and ``.npz`` (``io/gcloud.py``, ``io/bincode2.py``,
``io/flexbuffers.py``), KHR_gaussian_splatting glTF / GLB scenes
(``io/scene.py``) and the loader that dispatches on the extension
(``io/loader.py``).  Decoding runs on the host in numpy; every loader returns
its clouds on ``device`` (the card unless ``device="cpu"``)."""
