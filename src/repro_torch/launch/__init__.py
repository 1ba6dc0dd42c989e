"""repro_torch.launch — device meshes for the port (``mesh.py``), the
serving driver (``serve.py``) and the training driver (``train.py``)."""
