"""repro_torch.launch — device meshes for the port (``mesh.py``)."""
