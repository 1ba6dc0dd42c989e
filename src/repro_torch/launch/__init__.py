"""repro_torch.launch — device meshes for the port (``mesh.py``), the
serving driver (``serve.py``), the training driver (``train.py``) and the
dry-run (``dryrun.py``) over the step census (``census.py``)."""
