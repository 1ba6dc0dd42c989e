"""repro_torch.distributed — logical-axis sharding on a mesh of devices in
one process (``sharding.py``) and the GPipe pipeline over a ``"stage"``
axis (``pipeline.py``), the PyTorch counterpart of ``repro.distributed``."""
