"""repro_torch.distributed — stream-axis sharding (``sharding.py``), the
PyTorch counterpart of ``repro.distributed``'s fleet half."""
