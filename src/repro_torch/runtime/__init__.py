"""repro_torch.runtime — checkpointing and fault tolerance (PyTorch
counterpart of ``repro.runtime``): ``checkpoint.py`` (atomic, async, keep-k,
incremental saves of a tree of tensors and numpy arrays) and ``fault.py``
(teacher deadlines, the NaN guard, the restart supervisor).  The port keeps
its own copy of both; it imports nothing of ``repro``."""
