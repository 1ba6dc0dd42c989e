"""repro_torch.runtime — checkpointing, fault tolerance and observability
(PyTorch counterpart of ``repro.runtime``): ``checkpoint.py`` (atomic, async,
keep-k, incremental saves of a tree of tensors and numpy arrays),
``fault.py`` (teacher deadlines, the NaN guard, the restart supervisor),
``telemetry.py`` (metrics registry and span tracer) and ``lockdebug.py``
(lock-order cycle detection behind ``REPRO_LOCK_DEBUG=1``).  The port keeps
its own copy of each; it imports nothing of ``repro``."""
