"""repro_torch.runtime — checkpointing, fault tolerance, observability and
the elastic fleet (PyTorch counterpart of ``repro.runtime``):
``checkpoint.py`` (atomic, async, keep-k, incremental saves of a tree of
tensors and numpy arrays), ``fault.py`` (teacher deadlines, the NaN guard,
the restart supervisor), ``telemetry.py`` (metrics registry and span tracer),
``lockdebug.py`` (lock-order cycle detection behind ``REPRO_LOCK_DEBUG=1``),
``worker.py`` (one multiplexer worker behind a control socket, on the card
unless ``--device`` names another) and ``elastic.py`` (the router that
spawns workers, places tenants by shape key, migrates them over the snapshot
wire and scales the fleet in).  The control wire is the JAX package's, so
either package's router drives either package's workers.  The port keeps
its own copy of each module; it imports nothing of ``repro``."""
