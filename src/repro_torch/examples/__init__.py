"""The JAX package's examples on the port: ``python -m
repro_torch.examples.quickstart``, ``python -m
repro_torch.examples.har_drift_demo``, ``python -m
repro_torch.examples.serve_cascade`` and ``python -m
repro_torch.examples.train_lm_odl`` (``--device cpu`` off the card).
Only ``main()`` does any work."""
