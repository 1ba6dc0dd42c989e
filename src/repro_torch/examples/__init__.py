"""The JAX package's HAR examples on the port: ``python -m
repro_torch.examples.quickstart`` and ``python -m
repro_torch.examples.har_drift_demo`` (``--device cpu`` off the card).
Only ``main()`` does any work."""
