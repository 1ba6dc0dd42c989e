"""repro_torch.optim — AdamW for the training path (``adam.py``)."""
