"""Synthetic HAR data (numpy), the port's own copy of ``repro.data.har``."""
