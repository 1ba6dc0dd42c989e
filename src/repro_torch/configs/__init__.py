"""Configurations of the port (``har_odl``: the paper's own ODL core)."""
