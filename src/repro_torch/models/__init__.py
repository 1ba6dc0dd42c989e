"""Backbones (PyTorch counterpart of ``repro.models``): the dense GQA family's
serving path — ``layers``, ``attention`` (GQA, naive and chunked),
``transformer`` (the stacked decoder, prefill and KV-cache decode) and
``model`` (``prefill``, ``serve_step``, ``decode_step``,
``serve_apply_labels``)."""
