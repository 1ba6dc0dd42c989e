"""Backbones (PyTorch counterpart of ``repro.models``): the dense and MoE
families' serving path — ``layers``, ``attention`` (GQA, naive and chunked;
MLA with its latent cache), ``moe`` (DeepSeekMoE's routed and shared
experts), ``transformer`` (the stacked decoder, prefill and cache decode)
and ``model`` (``prefill``, ``serve_step``, ``decode_step``,
``serve_apply_labels``; ``train_step`` for the dense stacks)."""
