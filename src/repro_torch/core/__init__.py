"""The paper's contribution in PyTorch: supervised ODL (OS-ELM) + auto data pruning.

Submodules (each the counterpart of ``repro.core.<name>``):
  xorshift — Xorshift16 (7,9,8) PRNG weights (sequential + counter-based)
  oselm    — OS-ELM predict / rank-k RLS sequential training
  pruning  — P1P2 confidence metric + auto-theta ladder controller
  drift    — lightweight EWMA drift detector (mode switching)
  labels   — communication metering and one-hot teacher labels
  (the S=1 view of Algorithm 1 has an alias module here too, at the
   JAX package's original path)
"""
