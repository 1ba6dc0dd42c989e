"""The paper's tables and figures on the port (Tables 1-4, Figs 3-4).

Counterparts of the paper part of the JAX package's root ``benchmarks``
package: ``common`` (the §3 drift protocol on the fleet engine),
``paper_tables`` (one function per table or figure) and ``run`` (``python
-m repro_torch.benchmarks.run``).  Nothing runs at import.
"""
