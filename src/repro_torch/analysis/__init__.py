"""odlint for the port — the repo-native static analysis of ``src/repro_torch``.

AST-based rules that turn the port's cross-file invariants (lock
discipline, donation safety, counter mirroring, wire-protocol
exhaustiveness, capture safety, sharding scope) into parse-time checks.
Stdlib only: it imports neither torch nor anything of the JAX package.
See ``README.md`` here for the rule catalog, and run it with
``python -m repro_torch.analysis [paths...]``.
"""

from .core import Finding, Module, Project, Rule, run_rules  # noqa: F401
from .rules import ALL_RULES  # noqa: F401
