"""Invariant analyzer + cache sanitizer for the port's package.

Static side: the reference's AST checks (determinism, epoch discipline,
tracer fast-guards, frozen specs, source-of-truth docstrings) with the
package renamed, scoped to ``repro_torch.*`` and run against this
package's own exemption registry (``registry.py``)::

    python -m repro_torch.analysis --strict src/repro_torch

Dynamic side: the cache sanitizer (``cachesan``), which ``core.serving``
installs from the environment.
"""
from repro_torch.analysis.checks import (CHECK_NAMES, Report, Violation,
                                         module_name, run_checks)
from repro_torch.analysis.registry import (ALLOWLIST, EPOCH_CLASSES,
                                           EPOCH_FIELDS, TRACE_HELPERS,
                                           Exemption)
from repro_torch.analysis.cachesan import (CacheDivergence, CacheSanitizer,
                                           install_from_env,
                                           sanitizer_self_test)

__all__ = [
    "ALLOWLIST", "CHECK_NAMES", "CacheDivergence", "CacheSanitizer",
    "EPOCH_CLASSES", "EPOCH_FIELDS", "Exemption", "Report", "TRACE_HELPERS",
    "Violation", "install_from_env", "module_name", "run_checks",
    "sanitizer_self_test",
]
