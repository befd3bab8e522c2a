"""Runtime checks the port's control plane runs: the cache sanitizer
(``cachesan``), which ``core.serving`` installs from the environment. The
reference's static analyzer (``repro.analysis.checks``) reads source files
and covers this package from there."""
from repro_torch.analysis.cachesan import (CacheDivergence, CacheSanitizer,
                                           install_from_env,
                                           sanitizer_self_test)

__all__ = ["CacheDivergence", "CacheSanitizer", "install_from_env",
           "sanitizer_self_test"]
