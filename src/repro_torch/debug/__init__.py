"""Debug utilities: the NaN and re-build sanitizer (see ``sanitize``)."""
from repro_torch.debug.sanitize import RetraceAuditError, sanitized  # noqa: F401

__all__ = ["RetraceAuditError", "sanitized"]
