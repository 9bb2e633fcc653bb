from .lcd import CompatError, ensure_structural_schema_compatibility

__all__ = ["ensure_structural_schema_compatibility", "CompatError"]
