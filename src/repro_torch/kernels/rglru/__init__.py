from .ops import rglru_scan

__all__ = ["rglru_scan"]
