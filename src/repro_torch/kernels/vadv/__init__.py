from .ops import vadv

__all__ = ["vadv"]
