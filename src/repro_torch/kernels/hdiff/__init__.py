from .ops import hdiff

__all__ = ["hdiff"]
