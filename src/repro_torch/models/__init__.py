"""The LM substrate on torch: configs' models, serving path (dense family)."""

from .model import LM, active_param_count, build_model, exact_param_count

__all__ = ["LM", "active_param_count", "build_model", "exact_param_count"]
