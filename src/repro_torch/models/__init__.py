"""The LM substrate on torch: configs' models, serving path (dense family)."""

from .model import LM, build_model, exact_param_count

__all__ = ["LM", "build_model", "exact_param_count"]
