"""Model families of the port."""
from .registry import Model, build_model

__all__ = ["Model", "build_model"]
