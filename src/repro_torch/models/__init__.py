"""The model zoo of the port: the transformer family (``dense``, ``vlm``,
``audio``), behind the reference's uniform :class:`ModelApi`."""

from .registry import ModelApi, cross_entropy_loss, get_model

__all__ = ["ModelApi", "cross_entropy_loss", "get_model"]
