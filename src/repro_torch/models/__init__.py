"""The model zoo of the port: the transformer family (``dense``, ``vlm``,
``audio``), MoE, RWKV6 (``ssm``) and Zamba2 (``hybrid``), behind the
reference's uniform :class:`ModelApi`."""

from .registry import ModelApi, cross_entropy_loss, get_model, model_class

__all__ = ["ModelApi", "cross_entropy_loss", "get_model", "model_class"]
