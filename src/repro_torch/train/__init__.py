"""Training of the port's models, on one device or over a mesh of ranks
(the JAX package's ``repro.train``)."""

from .step import AUX_COEF, init_train_state, make_loss_fn, make_train_step

__all__ = ["AUX_COEF", "init_train_state", "make_loss_fn", "make_train_step"]
