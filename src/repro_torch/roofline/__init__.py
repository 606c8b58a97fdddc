"""Roofline models of the port: the card's figures (:mod:`.hw`) and the
DCIM serving bound (:mod:`.dcim`), the counterparts of the JAX package's
``repro/roofline/{hw,dcim}.py``."""
