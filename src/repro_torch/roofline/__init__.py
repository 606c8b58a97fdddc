"""Roofline models of the port: the card's figures (:mod:`.hw`), the
DCIM serving bound (:mod:`.dcim`), the per-rank cost of a traced step
(:mod:`.op_cost`) and the dry-run tables (:mod:`.report`,
:mod:`.reanalyze`), the counterparts of the JAX package's
``repro/roofline/{hw,dcim,hlo_parse,report,reanalyze}.py``."""
