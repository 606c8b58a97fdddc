"""Serving-side DCIM configuration and macro selection.

The JAX package's ``serve`` also holds ``step.py`` (``make_prefill``,
``make_decode_step``, ``greedy_generate``); it comes with the port's model
zoo (ROADMAP.md queue 1, item 7).
"""

from .config import (SERVE_CONFIG_SCHEMA, ServeConfig, load_serve_config,
                     parse_pref, save_serve_config, serve_config_from_args)
from .select import MacroSelection, apply_profile, select_macros

__all__ = ["MacroSelection", "SERVE_CONFIG_SCHEMA", "ServeConfig",
           "apply_profile", "load_serve_config", "parse_pref",
           "save_serve_config", "select_macros", "serve_config_from_args"]
