"""Serving: the DCIM serving posture and macro selection (``config``,
``select``), and the model's prefill and cached decode steps (``step``)."""

from .config import (SERVE_CONFIG_SCHEMA, ServeConfig, load_serve_config,
                     parse_pref, save_serve_config, serve_config_from_args)
from .select import MacroSelection, apply_profile, select_macros
from .step import greedy_generate, make_decode_step, make_prefill

__all__ = ["MacroSelection", "SERVE_CONFIG_SCHEMA", "ServeConfig",
           "apply_profile", "load_serve_config", "parse_pref",
           "save_serve_config", "select_macros", "serve_config_from_args",
           "make_decode_step", "make_prefill", "greedy_generate"]
