"""Model zoo substrate: every architecture is a config over one stack (see
transformer.py), served (prefill, decode) and trained (``loss_fn``). Twin of
:mod:`repro.models`."""

from .model import ModelBundle, build_model, make_cache, param_count, params_from_reference

__all__ = ["ModelBundle", "build_model", "make_cache", "param_count",
           "params_from_reference"]
