"""Serving export of the port: the dual-view eval and the feat4 beam
decode as ``torch.export`` programs (``serve/export.py``). Importing it
imports no model code."""

from sdumc_tpu_torch.serve.export import (  # noqa: F401
    DecodeBundle, ServingBundle, export_beam_decode, export_dual_view_eval, load_exported)
