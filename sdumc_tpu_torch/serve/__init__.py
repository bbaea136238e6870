"""Serving export of the port: the dual-view eval as ``torch.export``
programs (``serve/export.py``). Importing it imports no model code."""

from sdumc_tpu_torch.serve.export import (  # noqa: F401
    ServingBundle, export_dual_view_eval, load_exported)
