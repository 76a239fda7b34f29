"""qlint: whole-pipeline static analysis for quantization configs.

Public surface:
  * ``lint(cfg, policy, recipe=None, ...) -> Report`` — analyze one launch
    tuple symbolically (``repro_torch.analysis.qlint``).
  * ``Diagnostic`` / ``Report`` / ``Severity`` / ``CODES`` — the coded
    diagnostic registry (``repro_torch.analysis.diagnostics``).
  * CLI: ``python -m repro_torch.launch.lint`` (human text + ``--json``).

The port of the reference package's analyzer: the same codes and reports
on the same inputs, except QL303, which asks the Hopper kernels' own
shared-memory plans, and QL602's platform reason (no CUDA device).

This ``__init__`` stays dependency-light (it imports no pass at
package-import time) so the runtime shims in ``core.policy`` can
lazy-import the check functions cheaply.
"""

from repro_torch.analysis.diagnostics import CODES, Diagnostic, Report, Severity

__all__ = ["CODES", "Diagnostic", "Report", "Severity", "lint"]


def lint(*args, **kw):
    """Lazy forwarding to :func:`repro_torch.analysis.qlint.lint` (keeps
    the package import free of the analysis passes, which import the
    kernels' plans)."""
    from repro_torch.analysis.qlint import lint as _lint

    return _lint(*args, **kw)
