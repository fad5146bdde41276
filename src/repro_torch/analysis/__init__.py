"""The port's static checks and its run-time sanitizer.

* **Lint-time** (:mod:`repro_torch.analysis.framework` +
  :mod:`repro_torch.analysis.rules`): AST rules with ``RPA0xx`` codes, the
  JAX package's linter ported to torch code: family threading, the
  ``torch.autograd.Function`` contract, the CUDA launch-shape audit
  (reusing :mod:`repro_torch.kernels.autotune`'s shared-memory model),
  documented zero cotangents, deprecated imports, family coverage, the
  fidelity knob, serving batching and observability names. Run
  ``python -m repro_torch.analysis src``. Suppress a deliberate exception
  with ``# repro: allow[RPA0xx] justification``, the spelling both
  linters read. The rule catalogue is :mod:`repro_torch.analysis.rules`.
* **Run-time** (:mod:`repro_torch.analysis.sanitize`): NaN/Inf and
  domain-invariant checks of the frontier entry points and the PGD loops,
  on with ``REPRO_SANITIZE=1``.
"""
from .framework import (  # noqa: F401
    Finding,
    FileContext,
    Project,
    all_rules,
    build_project,
    collect_files,
    format_json,
    format_text,
    register,
    rule_codes,
    run_paths,
    run_project,
)
