"""Rule modules of the port's invariant linter: the rule catalogue.

Importing this package registers every rule with the framework registry
(:func:`repro_torch.analysis.framework.register`). One module per
invariant group; the codes are the JAX package's, so one pragma
(``# repro: allow[RPA0xx]``) serves both linters:

* :mod:`.family`     — RPA001/RPA002: family-threading completeness
  (``X.apply(...)`` of an autograd.Function resolves to ``X.forward``)
* :mod:`.vjp`        — RPA010-RPA012: the ``torch.autograd.Function``
  contract: a forward without a backward, the backward's cotangent arity
  against the forward's inputs, ``save_for_backward`` against the
  ``saved_tensors`` unpack
* :mod:`.launch`     — RPA030-RPA032: the CUDA launch-shape audit: the
  ``kernels.autotune`` model's plan against the shared memory a block may
  use, launch counts made by floor division, no shape fitting at all
* :mod:`.contracts`  — RPA040/RPA050: documented zero cotangents (also in
  an autograd.Function's ``backward``), deprecated ``core.normal`` imports
* :mod:`.famcov`     — RPA060: every FAMILIES entry reaches all threading
  sites of its own package (ref, kernel wrappers, custom VJP, autotune,
  sim ground truth, and the port's ``csrc/family.cuh``)
* :mod:`.fidelity`   — RPA070: frontier_moments call sites must thread the
  fidelity knob, not hard-code ``num_t``
* :mod:`.serving`    — RPA080: no per-instance frontier_moments loops on the
  serving path (stack rows, one launch per family group)
* :mod:`.observability` — RPA090/RPA091: span/event names come from the
  ``obs.names`` registry; no wall-clock ``time.time()`` in timing paths
  (files under ``repro/`` or ``repro_torch/``)

The JAX package's RPA020-RPA022 (``staticargs.py``: ``jit`` static
arguments, self-mutation under a trace, stale ``static_argnames``) have no
twin: the port has no ``jit``, no ``torch.compile`` and no graph capture,
so nothing in it is traced. Its RPA010-RPA012 and RPA030-RPA032 carry the
torch meaning above (the JAX package's are ``custom_vjp``/``defvjp`` and
the Pallas VMEM budget).
"""
from . import (contracts, famcov, family, fidelity, launch,  # noqa: F401
               observability, serving, vjp)
