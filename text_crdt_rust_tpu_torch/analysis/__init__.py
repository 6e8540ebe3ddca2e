"""tcrlint for the port — project-invariant static analysis of
``text_crdt_rust_tpu_torch`` (counterpart of ``text_crdt_rust_tpu/analysis``).

The port's load-bearing contracts are the JAX package's: byte-identical
logical trace streams, exact cost-ledger re-derivation, YATA
convergence, the hard-rejection codec discipline — plus its own: every
CUDA kernel built once and loaded once, and no host write racing a
launch still in flight.  This package moves their enforcement to lint
time: an AST pass over the port with one module per check family, a
committed allowlist for the audited intentional sites, and a tier-1
gate so a violation fails with a ``path:line`` finding.

Check families (one module each), under the JAX package's ids where the
meaning carries over:

==========================  ================================================
``checks_wallclock``        TCR-W001: wall-clock reads (``time.time``,
                            ``perf_counter``, ``datetime.now``); the port
                            reads none — callers pass ``clock=``
``checks_determinism``      TCR-D001 builtin ``hash()``, TCR-D002
                            order-sensitive set iteration, TCR-D003
                            unsorted directory walks, TCR-D004 unseeded
                            global randomness
``checks_schema``           TCR-S001 trace kinds missing from the port's
                            EVENT_SCHEMA, TCR-S002 ledger metrics with
                            unregistered families, TCR-S003 schema
                            field-set drift without the matching version
                            bump (``SCHEMA_PINS.json``)
``checks_recompile``        TCR-R001 a ``ctypes.CDLL`` load or an
                            ``nvcc``/``g++`` build outside a memoised
                            build function, TCR-R002 ``torch.compile`` /
                            ``torch.jit.script`` / ``torch.jit.trace`` in
                            an uncached function
``checks_exceptions``       TCR-X001 a swallowed fault under ``serve/`` or
                            ``net/``
``checks_pyflakes``         TCR-F401 unused module-level imports (the ruff
                            fallback)
==========================  ================================================

Dataflow families (``dataflow.py``: CFGs, reaching definitions, alias
closures, one-level call summaries over the stdlib ``ast``):

==========================  ================================================
``checks_pipeline``         TCR-P001: a host write that may alias a buffer
                            handed to ``backend.apply``, the flat engine's
                            launch or scatter, or the blocked lanes
                            replayer before its staged sync
``checks_mirror``           TCR-M001 a device-state write without its
                            paired host-mirror update, TCR-M002 a serve
                            class writing device tensors in place without
                            a ``MIRROR_CONTRACTS`` entry, TCR-M003 the
                            train boundary's write and true-up split apart
``checks_shape``            TCR-K001 a static call-site shape off the
                            declared bucket series, TCR-K002 series or
                            kernel launch-argument drift against
                            ``SHAPE_CONTRACTS.json``
``checks_claims``           TCR-C001 a file cited in README's port section
                            or PERF.md that does not exist, TCR-C003 a
                            kernel row marked ported whose ``ops/csrc/``
                            source does not exist
==========================  ================================================

CLI: ``python -m text_crdt_rust_tpu_torch.analysis.lint`` (exit 1 with
``path:line``-named findings; ``--changed`` for the incremental mode,
content-hash cached under ``.tcrlint_torch_cache/``; ``--update-pins``
rewrites the pins).  Allowlist: ``LINT_ALLOWLIST.json`` next to this file
— every entry names (check, path, scope) plus a one-line justification,
and a stale entry (matching nothing) is itself a finding (TCR-A001).
"""
from .tcrlint import (  # noqa: F401
    ALLOWLIST_PATH,
    PINS_PATH,
    Finding,
    changed_files,
    load_allowlist,
    run_lint,
)
