"""torch-lint: static contract analysis for the PyTorch port.

The port of ``repro.analysis``.  The port's correctness rests on API
contracts its types cannot express; this package checks them at lint
time with a stdlib-``ast`` dataflow analyzer.  It imports nothing of
``repro``, no ``jax`` and no ``torch``, and never imports the code it
checks, so it runs the same on a host without a GPU and on the card's
machine.

=====================  =================================================
rule                   contract
=====================  =================================================
``unthreaded-pool``    the pool's, store's and KV cache's bookkeeping is
                       functional: bind and thread the returned state,
                       never pass a superseded binding back in
``stale-remap``        ``pool.compact`` returns ``(pool, remap)``: apply
                       the remap to every table captured before it; a
                       view of ``.data``/``.free_stack`` taken before a
                       ``grow`` aliases the old tensors
``id-into-values``     block ids are addresses: never arithmetic or
                       concatenation with values, never written as
                       payload (``write_blocks``, ``cow_write``,
                       ``append``, ``write_at``, ``kvc.write_kv``, ...)
``use-after-consume``  a call that writes its argument in place
                       (``decode_step``, ``kvc.ensure_writable``/
                       ``write_kv``, the engine's prefill, the store's
                       ``append``/``write_at``, ``cow_write``, ``x.op_()``,
                       ``out=``, a ``custom_op``'s literal
                       ``mutates_args``) leaves no old state: neither the
                       consumed name (when the successor went elsewhere)
                       nor an alias bound before the call may be read
                       as one
``build-in-hot-path``  ``torch.compile``, ``torch.jit``, CUDA graphs,
                       ``custom_op``/``Library``, ``cpp_extension.load``
                       and ``ctypes.CDLL`` are built once (module level,
                       ``__init__``, ``functools.cache``, a ``self``
                       cache), never per call
``unchecked-oom``      a function that allocates and then reads payload
                       consults the sticky ``oom`` signal (``oom_flag``,
                       ``strict_oom``, ``_check_oom``, ``free_blocks``,
                       ``check_invariants``)
=====================  =================================================

The contract table (which call threads, consumes, allocates or reads,
and at which argument) is :mod:`repro_torch.analysis.apis`.

Entry points: :func:`repro_torch.analysis.engine.lint_paths` (library)
and ``scripts/torch_lint.py`` (CLI).  Suppress a finding inline with
``# repro-lint: disable=<rule>`` plus a one-line justification: the
reference linter's syntax, so one comment serves both.
"""

from repro_torch.analysis.engine import FileContext, lint_file, lint_paths, lint_source
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import ALL_RULES

__all__ = [
    "ALL_RULES",
    "FileContext",
    "Finding",
    "lint_file",
    "lint_paths",
    "lint_source",
]
