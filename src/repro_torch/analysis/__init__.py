"""Invariant lint suite over the port: AST checkers for the repo's
concurrency and wire-protocol conventions, the JAX package's rules
unchanged.

The hand-enforced discipline — stats through ``CounterGroup.inc()``,
untrusted bytes through ``CodecError``/``WALError`` decode boundaries,
heartbeats on every long-lived thread, no blocking calls under locks —
are machine-checked here.  Run as::

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch

Rules (see docs/STATIC_ANALYSIS.md for the full table):

    RA01  lock discipline: guarded attributes only under ``with <lock>:``
    RA02  raw stats mutation: no ``stats[k] += n`` on a CounterGroup
    RA03  codec safety: struct.unpack of wire bytes behind decode boundaries
    RA04  blocking calls (sleep/fsync/queue/socket/Future.result) under locks
    RA05  heartbeat coverage: looping thread targets must beat()/park()
    RA06  wire-table drift: opcodes vs dispatch vs documented table

Stdlib-only by design (``ast`` + ``tokenize``): the lint gate must run in
any environment the tests run in, with zero extra dependencies.
"""

from .engine import (  # noqa: F401
    AnalysisResult,
    Context,
    Finding,
    SourceFile,
    all_checkers,
    format_baseline,
    load_baseline,
    run_analysis,
    selftest,
)
