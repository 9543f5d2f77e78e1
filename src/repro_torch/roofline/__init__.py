"""Roofline layer of the port: the H100's published constants (``hw``), the
operation and traffic counter (``flop_cost``, in place of the reference's
HLO parser ``hlo_cost``), the committed benchmarks' schema
(``bench_schema``) and the per-scenario cost model behind
``execution="auto"`` (``scenario_cost``). The reference's ``analysis`` (the
dry run's roofline table) waits for the dry-run slice."""
from . import hw
from .flop_cost import analyze_fn
