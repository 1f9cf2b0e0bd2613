"""Three-layer static-analysis gate of the port (AST lint / op-trace lint /
collective budgets): the counterpart of ``repro/analysis``.

The paper's bucketing guarantee only holds if the implementation runs the
prescribed aggregation, and the failures are silent: a kernel route that
quietly takes plain PyTorch, or a replicated fp32 ``[n_pad]`` egress that
multiplies a rank's traffic with every test green. This package turns
those invariants into a regression gate:

  repro_torch.analysis.ast_lint         Python AST rules over ``src/repro_torch``
  repro_torch.analysis.op_trace         rules over the ATen ops a target
                                        dispatches (the reference's jaxpr layer)
  repro_torch.analysis.collective_lint  collective count / byte budgets over
                                        each rank's ``torch.distributed`` calls
                                        (the reference's HLO layer)
  repro_torch.analysis.targets          the calls the gate inspects, on 8 gloo
                                        ranks laid out as the (4, 2) mesh
  repro_torch.analysis.cli              ``python -m repro_torch.analysis``

Importing this package runs nothing and changes no process state.
"""

from repro_torch.analysis.findings import ERROR, WARNING, Finding, Report

__all__ = ["ERROR", "WARNING", "Finding", "Report"]
