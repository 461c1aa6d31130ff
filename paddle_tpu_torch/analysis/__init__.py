"""Static analysis over ProgramDesc-level IR: a pass-based verifier, the
safety gates built on it, the cost model, the memory planner and the
rewrite pipeline — the port's copy of ``paddle_tpu/analysis``, with its
``__all__``.

    report = analysis.verify_program(main, startup=startup,
                                     feed_names=["x"],
                                     fetch_names=[loss.name])
    print(report.render_text())
    report.raise_if_errors()

See ``analysis.verifier`` for gate wiring (executor / generation
serving / trainer / io) and ``analysis.passes`` for the individual
checks.
"""
from .diagnostics import (Diagnostic, Severity, VerificationError,  # noqa
                          VerifyReport)
from .passes import (AnalysisPass, PASS_REGISTRY, PassContext,  # noqa
                     default_passes, register_pass)
from .verifier import (ProgramVerifier, clear_gate_cache,  # noqa
                       executor_gate, verify_enabled, verify_program)
from .cost_model import (CostModelPass, OpCost, ProgramCost,  # noqa
                         program_cost)
from .memory import (MemoryPass, MemoryReport, VarInterval,  # noqa
                     check_budget, hbm_budget_bytes, program_memory)
from .rewrite import (RewritePass, RewriteResult,  # noqa
                      REWRITE_PASS_REGISTRY, default_rewrite_passes,
                      optimize_enabled, rewrite_program)

__all__ = [
    "Diagnostic", "Severity", "VerificationError", "VerifyReport",
    "AnalysisPass", "PASS_REGISTRY", "PassContext", "default_passes",
    "register_pass", "ProgramVerifier", "verify_program",
    "verify_enabled", "executor_gate", "clear_gate_cache",
    "CostModelPass", "OpCost", "ProgramCost", "program_cost",
    "MemoryPass", "MemoryReport", "VarInterval", "check_budget",
    "hbm_budget_bytes", "program_memory",
    "RewritePass", "RewriteResult", "REWRITE_PASS_REGISTRY",
    "default_rewrite_passes", "optimize_enabled", "rewrite_program",
]
