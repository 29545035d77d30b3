"""Program orchestration: trace multi-stencil steps into one fused program.

The reference package's ``repro.program`` on the port: a
``@program``-decorated step function is traced once (``trace``), its stencil
calls become an inter-stencil dataflow graph (``graph``), program-level
passes eliminate dead stores, demote step-local buffers to stencil
temporaries and plan cross-stencil fusion (``passes``), and the result
compiles to one generated orchestrator over the fused groups, cached under a
graph fingerprint (``compile``).  On the ``cuda`` backend each group is one
generated Hopper kernel::

    from repro_torch.program import program

    @program(backend="cuda")
    def step(phi, u, v, adv, phi_new, *, dt, dx, dy):
        advect(phi, u, v, adv, dx=dx, dy=dy)
        euler(phi, adv, phi_new, dt=dt)
        return {"phi": phi_new, "phi_new": phi}   # double-buffer rotation

    step(phi, u, v, adv, phi_new, dt=..., dx=..., dy=...)   # one launch per group
    step.iterate(100, ...)                                   # 100 steps, host loop

On a device mesh, one process per rank, ``step.distribute(mesh)`` runs the
same groups on each rank's block with the minimal halo exchanges between
them (``halo`` plans them, ``repro_torch.parallel.halo`` runs them).
"""

from .compile import (
    CompiledProgram,
    DistributedProgram,
    ProgramCompileError,
    ProgramObject,
    program,
)
from .trace import ProgramError, ProgramTraceError, request_exchange

__all__ = [
    "program",
    "ProgramObject",
    "CompiledProgram",
    "DistributedProgram",
    "ProgramError",
    "ProgramTraceError",
    "ProgramCompileError",
    "request_exchange",
]
