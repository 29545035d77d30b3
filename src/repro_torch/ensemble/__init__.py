"""Ensemble execution: member-batched programs, perturbations, statistics.

The reference package's ``repro.ensemble`` on the port.  Operational weather
and climate products run *ensembles* — tens of perturbed members whose
spread is the product.  This package advances N members of a ``@program``
together; on the ``cuda`` backend every fused group is one launch for all
members (the generated kernel's member grid axis)::

    from repro_torch import ensemble
    from repro_torch.ensemble import Ensemble

    ens = Ensemble(climate_step, members=21)       # or climate_step.ensemble(21)
    phi0 = ensemble.perturb(phi, 21, seed=0, amplitude=1e-3)   # counter-based
    ens(phi0, u, v, ..., dt=dt)                    # 21 members, one launch a group
    ens.iterate(100, phi0, u, v, ..., dt=dt)       # 100 steps x 21 members
    stats = ens.statistics()                       # fused IR stencil
    stats(phi0, threshold=2.0)                     # mean/var/spread/min/max/prob

Modules: ``batch`` (member-batched storage allocation), ``perturb``
(counter-based member initialization, one generator a member), ``stats``
(fused statistics emitted through the stencil IR), ``compile`` (the
member-batched ensemble compiler).  Members × domain sharding (the
reference's ``DistributedEnsemble``) is not ported yet.
"""

from . import batch
from .batch import (
    EnsembleError,
    broadcast,
    from_member_arrays,
    gather_member,
    is_member_batched,
    member_view,
    scatter_members,
    storage_for_domain,
)
from .compile import Ensemble
from .perturb import member_keys, normal_noise, perturb, spread_inflation, uniform_noise
from .stats import STAT_FIELDS, EnsembleStatistics, build_ensemble_stats, stats_definition

__all__ = [
    "Ensemble",
    "EnsembleError",
    "EnsembleStatistics",
    "STAT_FIELDS",
    "batch",
    "broadcast",
    "build_ensemble_stats",
    "from_member_arrays",
    "gather_member",
    "is_member_batched",
    "member_keys",
    "member_view",
    "normal_noise",
    "perturb",
    "scatter_members",
    "spread_inflation",
    "stats_definition",
    "storage_for_domain",
    "uniform_noise",
]
