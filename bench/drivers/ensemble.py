"""``Ensemble(climate_step, members).iterate(steps)``: every group one
member-batched launch a step; the configuration's ``shared`` fields (the
winds) are read by every member, the rest hold a member axis."""

from __future__ import annotations

from .common import Session, interior, single_domain_fields


def build(cfg, traffic, seed, device, rank=0, world=1) -> Session:
    from repro_torch.ensemble import Ensemble
    from repro_torch.stencils import climate

    dom = tuple(int(d) for d in cfg["domain"])
    members = int(cfg["members"])
    ens = Ensemble(climate.build_program("cuda", dom, stencils=climate.build_stencils("cuda")), members)
    fields = single_domain_fields(cfg, seed, device, climate.FIELD_NAMES, members=members,
                                  shared=tuple(cfg.get("shared", ())))
    scalars = dict(cfg["scalars"])
    steps = int(traffic["steps_per_call"])

    def call(exec_info=None):
        ens.iterate(steps, **fields, **scalars)

    return Session(call=call, state=lambda: {"phi": interior(fields["phi"].data, cfg["halo"])},
                   steps=steps, free=fields.clear)
