"""``ProgramObject.iterate(steps)`` of the climate step (``stencils/climate.py``):
the program's two fused groups, one launch each a step."""

from __future__ import annotations

from .common import Session, interior, member_view, single_domain_fields


def build(cfg, traffic, seed, device, rank=0, world=1) -> Session:
    from repro_torch.stencils import climate

    dom = tuple(int(d) for d in cfg["domain"])
    prog = climate.build_program("cuda", dom, stencils=climate.build_stencils("cuda"))
    fields = single_domain_fields(cfg, seed, device, climate.FIELD_NAMES)
    scalars = dict(cfg["scalars"])
    steps = int(traffic["steps_per_call"])

    def call(exec_info=None):
        prog.iterate(steps, **fields, **scalars)

    return Session(call=call, state=lambda: {"phi": member_view(interior(fields["phi"].data, cfg["halo"]))},
                   steps=steps, free=fields.clear)
