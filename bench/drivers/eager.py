"""The eager climate step: the five ``StencilObject`` calls a step
(``stencils/climate.py::eager_step``, argument validation at its default),
``phi`` and ``phi_new`` rotated; ``steps`` steps a call."""

from __future__ import annotations

from .common import Session, interior, member_view, single_domain_fields


def build(cfg, traffic, seed, device, rank=0, world=1) -> Session:
    from repro_torch.stencils import climate

    dom = tuple(int(d) for d in cfg["domain"])
    st = climate.build_stencils("cuda")
    fields = single_domain_fields(cfg, seed, device, climate.FIELD_NAMES)
    scalars = dict(cfg["scalars"])
    steps = int(traffic["steps_per_call"])

    def call(exec_info=None):
        for _ in range(steps):
            climate.eager_step(st, fields, dom, scalars)

    return Session(call=call, state=lambda: {"phi": member_view(interior(fields["phi"].data, cfg["halo"]))},
                   steps=steps, free=fields.clear)
