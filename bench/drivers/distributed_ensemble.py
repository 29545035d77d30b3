"""``DistributedEnsemble.iterate(steps)`` on the configuration's
("ens", "data", "model") mesh, one process a rank: each rank holds its
block of the domain (interior only; the program pads it) for its members,
the winds shared by them, and exchanges halos with its neighbours."""

from __future__ import annotations

from .common import Session, inputs_for, level_view


def build(cfg, traffic, seed, device, rank=0, world=1) -> Session:
    import torch

    from repro_torch.core.storage import card_tensor
    from repro_torch.launch.mesh import axis_size, make_mesh
    from repro_torch.stencils import climate

    axes = ("ens", "data", "model")
    mesh = make_mesh(cfg["mesh"], axes, device_type=device.type)
    ni, nj, nk = (int(d) for d in cfg["domain"])
    n_e, n_i, n_j = (axis_size(mesh, a) for a in axes)
    members = int(cfg["members"])
    local_members, li, lj = members // n_e, ni // n_i, nj // n_j
    e, ci, cj = (int(mesh.get_local_rank(a)) for a in axes)
    i0, j0 = ci * li, cj * lj
    local = (li, lj, nk)
    prog = climate.build_program("cuda", local, stencils=climate.build_stencils("cuda"))
    dens = prog.ensemble(members).distribute(mesh, member_axis="ens")

    inputs = inputs_for(cfg, seed, device)
    dtype = getattr(torch, cfg["dtype"])
    shared = set(cfg.get("shared", ()))
    fields = {}
    for n in climate.FIELD_NAMES:
        shape = local if n in shared else (local_members,) + local
        fields[n] = card_tensor(shape, dtype, device, "zeros")
    for n in shared:
        level_view(fields[n]).copy_(getattr(inputs, n)()[:, i0:i0 + li, j0:j0 + lj])
    phi = level_view(fields["phi"])
    for m in range(local_members):
        phi[m].copy_(inputs.phi(e * local_members + m)[:, i0:i0 + li, j0:j0 + lj])
    scalars = dict(cfg["scalars"])
    steps = int(traffic["steps_per_call"])

    def call(exec_info=None):
        out = dens.iterate(steps, fields, scalars, exec_info=exec_info)
        fields["phi"], fields["phi_new"] = out["phi"], out["phi_new"]

    return Session(call=call, state=lambda: {"phi": level_view(fields["phi"])}, steps=steps,
                   free=fields.clear, where={"member": e * local_members, "i": i0, "j": j0})
