"""Faults planted under the timed path, and the check's control, one
function each: ``rehearse.py`` calls the one a run names with the run's
spec, in every rank's process, before the harness builds the entry, so the
fault sits in the program and the harness runs unchanged above it.

``unchanged`` and ``half_members`` patch the paths the program takes on the
CPU; ``altered``, ``altered_absolute`` and ``control`` patch points that
the program passes on the CPU and on the card alike, so that they can be
read at a cell's own size."""

from __future__ import annotations


def _phi_of(vals):
    return vals.get("phi")


def unchanged(spec) -> None:
    """Every step returns its state unchanged."""
    from repro_torch.ensemble import compile as ens
    from repro_torch.program import compile as prog
    from repro_torch.stencils import climate

    prog.CompiledProgram.step = lambda self, vals, scalars: dict(vals)
    ens._CompiledEnsemble._step_members = lambda self, vals, scalars, per_member: dict(vals)
    prog._RankStep.step = lambda self, vals, scalars, timer=None: None
    climate.eager_step = lambda st, f, domain, scalars: None


def _altered(relative: bool) -> None:
    from repro_torch.ensemble import compile as ens
    from repro_torch.program import compile as prog
    from repro_torch.stencils import climate

    def bump(t):
        at = tuple(n // 2 for n in t.shape)
        t[at] += 1e-3 * (1.0 + t[at].abs()) if relative else 1e-3

    step, iterate, rank_step, eager = (prog.CompiledProgram.step, ens._CompiledEnsemble.execute_iterate,
                                       prog._RankStep.step, climate.eager_step)

    def p_step(self, vals, scalars):
        out = step(self, vals, scalars)
        bump(_phi_of(out))
        return out

    def e_iterate(self, *args, **kwargs):
        out = iterate(self, *args, **kwargs)
        bump(_phi_of(out))
        return out

    def r_step(self, vals, scalars, timer=None):
        rank_step(self, vals, scalars, timer)
        bump(vals["phi_new"])

    def g_step(st, f, domain, scalars):
        eager(st, f, domain, scalars)
        bump(f["phi"].data)

    prog.CompiledProgram.step, ens._CompiledEnsemble.execute_iterate = p_step, e_iterate
    prog._RankStep.step, climate.eager_step = r_step, g_step


def altered(spec) -> None:
    """One point of the state is altered by a thousandth of its magnitude
    (at least 1e-3) where a step (an ensemble's call) produces it."""
    _altered(relative=True)


def altered_absolute(spec) -> None:
    """One point of the state is altered by 1e-3 where a step (an
    ensemble's call) produces it, whatever the state's magnitude."""
    _altered(relative=False)


def half_members(spec) -> None:
    """Only the first half of the members is stepped; the rest keep their state."""
    from repro_torch.ensemble import compile as ens
    from repro_torch.program import compile as prog

    def e_step(self, vals, scalars, per_member):
        plain = [obj._run for obj in self.cp.group_objects]
        for m in range(self.members // 2):
            mf = {n: (v[m] if self.pattern.get(n, False) else v) for n, v in vals.items()}
            self.cp._module.run(mf, scalars, plain)
        return {**vals, **{o: vals[b] for o, b in self.cp.outputs.items()}}

    def by_member(self, obj):
        def run(fields, scalars, domain, origins):
            for m in range(self.members // 2):
                member = {b: (v[m] if self.batched.get(b) else v) for b, v in fields.items()}
                obj._run(member, scalars, domain, origins)

        return run

    ens._CompiledEnsemble._step_members = e_step
    prog._RankStep._member_by_member = by_member


def no_exchange(spec) -> None:
    """The halo exchange between ranks is left out."""
    from repro_torch.parallel import halo

    halo.HaloExchange.fill = lambda self, padded, halo_, depth=None, lead=0: None


def control(spec) -> None:
    """The check's control: the plain reference (``bench/reference/climate.py``)
    computed in float32, one precision below the configuration's float64,
    put in the program's place.  Every step of the program, of the
    ensemble, of the eager path and of a rank computes the new ``phi`` from
    ``phi`` and the winds so, and stores it in the program's own field; a
    rank first gathers every rank's block of the member, as its exchange
    would bring the halo, and keeps its own block of the result."""
    import torch

    from bench.drivers.common import interior, level_view
    from bench.reference import climate as ref
    from repro_torch.ensemble import compile as ens
    from repro_torch.program import compile as prog
    from repro_torch.stencils import climate

    h = int(spec["cfg"]["halo"])
    low = torch.float32

    def new_phi(phi, u, v, w, scalars):
        s = {k: float(scalars[k]) for k in ("dt", "dx", "dy", "dz", "alpha")}
        return ref.step(phi.to(low), u.to(low), v.to(low), w.to(low), s)

    def write(f, scalars):
        """``f``: the fields' (K, I, J) or (M, K, I, J) views; a few members
        at a time, so that the control's temporaries stay small beside the
        program's fields."""
        if f["phi"].dim() == 3:
            f["phi_new"].copy_(new_phi(f["phi"], f["u"], f["v"], f["w"], scalars))
            return
        for m in range(0, f["phi"].shape[0], 4):
            sl = slice(m, m + 4)
            u, v, w = (x[sl] if x.dim() == 4 else x for x in (f["u"], f["v"], f["w"]))
            f["phi_new"][sl].copy_(new_phi(f["phi"][sl], u, v, w, scalars))

    def p_step(self, vals, scalars):
        write({n: interior(vals[n], h) for n in ("phi", "u", "v", "w", "phi_new")}, scalars)
        return {**vals, **{o: vals[b] for o, b in self.outputs.items()}}

    def e_iterate(self, n, raw_fields, scalar_values, exec_info=None, report_steps=True):
        scalars = self.cp.runtime_scalars(scalar_values)
        vals = dict(raw_fields)
        for _ in range(int(n)):
            vals = p_step(self.cp, vals, scalars)
        keep = {b for b, batched in self.pattern.items() if batched} | set(self.cp.outputs)
        return {b: vals[b] for b in keep}

    def g_step(st, f, domain, scalars):
        write({n: interior(f[n].data, h) for n in ("phi", "u", "v", "w", "phi_new")}, scalars)
        f["phi"], f["phi_new"] = f["phi_new"], f["phi"]

    def gather(block, offs, mine, shape):
        import torch.distributed as dist

        got = [torch.empty_like(block) for _ in offs]
        dist.all_gather(got, block.contiguous())
        whole = block.new_zeros(shape)
        for (other, i0, j0), g in zip(offs, got):
            if other == mine:
                whole[..., i0:i0 + g.shape[-2], j0:j0 + g.shape[-1]] = g
        return whole

    def r_step(self, vals, scalars, timer=None):
        import torch.distributed as dist

        ex = self.exchange
        phi, phi_new = level_view(vals["phi"]), level_view(vals["phi_new"])
        li, lj = phi.shape[-2], phi.shape[-1]
        mine = tuple(int(ex.mesh.get_local_rank(a)) for a in ex.mesh.mesh_dim_names
                     if a not in (ex.i_axis, ex.j_axis))
        here = (mine, int(ex.mesh.get_local_rank(ex.i_axis)) * li,
                int(ex.mesh.get_local_rank(ex.j_axis)) * lj)
        offs = [None] * dist.get_world_size()
        dist.all_gather_object(offs, here)
        shape = (phi.shape[-3], max(o[1] for o in offs) + li, max(o[2] for o in offs) + lj)
        winds = {n: gather(level_view(vals[n]), offs, mine, shape) for n in ("u", "v", "w")}
        i0, j0 = here[1], here[2]
        for m in range(phi.shape[0]):
            whole = gather(phi[m], offs, mine, shape)
            new = new_phi(whole, winds["u"], winds["v"], winds["w"], scalars)
            phi_new[m].copy_(new[:, i0:i0 + li, j0:j0 + lj])

    prog.CompiledProgram.step, ens._CompiledEnsemble.execute_iterate = p_step, e_iterate
    prog._RankStep.step, climate.eager_step = r_step, g_step
