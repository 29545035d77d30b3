"""The program's state against the plain reference, over every member and
the whole domain, twice a run: from the seeded fields over the first call's
steps (kept as ``first``), and from the program's own state before the
window's last call (``before``) over that call's steps (``final``).

The reference is ``bench/reference/<reference>.py``: ``start(inputs,
members)`` gives the seeded state of those members and ``advance(state,
inputs, scalars, steps)`` steps it; both are dicts of (M, K, I, J) tensors
under the names of the session's ``state()``.  The inputs are
``bench/inputs/<inputs>.py``'s ``Inputs``.

Each comparison reads the largest gap over a level plane of a member as a
share of the reference's largest magnitude on that plane, the largest over
the planes (infinite where the program's state is not finite): the state
can grow by orders of magnitude over a window, and by more on some levels
than on others, so each plane is held at its own scale.  Across ranks each
member's blocks are gathered onto one rank and compared over the whole
domain.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Tuple

KEPT = ("first", "before", "final")
BLOCK_BYTES = 8e9  # the states of the members that the reference holds at once, at most


def plane_gap(got, want) -> float:
    """The largest over the (member, level) planes of the largest gap on the
    plane over the reference's largest magnitude there."""
    diff = (got - want).abs_().amax(dim=(-2, -1))
    scale = want.abs().amax(dim=(-2, -1)).clamp_min(1e-300)
    r = float((diff / scale).max())
    return r if math.isfinite(r) else math.inf


def compare(spec, kept, record, device, ranks) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    from bench import harness

    cfg = spec["cfg"]
    inputs = harness.module("inputs", cfg["inputs"]).Inputs(cfg["domain"], spec["seed"], device)
    ref = harness.module("reference", cfg["reference"])
    steps = int(record["steps_per_call"])
    members = int(cfg.get("members", 1))
    gap = {"start": 0.0, "last": 0.0}
    finite, largest = True, {}
    for ms, st in _member_blocks(kept, members, cfg["domain"], ranks.world, record["where"]):
        if not ms:
            continue
        pairs = (("start", ref.start(inputs, ms), st["first"]), ("last", st["before"], st["final"]))
        for key, start, got in pairs:
            want = ref.advance(start, inputs, cfg["scalars"], steps)
            for name, w in want.items():
                gap[key] = max(gap[key], plane_gap(got[name], w))
            del want
        for name, t in st["final"].items():
            finite = finite and bool(t.isfinite().all())
            largest[name] = max(largest.get(name, 0.0), float(t.abs().max()))
    checks = {f"{key}_gap": {"value": ranks.max(gap[key]), "limit": spec["limits"][f"{key}_gap"]}
              for key in ("start", "last")}
    state = {f"{name}_max": ranks.max(v if finite else math.inf) for name, v in sorted(largest.items())}
    return checks, state


def _member_blocks(kept, members: int, domain, world: int,
                   where) -> Iterator[Tuple[List[int], Dict[str, Any]]]:
    """(member indices, and the kept states of those members over the whole
    domain) for this rank to check: on one rank, blocks of members that the
    reference holds at once; across ranks, one member at a time, its blocks
    gathered from every rank onto rank ``m % world`` (the others get no
    members)."""
    import torch

    ni, nj, nk = (int(d) for d in domain)
    names = list(kept["first"])
    if world == 1:
        size = next(iter(kept["first"].values())).element_size()
        per = max(1, int(BLOCK_BYTES // (16 * len(names) * nk * ni * nj * size)))
        for m0 in range(0, members, per):
            sl = slice(m0, min(members, m0 + per))
            yield list(range(sl.start, sl.stop)), {k: {n: kept[k][n][sl] for n in names} for k in KEPT}
        return
    import torch.distributed as dist

    rank = dist.get_rank()
    offs: List[Any] = [None] * world
    dist.all_gather_object(offs, (int(where["member"]), int(where["i"]), int(where["j"])))
    for m in range(members):
        owner = m % world
        out: Dict[str, Dict[str, Any]] = {k: {} for k in KEPT}
        for k in KEPT:
            for n in names:
                t = kept[k][n]
                local, li, lj = t.shape[0], t.shape[-2], t.shape[-1]
                mine = m - int(where["member"])
                blk = (t[mine] if 0 <= mine < local else t.new_zeros(t.shape[1:])).contiguous()
                got = [torch.empty_like(blk) for _ in range(world)]
                dist.all_gather(got, blk)
                if rank == owner:
                    whole = t.new_zeros((1, nk, ni, nj))
                    for (o, a, b), g in zip(offs, got):
                        if 0 <= m - o < local:
                            whole[0, :, a:a + li, b:b + lj] = g
                    out[k][n] = whole
                del got
        yield ([m], out) if rank == owner else ([], out)
