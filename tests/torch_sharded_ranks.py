"""The rank programs of the port's sharded-model tests.

``tests/test_torch_sharded.py`` runs these on CPU ranks of one gloo process
group (``repro_torch.launch.ranks.run_ranks``), once per group size.  Every
rank draws the same reduced model from a seed, runs the single-process port
on it for the reference, runs the sharded step, prefill or decode over a
mesh of DTensors (``parallel.sharding.axis_rules``), gathers the results and
returns the deviations for the tests to check.  This module imports neither
JAX nor the reference package: it is what every spawned rank imports.
"""

import logging
import warnings
from dataclasses import replace

import numpy as np
import torch

from repro_torch.checkpoint.store import load_checkpoint, save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import (
    batch_shardings,
    cache_shardings,
    distribute_tree,
    gather_tree,
    param_shardings,
    serve_batch_shardings,
    spec_of,
    state_shardings,
)
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import ParamTree, map_tree, tree_leaves
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules, is_dtensor, spmd_scope, to_full
from repro_torch.runtime.loop import (
    TrainState,
    _reduce_to_placement,
    abstract_train_state,
    init_train_state,
    make_train_step,
)

TRAIN_ARCHS = ("phi3-mini-3.8b", "recurrentgemma-2b", "moonshot-v1-16b-a3b")
OTHER_ARCHS = ("mamba2-370m", "whisper-medium", "internvl2-1b")  # ssm, enc-dec, vlm
MESHES = ((2, 2), (1, 4))
AXES = ("data", "model")
B, S = 4, 16
STEPS = 2
DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}


def _quiet() -> None:
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    warnings.filterwarnings("ignore")


def config(arch: str, dtype: str):
    return replace(get_arch(arch).reduced, dtype=dtype, param_dtype=dtype)


def batch_of(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}


def fresh_state(model):
    """``init_train_state`` from seed 0 on the CPU; a float64 model holds every
    leaf in float64 (its norm scales and gate vectors too), so that the whole
    step is float64."""
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    if model.cfg.dtype != "float64":
        return state
    params = ParamTree(map_tree(lambda _p, t: t.double(), state.params.to_tree())).trainable_()
    return TrainState(step=state.step, params=params, opt=adamw_init(params))


def _train(model, state, mesh, microbatches=1):
    """``STEPS`` steps at the default peak lr (3e-4, warmed up in one step).
    Returns (state, losses, the first moments after the first step, whole):
    ``(1 - b1)`` times the clipped, reduced gradients, which AdamW's
    normalised update has not yet magnified."""
    step = make_train_step(model, base_lr=3e-4, warmup_steps=1, total_steps=10, microbatches=microbatches)
    losses, m1 = [], None
    for i in range(STEPS):
        b = batch_of(model.cfg, 10 + i)
        if mesh is not None:
            b = distribute_tree(b, batch_shardings(mesh, b))
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if i == 0:
            m1 = map_tree(lambda _p, t: to_full(t).detach().clone(), state.opt.m)
    return state, losses, m1


def _dropping_data_rank_1(reduce):
    """``_reduce_to_placement`` with data rank 1's partial gradients zeroed:
    the fault a moment gate must catch (one data rank's gradient dropped)."""
    from torch.distributed.tensor import DTensor

    def dropped(g, p, compress):
        if is_dtensor(g):
            mesh = g.device_mesh
            i = mesh.mesh_dim_names.index("data")
            if g.placements[i].is_partial() and mesh.get_local_rank(i) == 1:
                g = DTensor.from_local(torch.zeros_like(g.to_local()), mesh, g.placements, run_check=False)
        return reduce(g, p, compress)

    return dropped


def _moment_gap(got, ref) -> tuple:
    """The largest over the moment leaves (m and v) of ||got - ref|| / ||ref||,
    and that leaf's path."""
    worst = (0.0, "")
    for name, tree_got, tree_ref in (("m", got.opt.m, ref.opt.m), ("v", got.opt.v, ref.opt.v)):
        for (path, a), (_q, r) in zip(tree_leaves(tree_got), tree_leaves(tree_ref)):
            a64, r64 = a.detach().double(), r.detach().double()
            den = float(r64.norm())
            worst = max(worst, (float((a64 - r64).norm()) / den if den > 0 else float(a64.norm()), f"{name}/{path}"))
    return worst


def _deviation(got, ref) -> dict:
    """Per dtype, the largest |got - ref| of a leaf over that leaf's largest
    |ref| (absolute where the leaf is zero), and the leaf's path."""
    out: dict = {}
    for (path, a), (_p, r) in zip(tree_leaves(got), tree_leaves(ref)):
        key = str(r.dtype).replace("torch.", "")
        a64, r64 = a.detach().double(), r.detach().double()
        scale, err = float(r64.abs().max()), float((a64 - r64).abs().max())
        rel = err / scale if scale > 0 else err
        if rel >= out.get(key, (0.0, ""))[0]:
            out[key] = (rel, path)
    return out


def four_rank_cases(rank: int, world: int, ckpt_dir: str, carried: dict) -> dict:
    """Everything the 4-rank tests check, in one spawn."""
    return {**train_cases(rank, world, ckpt_dir), **serve_cases(rank, world), **family_cases(rank, world),
            **carried_case(rank, world, carried)}


def carried_case(rank: int, world: int, tree: dict) -> dict:
    """Weights carried from the reference (``models.convert``), placed over
    (2, 2) by ``distribute_tree``: the reduced phi3-mini's logits."""
    from repro_torch.models.convert import params_from_reference

    _quiet()
    model = build_model(get_arch(TRAIN_ARCHS[0]).reduced)
    params = params_from_reference(tree, device="cpu")
    mesh = make_mesh((2, 2), AXES, "cpu")
    with axis_rules(DEFAULT_RULES, mesh):
        dparams = distribute_tree(params, param_shardings(model, mesh))
        b = batch_of(model.cfg, 9)
        logits, _ = model.forward(dparams, {"tokens": distribute_tree(b, batch_shardings(mesh, b))["tokens"]},
                                  remat=False)
        return {"carried_logits": logits.full_tensor().numpy(), "carried_tokens": b["tokens"].numpy()}


def train_cases(rank: int, world: int, ckpt_dir: str) -> dict:
    """The sharded train step of every ``TRAIN_ARCHS`` config on every mesh
    of ``MESHES``, in float64 and float32 (phi3-mini also with two
    microbatches), against the single-process step; the checkpoint of the
    (2, 2) run restored on (1, 4) and on one process; the compressed
    data-parallel reduction against the exact one; and the moment gap of
    path K2's configuration (bf16 compute, float32 master weights, two
    microbatches) on (2, 2), sound and with data rank 1's gradient dropped."""
    _quiet()
    out: dict = {}
    cases = [(arch, dtype, shape, 1) for dtype in ("float64", "float32") for arch in TRAIN_ARCHS for shape in MESHES]
    cases += [(TRAIN_ARCHS[0], "float64", (2, 2), 2)]
    refs: dict = {}
    for arch, dtype, shape, n_mb in cases:
        model = build_model(config(arch, dtype))
        if (arch, dtype, n_mb) not in refs:
            refs[arch, dtype, n_mb] = _train(model, fresh_state(model), None, n_mb)
        ref, ref_losses, ref_m1 = refs[arch, dtype, n_mb]
        mesh = make_mesh(shape, AXES, "cpu")
        with axis_rules(DEFAULT_RULES, mesh):
            state = distribute_tree(fresh_state(model), state_shardings(model, mesh))
            state, losses, m1 = _train(model, state, mesh, n_mb)
            full = gather_tree(state)
        out[f"train/{arch}/{dtype}/{shape[0]}x{shape[1]}/mb{n_mb}"] = {
            "dev": _deviation(full, ref), "grad": _deviation(m1, ref_m1)[dtype][0],
            "loss": max(abs(a - b) for a, b in zip(losses, ref_losses))}
        if (arch, dtype, shape, n_mb) == cases[0]:
            out["ckpt"] = _checkpoint(model, state, full, rank, ckpt_dir)
            out["compress"] = _compressed(model, mesh)
    out["moment_gap"] = _k2_moment_gaps()
    return out


def _k2_moment_gaps() -> dict:
    """Path K2's configuration at reduced width: recurrentgemma in bf16
    compute with float32 master weights, 2 microbatches, ``STEPS`` steps on
    (2, 2), its moment gap from the single process; and the same with data
    rank 1's gradient dropped."""
    from repro_torch.runtime import loop

    model = build_model(replace(get_arch("recurrentgemma-2b").reduced, dtype="bfloat16", param_dtype="float32"))
    ref = _train(model, fresh_state(model), None, 2)[0]
    mesh = make_mesh((2, 2), AXES, "cpu")
    out = {}
    reduce = loop._reduce_to_placement
    for name, fn in (("sound", reduce), ("dropped", _dropping_data_rank_1(reduce))):
        loop._reduce_to_placement = fn
        try:
            with axis_rules(DEFAULT_RULES, mesh):
                state = _train(model, distribute_tree(fresh_state(model), state_shardings(model, mesh)), mesh, 2)[0]
                out[name] = _moment_gap(gather_tree(state), ref)
        finally:
            loop._reduce_to_placement = reduce
    return out


def _checkpoint(model, state, full, rank: int, ckpt_dir: str) -> dict:
    """Save the (2, 2) state; restore on (1, 4) and, on rank 0, alone."""
    save_checkpoint(ckpt_dir, STEPS, state)
    mesh14 = make_mesh((1, 4), AXES, "cpu")
    # the state's own dtypes (a float64 model's are all float64), nothing held
    template = TrainState(step=abstract_train_state(model).step,
                          params=ParamTree(map_tree(_meta, full.params.to_tree())).trainable_(),
                          opt=type(full.opt)(*(map_tree(_meta, t) for t in full.opt)))
    step, restored = load_checkpoint(ckpt_dir, template, device="cpu", shardings=state_shardings(model, mesh14))
    placed = [tuple(p.placements) for _path, p in tree_leaves(restored) if hasattr(p, "placements")]
    got = gather_tree(restored)
    res = {"step": step, "mesh14_bits": _same_bits(got, full), "placed": len(placed),
           "leaves": len(tree_leaves(full))}
    if rank == 0:
        _s, alone = load_checkpoint(ckpt_dir, template, device="cpu")
        res["alone_bits"] = _same_bits(alone, full)
    return res


def _meta(_path, t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _same_bits(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x.detach(), y.detach())
               for (_p, x), (_q, y) in zip(tree_leaves(a), tree_leaves(b)))


def _compressed(model, mesh) -> float:
    """Largest deviation of a leaf's int8-compressed data-parallel gradient
    from the exact one, over the leaf's largest."""
    with axis_rules(DEFAULT_RULES, mesh):
        state = distribute_tree(fresh_state(model),
                                state_shardings(model, mesh))
        b = batch_of(model.cfg, 3)
        loss, _ = model.loss(state.params, distribute_tree(b, batch_shardings(mesh, b)), remat=False)
        with spmd_scope():
            loss.backward()
        worst = 0.0
        for _path, p in state.params.leaves():
            exact = _reduce_to_placement(p.grad, p, False).full_tensor()
            comp = _reduce_to_placement(p.grad, p, True).full_tensor()
            scale = float(exact.abs().max())
            if scale > 0:
                worst = max(worst, float((comp - exact).abs().max()) / scale)
    return worst


def serve_cases(rank: int, world: int) -> dict:
    """Prefill and two greedy decode steps of every config of ``TRAIN_ARCHS``
    and ``OTHER_ARCHS`` (float64) over (2, 2) against the single-process run."""
    _quiet()
    out = {}
    mesh = make_mesh((2, 2), AXES, "cpu")
    for arch in TRAIN_ARCHS + OTHER_ARCHS:
        model = build_model(config(arch, "float64"))
        params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
        prompt = {"tokens": batch_of(model.cfg, 7)["tokens"], **_frontend_inputs(model.cfg)}
        ref, toks = _serve(model, params, prompt, None, None)
        with axis_rules(DEFAULT_RULES, mesh):
            got, _ = _serve(model, distribute_tree(params, param_shardings(model, mesh)), prompt, mesh, toks)
        out[arch] = max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))
    return out


def _frontend_inputs(cfg) -> dict:
    """An enc-dec model's frames or a vlm's patches, (B, encoder_seq,
    d_model) from a seed; nothing for the other families."""
    if not (cfg.is_encdec or cfg.frontend == "vision"):
        return {}
    g = torch.Generator().manual_seed(6)
    x = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=g, dtype=torch.float64).to(DTYPES[cfg.dtype])
    return {"frames" if cfg.is_encdec else "patches": x}


def _serve(model, params, prompt, mesh, forced):
    """Prefill and two greedy decode steps (an enc-dec model's frames with
    every step; a vlm's patches ahead of the prompt's tokens)."""
    def place(b):
        return b if mesh is None else distribute_tree(b, serve_batch_shardings(mesh, b))

    extra = {k: v for k, v in prompt.items() if k == "frames"}
    cache = model.make_cache(B, S + 4 + (model.cfg.encoder_seq if "patches" in prompt else 0), device="cpu")
    if mesh is not None:
        cache = distribute_tree(cache, cache_shardings(mesh, cache))
    logits, cache = model.prefill(params, place(prompt), cache)
    outs, toks = [logits], []
    for i in range(2):
        tok = forced[i] if forced is not None else outs[-1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(tok)
        logits, cache = model.decode_step(params, place({"tokens": tok, **extra}), cache)
        outs.append(logits)
    return [o.full_tensor() if mesh is not None else o for o in outs], toks


def moe_cases(rank: int, world: int, x: np.ndarray, expert_idx: np.ndarray, gate_vals: np.ndarray,
              capacity: int) -> dict:
    """Expert-parallel MoE on (2, 4): the dispatch of given routing against
    the local path, and ``moe_layer`` against the single-device port."""
    _quiet()
    cfg = config("moonshot-v1-16b-a3b", "float64")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")["decoder"]["blocks"][0]["moe"]
    mesh = make_mesh((2, 4), AXES, "cpu")
    xt, it, gt = torch.from_numpy(x), torch.from_numpy(expert_idx), torch.from_numpy(gate_vals)
    e = cfg.moe.n_experts
    local = moe_mod._dispatch_combine(params, xt, it, gt, capacity, e, cfg.activation)
    full, _ = moe_mod.moe_layer(params, xt, cfg.moe, cfg.activation)
    with axis_rules(DEFAULT_RULES, mesh):
        specs = model.param_specs()["decoder"]["blocks"][0]["moe"]
        sh = map_tree(lambda _p, s: spec_of(s, mesh), specs)
        dparams = distribute_tree(params, sh)
        rows = {"x": xt, "i": it, "g": gt}
        d = distribute_tree(rows, batch_shardings(mesh, rows))
        with spmd_scope():
            ep = moe_mod._dispatch_ffn_combine(dparams, d["x"], d["i"], d["g"], capacity, e, cfg.activation)
            ep_layer, _ = moe_mod.moe_layer(dparams, d["x"], cfg.moe, cfg.activation)
    return {"dispatch": ep.full_tensor().numpy(), "local": local.numpy(),
            "layer": float((ep_layer.full_tensor() - full).abs().max() / full.abs().max()),
            "wi_local": tuple(dparams["wi"].to_local().shape)}


def staged_cases(rank: int, world: int) -> dict:
    """On the ``gloo_staged`` group (gloo through host buffers, as ranks that
    share a card run): each collective DTensor makes, directly and through
    the functional API, and a hybrid model's sharded prefill and decode."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    from repro_torch.parallel import staged

    staged.install(force=True)  # the host's tensors take the card's path too
    _quiet()
    t = torch.arange(8, dtype=torch.float64) + 10 * rank
    out = {"backend": dist.get_backend()}
    o = torch.empty(8, dtype=torch.float64)
    dist.all_to_all_single(o, t)
    g = torch.empty(32, dtype=torch.float64)
    dist.all_gather_into_tensor(g, t)
    r = torch.empty(2, dtype=torch.float64)
    dist.reduce_scatter_tensor(r, t)
    a = t.clone()
    dist.all_reduce(a)
    m = staged.all_reduce(t.clone(), "max")
    out["direct"] = [o.tolist(), g.tolist(), r.tolist(), a.tolist()]
    out["max"] = m.tolist()
    group = dist.group.WORLD
    def done(x):  # the staged results are plain tensors; gloo's own are AsyncCollectiveTensors
        return (x.wait() if hasattr(x, "wait") else x).tolist()

    out["functional"] = [done(funcol.all_to_all_single(t, None, None, group)),
                         done(funcol.all_gather_tensor(t, 0, group)),
                         done(funcol.reduce_scatter_tensor(t, "sum", 0, group)),
                         done(funcol.all_reduce(t, "sum", group))]
    mesh = make_mesh((2, 2), AXES, "cpu")
    model = build_model(config("recurrentgemma-2b", "float64"))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    prompt = {"tokens": batch_of(model.cfg, 7)["tokens"]}
    ref, toks = _serve(model, params, prompt, None, None)
    with axis_rules(DEFAULT_RULES, mesh):
        got, _ = _serve(model, distribute_tree(params, param_shardings(model, mesh)), prompt, mesh, toks)
    out["serve"] = max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(got, ref))
    return out


def nccl_train_case(rank: int, world: int) -> dict:
    """One card a rank over NCCL: ``TRAIN_ARCHS``' reduced float32 configs,
    one step on (2, 2) against the single-process step on the rank's card:
    the deviation of the first moments after it (the reduced, clipped
    gradients)."""
    _quiet()
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    out = {}
    for arch in TRAIN_ARCHS:
        model = build_model(config(arch, "float32"))
        step = make_train_step(model, base_lr=3e-4, warmup_steps=1, total_steps=10)
        b = {k: v.to(dev) for k, v in batch_of(model.cfg, 10).items()}
        ref, _ = step(init_train_state(model, torch.Generator().manual_seed(0), dev), b)
        mesh = make_mesh((2, 2), AXES)
        with axis_rules(DEFAULT_RULES, mesh):
            state = distribute_tree(init_train_state(model, torch.Generator().manual_seed(0), dev),
                                    state_shardings(model, mesh))
            state, _ = step(state, distribute_tree(b, batch_shardings(mesh, b)))
            m = gather_tree(state.opt.m)
        out[arch] = _deviation(m, ref.opt.m)["float32"][0]
    return out


def family_cases(rank: int, world: int) -> dict:
    """The ssm, enc-dec and vlm families (float64, every leaf float64) on
    (2, 2): the loss and every gradient against the single process."""
    _quiet()
    out = {}
    mesh = make_mesh((2, 2), AXES, "cpu")
    for arch in OTHER_ARCHS:
        model = build_model(config(arch, "float64"))
        state = fresh_state(model)
        b = {**batch_of(model.cfg, 5), **_frontend_inputs(model.cfg)}
        loss, _ = model.loss(state.params, b, remat=False)
        loss.backward()
        ref = {p: t.grad for p, t in state.params.leaves()}
        with axis_rules(DEFAULT_RULES, mesh):
            sh = distribute_tree(fresh_state(model), state_shardings(model, mesh))
            dloss, _ = model.loss(sh.params, distribute_tree(b, batch_shardings(mesh, b)), remat=True)
            with spmd_scope():
                dloss.backward()
            worst = 0.0
            for path, t in sh.params.leaves():
                got, want = t.grad.full_tensor(), ref[path]
                # a key bias's exact gradient is 0 (softmax is shift-invariant): absolute there
                scale = max(float(want.abs().max()), 1e-3)
                worst = max(worst, float((got - want).abs().max()) / scale)
        out[f"family/{arch}"] = {"loss": abs(float(dloss.full_tensor()) - float(loss)), "grad": worst}
    return out
