"""Training loop with checkpoint/restart and a straggler watchdog (the
reference's ``repro/runtime/loop.py``).

* **Process loss**: every state change passes through :class:`TrainState`;
  checkpoints are atomic (COMMIT marker), and the data pipeline is a pure
  function of the step, so a crash and restart resumes bit for bit (given
  deterministic kernels: on the card ``torch.use_deterministic_algorithms``).
* **Stragglers**: a rolling-median step-time watchdog flags slow steps.
  Checkpoint writes are async, so slow storage never stalls the step loop.
* **Fault injection**: ``Trainer.run(fault_hook=...)`` lets tests kill steps
  deterministically and assert recovery.

Where the reference's step is a pure jitted function, the port's updates the
state in place: the parameters take their gradients by ``backward()`` (summed
over microbatches in float32) and AdamW writes them and its moments under
``torch.no_grad()``.  A full-width step has no room for a second copy of
them.

Under a mesh (``parallel.sharding.axis_rules(rules, mesh)``) the state is
DTensors placed by ``launch.specs.state_shardings`` and the batch is placed by
``batch_shardings``; the step runs the same model code through DTensor's
propagation, one process per rank.  Each gradient is reduced to its leaf's
placement before the clip: the data-parallel sum is a plain all-reduce over
the data axes, or ``runtime.compression.dp_allreduce_compressed`` with
``compress_dp``.  The global norm of DTensors counts each replicated leaf
once, and AdamW runs in place on the local shards.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.layers import map_tree
from repro_torch.parallel.sharding import is_dtensor, spmd_scope, to_full
from repro_torch.optim.adamw import moment_dtype
from repro_torch.optim.schedule import host_step
from repro_torch.optim import OptState, adamw_init, adamw_update, clip_by_global_norm, linear_warmup_cosine
from repro_torch.runtime.supervise import StragglerWatchdog, WatchdogStats  # noqa: F401 — re-exported

log = logging.getLogger("repro_torch.runtime")

DATA_AXES = ("pod", "data")  # the mesh axes a batch is split over


class TrainState(NamedTuple):
    step: torch.Tensor  # () int32
    params: Any  # a trainable ParamTree
    opt: OptState


def make_train_step(
    model,
    *,
    base_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    max_grad_norm: float = 1.0,
    weight_decay: float = 0.1,
    remat: bool = True,
    microbatches: int = 1,
    compress_dp: bool = False,
) -> Callable:
    """(state, batch) → (state, metrics), the state updated in place.

    ``microbatches`` > 1 accumulates gradients: the global batch is split on
    its leading axis (which must divide; else ValueError), the microbatches' gradients are summed in float32
    (float64 for float64 leaves) and
    divided by their number, and the optimizer runs once, bounding live
    activation memory at large (batch × seq) without touching the model.
    On DTensors a microbatch is the same global rows, placed as the batch was.
    ``compress_dp``: sum the data-parallel gradients with int8 payloads.
    """

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        leaves = [p for _path, p in params.leaves()]
        for p in leaves:
            p.grad = None
        n = max(microbatches, 1)
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split into {n} microbatches")
        mb_size = rows // n
        # float32 and float64 leaves sum their gradients in .grad; others in float32 here
        acc: Dict[int, torch.Tensor] = {}
        msum: Dict[str, torch.Tensor] = {}
        for i in range(n):
            mb = batch if n == 1 else {k: _rows(v, i * mb_size, mb_size) for k, v in batch.items()}
            loss, metrics = model.loss(params, mb, remat=remat)
            with spmd_scope():
                loss.backward()
            for k, v in metrics.items():
                v = v.detach().to(torch.promote_types(v.dtype, torch.float32)) if n > 1 else v.detach()
                msum[k] = v if k not in msum else msum[k] + v
            if n > 1:
                for j, p in enumerate(leaves):
                    if p.grad is not None and p.dtype not in (torch.float32, torch.float64):
                        acc[j] = p.grad.float() if j not in acc else acc[j].add_(p.grad)
                        p.grad = None
        grads = []
        for j, p in enumerate(leaves):
            g = acc.get(j, p.grad)
            if g is None:  # a leaf the loss does not reach
                g = torch.zeros_like(p, dtype=moment_dtype(p.dtype) if n > 1 else p.dtype, requires_grad=False)
            g = _reduce_to_placement(g, p, compress_dp)
            grads.append(g.div_(n) if n > 1 else g)
        metrics = {k: to_full(v / n if n > 1 else v) for k, v in msum.items()}

        step = host_step(state.step)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = linear_warmup_cosine(step, base_lr, warmup_steps, total_steps)
        params, opt = adamw_update(params, grads, state.opt, lr, weight_decay=weight_decay)
        for p in leaves:
            p.grad = None
        metrics["grad_norm"] = to_full(gnorm)
        metrics["lr"] = lr
        return TrainState(step=state.step + 1, params=params, opt=opt), metrics

    return train_step


def _rows(v: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """Rows ``start .. start + count`` of a batch leaf; a DTensor's are the
    same global rows, placed as the leaf is (the batch is small: gathered)."""
    if not is_dtensor(v):
        return v[start:start + count]
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(v.full_tensor()[start:start + count], v.device_mesh, v.placements,
                             src_data_rank=None)


def _reduce_to_placement(g: torch.Tensor, p: torch.Tensor, compress: bool) -> torch.Tensor:
    """A DTensor gradient reduced to its parameter's placements (its partial
    sums over the data axes summed by int8 payloads when ``compress``)."""
    if not is_dtensor(g):
        return g
    mesh = g.device_mesh
    if not compress:
        return g.redistribute(mesh, p.placements)
    from torch.distributed.tensor import DTensor

    from repro_torch.runtime.compression import dp_allreduce_compressed

    data = [i for i, a in enumerate(mesh.mesh_dim_names) if a in DATA_AXES and g.placements[i].is_partial()]
    keep = [gp if i in data else pp for i, (gp, pp) in enumerate(zip(g.placements, p.placements))]
    local = g.redistribute(mesh, keep).to_local()
    for i in data:  # the mean over the group's ranks, times their number: the sum
        local = dp_allreduce_compressed(local, group=mesh.get_group(i)) * mesh.size(i)
    return DTensor.from_local(local, mesh, p.placements, run_check=False)


def init_train_state(model, generator: Optional[torch.Generator] = None, device="cuda") -> TrainState:
    """Fresh trainable weights from ``generator``'s seed (``LM.init_params``)
    and zero moments, on ``device``."""
    params = model.init_params(generator, device=device).trainable_()
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=device), params=params,
                      opt=adamw_init(params))


def abstract_train_state(model) -> TrainState:
    """The state ``init_train_state`` makes, as meta tensors (shapes and
    dtypes, nothing drawn): a checkpoint's restore template."""
    params = model.abstract_params().trainable_()

    def moment(_path, p):
        return torch.empty(p.shape, dtype=moment_dtype(p.dtype), device="meta")

    step = torch.empty((), dtype=torch.int32, device="meta")
    tree = params.to_tree()
    return TrainState(step=step, params=params,
                      opt=OptState(step=step, m=map_tree(moment, tree), v=map_tree(moment, tree)))


class Trainer:
    """Restartable trainer: ``run(n_steps)`` survives injected faults by
    restoring the last committed checkpoint and replaying the (deterministic)
    data stream.  The state and every batch live on ``device``."""

    def __init__(
        self,
        model,
        dataset,
        ckpt_dir: str,
        *,
        train_step: Optional[Callable] = None,
        ckpt_every: int = 50,
        rng_seed: int = 0,
        watchdog: Optional[StragglerWatchdog] = None,
        device="cuda",
        shardings: Any = None,
    ):
        self.model = model
        self.dataset = dataset
        self.ckpt = CheckpointManager(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.rng_seed = rng_seed
        self.device = torch.device(device)
        self.watchdog = watchdog or StragglerWatchdog()
        self._step = train_step or make_train_step(model)
        # ``launch.specs.state_shardings``: the state as DTensors on their
        # mesh, each rank one process (run the step under ``axis_rules``)
        self.shardings = shardings
        self.metrics_history: list[Dict[str, float]] = []

    def _init_state(self) -> TrainState:
        gen = torch.Generator().manual_seed(self.rng_seed)
        if self.shardings is None:
            return init_train_state(self.model, gen, device=self.device)
        from repro_torch.launch.specs import init_sharded_state

        return init_sharded_state(self.model, self.shardings, gen, self.device)

    def restore_or_init(self) -> TrainState:
        """The newest committed checkpoint (after any save in flight), or a
        fresh state; the restore template holds no weights.  With
        ``shardings`` the state is placed by them, whatever mesh wrote it."""
        self.ckpt.wait()
        step, state = self.ckpt.restore_or_init(abstract_train_state(self.model), self._init_state, self.device,
                                                shardings=self.shardings)
        if step:
            log.info("restored checkpoint at step %d", step)
        return state

    @staticmethod
    def start_step(state: TrainState) -> int:
        """The step a (restored) state resumes at."""
        return host_step(state.step)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in self.dataset.batch_at(step).items()}
        if self.shardings is None:
            return batch
        from repro_torch.launch.specs import batch_shardings, distribute_tree

        return distribute_tree(batch, batch_shardings(self.shardings.step.mesh, batch))

    def run(
        self,
        n_steps: int,
        *,
        fault_hook: Optional[Callable[[int], None]] = None,
        max_restarts: int = 3,
    ) -> TrainState:
        restarts = 0
        while True:
            try:
                state = self.restore_or_init()
                state = self._run_from(state, n_steps, fault_hook)
                self.ckpt.wait()
                return state
            except _InjectedFault:
                restarts += 1
                if restarts > max_restarts:
                    raise
                log.warning("fault at restart #%d — restoring and continuing", restarts)
                continue

    def _run_from(self, state: TrainState, n_steps: int, fault_hook) -> TrainState:
        start = self.start_step(state)
        for step in range(start, n_steps):
            if fault_hook is not None:
                fault_hook(step)  # may raise _InjectedFault
            batch = self.batch_at(step)
            t0 = time.perf_counter()
            state, metrics = self._step(state, batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.watchdog.record(step, time.perf_counter() - t0)
            self.metrics_history.append({k: float(v) for k, v in metrics.items()})
            if (step + 1) % self.ckpt_every == 0 or step + 1 == n_steps:
                self.ckpt.save_async(step + 1, state)
        return state


class _InjectedFault(RuntimeError):
    """Raised by test fault hooks to simulate a node failure."""


def injected_fault() -> RuntimeError:
    return _InjectedFault("injected fault")
