"""Training loop with checkpoint/restart and a straggler watchdog (the
reference's ``repro/runtime/loop.py``, on one device).

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
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.layers import map_tree
from repro_torch.optim import OptState, adamw_init, adamw_update, clip_by_global_norm, linear_warmup_cosine
from repro_torch.runtime.supervise import StragglerWatchdog, WatchdogStats  # noqa: F401 — re-exported

log = logging.getLogger("repro_torch.runtime")


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
) -> Callable:
    """(state, batch) → (state, metrics), the state updated in place.

    ``microbatches`` > 1 accumulates gradients: the global batch is split on
    its leading axis (which must divide; else ValueError), the microbatches' gradients are summed in float32 and
    divided by their number, and the optimizer runs once, bounding live
    activation memory at large (batch × seq) without touching the model.
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
        # float32 leaves sum their gradients in .grad; others in float32 here
        acc: Dict[int, torch.Tensor] = {}
        msum: Dict[str, torch.Tensor] = {}
        for i in range(n):
            mb = batch if n == 1 else {k: v[i * mb_size:(i + 1) * mb_size] for k, v in batch.items()}
            loss, metrics = model.loss(params, mb, remat=remat)
            loss.backward()
            for k, v in metrics.items():
                v = v.detach().float() if n > 1 else v.detach()
                msum[k] = v if k not in msum else msum[k] + v
            if n > 1:
                for j, p in enumerate(leaves):
                    if p.grad is not None and p.dtype != torch.float32:
                        acc[j] = p.grad.float() if j not in acc else acc[j].add_(p.grad)
                        p.grad = None
        grads = []
        for j, p in enumerate(leaves):
            g = acc.get(j, p.grad)
            if g is None:  # a leaf the loss does not reach
                g = torch.zeros(p.shape, dtype=torch.float32 if n > 1 else p.dtype, device=p.device)
            grads.append(g.div_(n) if n > 1 else g)
        metrics = {k: v / n for k, v in msum.items()} if n > 1 else msum

        step = int(state.step)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = linear_warmup_cosine(step, base_lr, warmup_steps, total_steps)
        params, opt = adamw_update(params, grads, state.opt, lr, weight_decay=weight_decay)
        for p in leaves:
            p.grad = None
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return TrainState(step=state.step + 1, params=params, opt=opt), metrics

    return train_step


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
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

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
    ):
        self.model = model
        self.dataset = dataset
        self.ckpt = CheckpointManager(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.rng_seed = rng_seed
        self.device = torch.device(device)
        self.watchdog = watchdog or StragglerWatchdog()
        self._step = train_step or make_train_step(model)
        self.metrics_history: list[Dict[str, float]] = []

    def _init_state(self) -> TrainState:
        return init_train_state(self.model, torch.Generator().manual_seed(self.rng_seed), device=self.device)

    def restore_or_init(self) -> TrainState:
        """The newest committed checkpoint (after any save in flight), or a
        fresh state; the restore template holds no weights."""
        self.ckpt.wait()
        step, state = self.ckpt.restore_or_init(abstract_train_state(self.model), self._init_state, self.device)
        if step:
            log.info("restored checkpoint at step %d", step)
        return state

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in self.dataset.batch_at(step).items()}

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
        start = int(state.step)
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
