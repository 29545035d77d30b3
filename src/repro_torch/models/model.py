"""Model facade: spec / init / forward / loss / prefill / decode.

``build_model(cfg)`` returns an :class:`LM` whose methods are functions of
(params, batch[, cache]), as in the reference package; ``params`` is the
:class:`~repro_torch.models.layers.ParamTree` that ``init_params`` makes (or
``convert.params_from_reference`` carries over from the reference).  The
dense family runs (forward, loss and the serving path ``make_cache →
prefill → decode_step``); the other families raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

from . import frontends, transformer
from .layers import (
    ParamSpec,
    ParamTree,
    embed,
    embedding_spec,
    init_param_tree,
    make_norm,
    map_tree,
    softcap,
    unembed,
)

# the subtrees whose leaves the layers read in float32 (norm scales and
# biases); every other leaf is cast to the activation dtype where it is used
_NORM_KEYS = frozenset({"ln", "ln1", "ln2", "ln_x", "final_norm", "enc_norm"})


@dataclass
class LM:
    cfg: ArchConfig

    # ------------------------------------------------------------------ specs

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        norm_spec, _ = make_norm(cfg.norm)
        spec: Dict[str, Any] = {
            "embed": embedding_spec(cfg.padded_vocab, cfg.d_model),
            "final_norm": norm_spec(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            spec["lm_head"] = {"kernel": ParamSpec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))}
        if cfg.is_encdec:
            spec["frontend"] = frontends.frontend_spec(cfg)
            spec["encoder"] = transformer.encoder_stack_spec(cfg)
            spec["enc_norm"] = norm_spec(cfg.d_model)
            spec["decoder"] = transformer.xdec_stack_spec(cfg)
            spec["dec_pos_embed"] = ParamSpec((8192, cfg.d_model), (None, "embed"), scale=0.01)
        else:
            if cfg.frontend:
                spec["frontend"] = frontends.frontend_spec(cfg)
            spec["decoder"] = transformer.decoder_stack_spec(cfg)
        return spec

    def init_params(self, generator: Optional[torch.Generator] = None, device="cuda") -> ParamTree:
        """Random weights in ``param_dtype`` on ``device``, from the seed of
        ``generator`` (0 when absent)."""
        return init_param_tree(self.param_specs(), generator, device)

    def serving_params(self, params: ParamTree) -> ParamTree:
        """The weights cast once to the activation dtype ``cfg.dtype``, for
        serving: every leaf the layers cast to the activation dtype where they
        use it (``.to(x.dtype)``) is cast here instead, and the norms stay in
        their own dtype.  The cast is the same elementwise rounding, so the
        logits are the same bits as with ``params``."""
        dt = getattr(torch, self.cfg.dtype)

        def cast(path: str, t: torch.Tensor) -> torch.Tensor:
            return t if _NORM_KEYS.intersection(path.split("/")) else t.to(dt)

        return ParamTree(map_tree(cast, params.to_tree()))

    # ------------------------------------------------------------ embeddings

    def _check_family(self) -> None:
        cfg = self.cfg
        if cfg.is_encdec or cfg.frontend:
            raise NotImplementedError(
                f"{cfg.name}: the enc-dec/vlm frontends are not ported yet (ROADMAP.md, Queue 1, LM stack)")
        transformer.check_ported(cfg)

    def _embed_inputs(self, params, batch) -> torch.Tensor:
        return embed(params["embed"], batch["tokens"], getattr(torch, self.cfg.dtype))

    def _logits(self, params, x) -> torch.Tensor:
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        x = norm(params["final_norm"], x)
        if cfg.tie_embeddings:
            logits = unembed(params["embed"], x)
        else:
            logits = x @ params["lm_head"]["kernel"].to(x.dtype)
        logits = softcap(logits.float(), cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab:
            # exact semantics: padded vocab rows never receive probability
            pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
            logits = torch.where(pad_mask, logits, -1e30)
        return logits

    # ----------------------------------------------------------------- train

    def forward(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full-sequence logits. batch: tokens (B, S)."""
        self._check_family()
        x = self._embed_inputs(params, batch)
        x, _, aux = transformer.decoder_stack(params["decoder"], x, self.cfg)
        return self._logits(params, x), aux

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token CE. batch needs 'labels' (B, S), -1 = masked."""
        logits, aux = self.forward(params, batch)
        labels = batch["labels"].long()
        mask = (labels >= 0).float()
        safe = torch.clamp_min(labels, 0)
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        ce = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
        total = ce
        metrics = {"ce_loss": ce, "tokens": torch.sum(mask)}
        for k, v in aux.items():
            total = total + v
            metrics[k] = v
        metrics["loss"] = total
        return total, metrics

    # ----------------------------------------------------------------- serve

    def make_cache(self, batch: int, max_len: int, device="cuda") -> Dict[str, Any]:
        """An empty KV cache for ``batch`` sequences of up to ``max_len``
        tokens, in ``cfg.dtype`` on ``device``.  ``prefill`` and
        ``decode_step`` write it in place."""
        cfg = self.cfg
        self._check_family()
        dt = getattr(torch, cfg.dtype)
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {
            "layers": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)},
            "pos": torch.zeros((), dtype=torch.int32, device=device),
        }

    def prefill(self, params, batch, cache) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Run the prompt through the model, filling ``cache`` (which must be
        empty).  Returns (logits for the last position (B, vocab), cache)."""
        return self._serve(params, batch, cache)

    def decode_step(self, params, batch, cache) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One-token step: batch['tokens'] is (B, 1)."""
        return self._serve(params, batch, cache)

    def _serve(self, params, batch, cache):
        self._check_family()
        pos = cache["pos"]
        x = self._embed_inputs(params, batch)
        s = x.shape[1]
        x, layers, _ = transformer.decoder_stack(params["decoder"], x, self.cfg,
                                                 cache={**cache["layers"], "pos": pos})
        logits = self._logits(params, x[:, -1:, :])[:, 0]
        return logits, {"layers": layers, "pos": pos + s}


def build_model(cfg: ArchConfig) -> LM:
    return LM(cfg)


def exact_param_count(cfg: ArchConfig) -> int:
    """Exact parameter count from the spec tree (no materialization)."""
    total = 0

    def count(_path: str, spec: ParamSpec) -> None:
        nonlocal total
        total += int(np.prod(spec.shape))

    map_tree(count, LM(cfg).param_specs())
    return total
