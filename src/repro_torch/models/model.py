"""Model facade: spec / init / forward / loss / prefill / decode.

``build_model(cfg)`` returns an :class:`LM` whose methods are functions of
(params, batch[, cache]), as in the reference package; ``params`` is the
:class:`~repro_torch.models.layers.ParamTree` that ``init_params`` makes (or
``convert.params_from_reference`` carries over from the reference).  Every
family runs ``forward``, ``loss`` and the serving path ``make_cache →
prefill → decode_step``: dense, moe, ssm (Mamba-2), hybrid (RecurrentGemma),
the enc-dec audio model and the vlm.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.parallel.sharding import is_dtensor, matmul, spmd_scope, with_logical_constraint

from . import attention as attn_mod
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

from .rglru import Scan, make_rglru_cache
from .ssm import make_ssd_cache

# the subtrees and leaves the layers read in float32 whatever the activation
# dtype (norm scales and biases, the MoE router, the RG-LRU gate vectors, the
# SSM's decay, skip and norm vectors); every other leaf is cast to the
# activation dtype where it is used
_FLOAT32_KEYS = frozenset({
    "ln", "ln1", "ln2", "ln_x", "final_norm", "enc_norm", "router",
    "w_input_gate", "b_input_gate", "w_rec_gate", "b_rec_gate", "lambda_param",
    "A_log", "D", "dt_bias", "norm_scale",
})


def _reads_float32(path: str) -> bool:
    return bool(_FLOAT32_KEYS.intersection(path.split("/")))


@dataclass
class LM:
    cfg: ArchConfig
    # the hybrid's RG-LRU recurrence over a prompt: the kernel op, or its
    # plain version (``kernels.rglru.ref.rglru_scan_ref``) for a comparison
    rglru_scan: Scan = rglru_ops.rglru_scan

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
        """Random weights on ``device``, from the seed of ``generator`` (0 when
        absent), in ``cfg.param_dtype`` except the leaves the layers read in
        float32.  Each leaf is drawn in float32 and rounded once, so a
        bfloat16 init equals ``serving_params`` of the float32 one (with
        ``cfg.dtype`` bfloat16) without holding a float32 copy."""
        return init_param_tree(self._typed_specs(), generator, device)

    def _typed_specs(self) -> Dict[str, Any]:
        """``param_specs`` in ``cfg.param_dtype``, but for the leaves the layers read in float32."""
        specs = self.param_specs()
        pdt = self.cfg.param_dtype
        if pdt != "float32":
            specs = map_tree(lambda path, sp: sp if _reads_float32(path) else replace(sp, dtype=pdt), specs)
        return specs

    def abstract_params(self) -> ParamTree:
        """The parameters ``init_params`` makes, as meta tensors: shapes and
        dtypes only, nothing drawn or held (the reference's ``eval_shape``)."""
        return ParamTree(map_tree(lambda _path, sp: torch.empty(sp.shape, dtype=getattr(torch, sp.dtype),
                                                                 device="meta"), self._typed_specs()))

    def serving_params(self, params: ParamTree) -> ParamTree:
        """The weights cast once to the activation dtype ``cfg.dtype``, for
        serving: every leaf the layers cast to the activation dtype where they
        use it (``.to(x.dtype)``) is cast here instead, and the leaves they
        read in float32 stay in their own dtype.  The cast is the same
        elementwise rounding, so the logits are the same bits as with
        ``params``."""
        dt = getattr(torch, self.cfg.dtype)

        def cast(path: str, t: torch.Tensor) -> torch.Tensor:
            return t if _reads_float32(path) else t.to(dt)

        return ParamTree(map_tree(cast, params.to_tree()))

    # ------------------------------------------------------------ embeddings

    def _embed_inputs(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], getattr(torch, cfg.dtype))
        if cfg.frontend == "vision" and "patches" in batch:
            pe = frontends.apply_frontend(params["frontend"], cfg, batch["patches"])
            # a lookup in a vocab-sharded table is summed before the concatenation
            x = torch.cat([pe, with_logical_constraint(x, ("batch", None, "embed"))], dim=1)
        return with_logical_constraint(x, ("batch", "attn_seq", "embed"))

    def _embed_decoder(self, params, tokens, pos) -> torch.Tensor:
        """The enc-dec decoder's inputs: token embeddings plus the learned
        positions ``pos ..`` (``pos`` an int or a 0-d tensor)."""
        dt = getattr(torch, self.cfg.dtype)
        x = embed(params["embed"], tokens, dt)
        posids = pos + torch.arange(x.shape[1], device=x.device)
        return x + params["dec_pos_embed"][posids].to(dt)[None]

    def _logits(self, params, x, constrain: bool = True) -> torch.Tensor:
        """The logits of ``x``; under a mesh sequence-sharded, as the
        reference constrains them, unless ``constrain`` is False (the loss
        takes them sharded on the vocab, as the product leaves them)."""
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        # the whole sequence of the batch's rows, against the vocab-sharded
        # head: the logits leave the product sharded on the vocab (DTensor
        # would otherwise pick a layout that replicates them on the batch)
        x = with_logical_constraint(norm(params["final_norm"], x), ("batch", None, "embed"))
        if cfg.tie_embeddings:
            logits = unembed(params["embed"], x)
        else:
            logits = matmul(x, params["lm_head"]["kernel"].to(x.dtype))
        # in float32 (float64 for float64 activations, as the norms)
        logits = softcap(logits.to(torch.promote_types(logits.dtype, torch.float32)), cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab:
            # exact semantics: padded vocab rows never receive probability
            pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
            logits = torch.where(pad_mask, logits, -1e30)
        return with_logical_constraint(logits, ("batch", "attn_seq", "vocab")) if constrain else logits

    def encode(self, params, frames, *, remat: bool = False) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Enc-dec: the encoder over ``frames`` (B, S_enc, d_model) and each
        decoder layer's cross K/V (the reference's ``_cross_kv``, a list per
        layer where it stacks them).  Pass it as ``batch["enc_kv"]`` to
        ``prefill`` and ``decode_step`` to encode once per request."""
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        enc = transformer.encoder_stack(params["encoder"], frontends.apply_frontend(params["frontend"], cfg, frames),
                                        cfg, remat=remat)
        enc = norm(params["enc_norm"], enc)
        return [attn_mod.encoder_kv(lp["xattn"], enc) for lp in params["decoder"]["blocks"]]

    # ----------------------------------------------------------------- train

    def forward(self, params, batch, *, remat: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full-sequence logits. batch: tokens (B, S) [+ frames / patches].
        ``remat``: recompute each layer (hybrid: each group) in the backward."""
        with spmd_scope():
            return self._forward(params, batch, remat)

    def _forward(self, params, batch, remat: bool, constrain: bool = True):
        cfg = self.cfg
        if cfg.is_encdec:
            enc_kv = self.encode(params, batch["frames"], remat=remat)
            x = self._embed_decoder(params, batch["tokens"], 0)
            x = transformer.xdec_stack(params["decoder"], x, cfg, enc_kv=enc_kv, remat=remat)
            return self._logits(params, x, constrain), {}
        x = self._embed_inputs(params, batch)
        x, aux = transformer.decoder_stack(params["decoder"], x, cfg, remat=remat, scan=self.rglru_scan)
        return self._logits(params, x, constrain), aux

    def loss(self, params, batch, *, remat: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token CE (+ MoE aux). batch needs 'labels' (B, S), -1 = masked."""
        with spmd_scope():
            return self._loss(params, batch, remat)

    def _loss(self, params, batch, remat: bool):
        logits, aux = self._forward(params, batch, remat, constrain=False)
        labels = batch["labels"].long()
        if self.cfg.frontend == "vision" and "patches" in batch:
            # image positions carry no LM loss
            pads = torch.full(batch["patches"].shape[:2], -1, dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pads, labels], dim=1)
        mask = (labels >= 0).float()
        nll = _token_nll(logits, torch.clamp_min(labels, 0))
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
        """An empty cache for ``batch`` sequences of up to ``max_len`` tokens,
        in ``cfg.dtype`` on ``device``, in the reference's layout (each layer
        stack's state stacked along a leading axis): KV caches, and the conv
        tails and recurrent states of the ssm and rglru layers.  ``prefill``
        and ``decode_step`` write it in place."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        hd = cfg.resolved_head_dim if cfg.n_heads else 0

        def kv(*lead):
            shape = lead + (batch, max_len, cfg.n_kv_heads, hd)
            return {"k": torch.zeros(shape, dtype=dt, device=device), "v": torch.zeros(shape, dtype=dt, device=device)}

        def stacked(base, *lead):
            return {n: t.new_zeros(lead + tuple(t.shape)) for n, t in base.items()}

        pos = torch.zeros((), dtype=torch.int32, device=device)
        if cfg.family == "ssm":
            return {"layers": stacked(make_ssd_cache(batch, cfg.d_model, cfg.ssm, dt, device), cfg.n_layers),
                    "pos": pos}
        if cfg.family == "hybrid":
            pat = cfg.rglru.pattern

            def layer(kind, *lead):
                if kind == "rglru":
                    return stacked(make_rglru_cache(batch, cfg.d_model, cfg.rglru, dt, device), *lead)
                return kv(*lead)

            cache: Dict[str, Any] = {
                "groups": {f"{i}_{kind}": layer(kind, cfg.n_layers // len(pat)) for i, kind in enumerate(pat)},
                "pos": pos,
            }
            for r in range(cfg.n_layers % len(pat)):
                kind = pat[r % len(pat)]
                cache[f"tail_{r}_{kind}"] = layer(kind)
            return cache
        return {"layers": kv(cfg.n_layers), "pos": pos}

    def prefill(self, params, batch, cache) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Run the prompt through the model, filling ``cache`` (which must be
        empty).  Returns (logits for the last position (B, vocab), cache).
        Enc-dec: ``batch`` holds 'frames' or the ``encode``d 'enc_kv'; vlm:
        'patches' ahead of the tokens."""
        return self._serve(params, batch, cache)

    def decode_step(self, params, batch, cache) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One-token step: batch['tokens'] is (B, 1) (enc-dec: with 'enc_kv' or 'frames')."""
        return self._serve(params, batch, cache)

    def _serve(self, params, batch, cache):
        with spmd_scope():
            return self._serve_in_scope(params, batch, cache)

    def _serve_in_scope(self, params, batch, cache):
        cfg = self.cfg
        pos = cache["pos"]
        if cfg.is_encdec:
            enc_kv = batch["enc_kv"] if "enc_kv" in batch else self.encode(params, batch["frames"])
            x = self._embed_decoder(params, batch["tokens"], pos)
            x = transformer.xdec_stack(params["decoder"], x, cfg, enc_kv=enc_kv, cache=cache, remat=False)
        else:
            x = self._embed_inputs(params, batch)
            x, _ = transformer.decoder_stack(params["decoder"], x, cfg, cache=cache, remat=False,
                                             scan=self.rglru_scan)
        logits = self._logits(params, x[:, -1:, :])[:, 0]
        return logits, {**{k: v for k, v in cache.items() if k != "pos"}, "pos": pos + x.shape[1]}


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[label] over logits whose vocab is split across
    ``group`` (this rank's columns ``v0 ..``): the softmax's max and sum and
    the label's logit are all-reduced per token; the gradient is local."""

    @staticmethod
    def forward(ctx, logits, labels, v0: int, group):
        from repro_torch.parallel.staged import all_reduce

        vl = logits.shape[-1]
        m = all_reduce(logits.detach().amax(-1), "max", group)
        e = torch.exp(logits - m[..., None])
        s = all_reduce(e.sum(-1), "sum", group)
        local = labels - v0
        mine = (local >= 0) & (local < vl)
        idx = local.clamp(0, vl - 1)
        t = all_reduce(torch.where(mine, torch.gather(logits, -1, idx[..., None])[..., 0], 0), "sum", group)
        ctx.save_for_backward(e, s, idx, mine)
        return torch.log(s) + m - t

    @staticmethod
    def backward(ctx, g):
        e, s, idx, mine = ctx.saved_tensors
        grad = e * (g / s)[..., None]
        grad.scatter_add_(-1, idx[..., None], -(g * mine)[..., None].to(grad.dtype))
        return grad, None, None, None


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[label] of every token.  On DTensors it runs in a
    ``local_map`` on the rank's own tokens: vocab-parallel
    (``_VocabParallelNLL``) where the vocab is sharded, so that the logits are
    never gathered, else over whole vocab rows (DTensor's own gradient of the
    gather would build it on the full batch)."""
    def nll(lg, lb):
        return -torch.gather(F.log_softmax(lg, dim=-1), -1, lb[..., None])[..., 0]

    if not is_dtensor(logits):
        return nll(logits, labels)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, last = logits.device_mesh, logits.dim() - 1
    vocab_dims = [i for i, p in enumerate(logits.placements) if p == Shard(last)]
    tok = [p if p in (Shard(0), Shard(1)) else Replicate() for p in logits.placements]
    if len(vocab_dims) != 1:
        fn = local_map(nll, out_placements=tok, in_placements=(tok, tok), device_mesh=mesh, redistribute_inputs=True)
        return fn(logits, labels)
    vd = vocab_dims[0]
    lg_pl = list(tok)
    lg_pl[vd] = Shard(last)

    def body(lg, lb):
        return _VocabParallelNLL.apply(lg, lb, mesh.get_local_rank(vd) * lg.shape[-1], mesh.get_group(vd))

    fn = local_map(body, out_placements=tok, in_placements=(lg_pl, tok), device_mesh=mesh, redistribute_inputs=True)
    return fn(logits, labels)


def build_model(cfg: ArchConfig, rglru_scan: Scan = rglru_ops.rglru_scan) -> LM:
    return LM(cfg, rglru_scan)


def exact_param_count(cfg: ArchConfig) -> int:
    """Exact parameter count from the spec tree (no materialization)."""
    total = 0

    def count(_path: str, spec: ParamSpec) -> None:
        nonlocal total
        total += int(np.prod(spec.shape))

    map_tree(count, LM(cfg).param_specs())
    return total
