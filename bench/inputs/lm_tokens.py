"""An LM cell's inputs, made on the device from ``--seed``: the model, its
weights, the prompts, the tokens decoded after them, and the rows the check
holds against the reference.

- the model is the port's ``ArchConfig`` built from the configuration's
  published keys (``arch``), served in bfloat16;
- the weights are drawn as ``LM.init_params`` draws them from a generator
  seeded ``seed``: each leaf from its own generator, seeded by the seed and
  its path, in bfloat16 (the float32 leaves, norms and the router, in
  float32).  So one layer's weights are drawn again alone, and alike
  (``layer_weights``), where the check needs them;
- the prompts: ``batch`` rows of ``prompt`` token ids, uniform over the
  vocabulary; the decoded tokens: ``steps`` more a row, teacher-forced;
- the checked rows: three rows drawn from the seed and the batch's last.

A seed is any whole number; it is taken modulo 2**64.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List

import torch

_GOLDEN = 0x9E3779B97F4A7C15
_PROMPTS, _DECODE = 1, 2
CHECKED_ROWS = 4


def _gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) + stream * _GOLDEN) % 2**64)
    return g


def arch(cfg: Dict[str, Any]):
    """The port's configuration of the published keys in ``cfg`` (a
    DeepSeek-V3 ``config.json``): MLA, the sigmoid router with its bias
    and scaling, dropless experts, the leading dense layers; bfloat16
    weights and activations, prefill through the flash kernel (on a card)."""
    from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

    if cfg["q_lora_rank"] is not None or cfg["scoring_func"] != "sigmoid" or cfg["n_group"] != 1:
        raise ValueError("arch: this cell's model has no query latent, a sigmoid router and one group")
    heads = int(cfg["num_attention_heads"])
    return ArchConfig(
        name=cfg["name"], family="moe", n_layers=int(cfg["num_hidden_layers"]), d_model=int(cfg["hidden_size"]),
        n_heads=heads, n_kv_heads=int(cfg["num_key_value_heads"]), d_ff=int(cfg["intermediate_size"]),
        vocab=int(cfg["vocab_size"]), head_dim=int(cfg["qk_nope_head_dim"]) + int(cfg["qk_rope_head_dim"]),
        norm="rmsnorm", activation="swiglu", rope_theta=float(cfg["rope_theta"]),
        moe=MoEConfig(n_experts=int(cfg["n_routed_experts"]), top_k=int(cfg["num_experts_per_tok"]),
                      d_ff_expert=int(cfg["moe_intermediate_size"]),
                      shared_d_ff=int(cfg["n_shared_experts"]) * int(cfg["moe_intermediate_size"]),
                      scoring="sigmoid", routed_scale=float(cfg["routed_scaling_factor"]), dropless=True),
        mla=MLAConfig(kv_lora_rank=int(cfg["kv_lora_rank"]), qk_nope_head_dim=int(cfg["qk_nope_head_dim"]),
                      qk_rope_head_dim=int(cfg["qk_rope_head_dim"]), v_head_dim=int(cfg["v_head_dim"])),
        n_dense_layers=int(cfg["first_k_dense_replace"]), norm_eps=float(cfg["rms_norm_eps"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]), attention_impl=cfg["attention_impl"],
        dtype=cfg["dtype"], param_dtype=cfg["dtype"],
    )


class Inputs:
    def __init__(self, cfg: Dict[str, Any], seed: int, device):
        self.cfg, self.seed, self.device = cfg, int(seed), torch.device(device)
        self.batch, self.prompt = int(cfg["batch"]), int(cfg["prompt"])
        self.vocab = int(cfg["vocab_size"])

    def prompts(self) -> torch.Tensor:
        """(batch, prompt) token ids."""
        return torch.randint(0, self.vocab, (self.batch, self.prompt), generator=_gen(self.seed, _PROMPTS, self.device),
                             device=self.device)

    def decoded(self, steps: int) -> torch.Tensor:
        """(batch, steps) token ids fed to the decode steps."""
        return torch.randint(0, self.vocab, (self.batch, steps), generator=_gen(self.seed, _DECODE, self.device),
                             device=self.device)

    def checked_rows(self) -> List[int]:
        """The rows the check holds against the reference: three drawn from
        the seed, and the batch's last."""
        n = min(CHECKED_ROWS, self.batch)
        rest = random.Random(self.seed).sample(range(self.batch - 1), n - 1)
        return sorted(rest) + [self.batch - 1]

    def generator(self) -> torch.Generator:
        """The generator ``LM.init_params`` draws the weights from."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed % 2**64)
        return g

    def weights(self, path: str) -> Dict[str, Any]:
        """The subtree of the weights at ``path`` (``'decoder/blocks/3'``,
        ``'embed'``), drawn again exactly as ``init_params`` drew it."""
        from repro_torch.models import build_model
        from repro_torch.models.layers import init_leaf, map_tree

        tree: Any = build_model(arch(self.cfg))._typed_specs()
        for key in path.split("/"):
            tree = tree[int(key)] if isinstance(tree, list) else tree[key]
        seed = self.generator().initial_seed()
        return map_tree(lambda p, spec: init_leaf(p, spec, seed, self.device), tree, path)
