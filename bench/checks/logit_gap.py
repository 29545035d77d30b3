"""An LM decode cell's logits and layers against the plain reference
(``bench/reference/<reference>.py``), run after the session is freed.

The reference regenerates the weights from the seed a layer at a time
(bfloat16 taken to float32) and runs two passes over the checked rows
(``Inputs.checked_rows``: three from the seed and the batch's last):

- the chain: each row's prompt and decoded tokens, the whole sequence at
  once, from the embedding through every layer to the logits, on the
  program's choices of experts throughout (the program recorded them on the
  device).  Over 27 layers the bfloat16 hidden states drift from the float32
  ones by a few per cent, enough that the reference's own top k would differ
  from the program's at margins up to about 0.05 and carry its tokens away;
  the routing is held in the layer pass instead.  It gives

  - ``start_gap`` / ``last_gap``: the logits of the first call's and the
    window's last call's last step (the position ``prompt + steps - 1``)
    against the reference's there: the largest absolute difference over the
    checked rows, over the reference's largest magnitude.

- the layers: each layer run alone from the program's own input to it (the
  program's layer inputs at the prompt's last positions and the decode
  steps, which ``bench/drivers/lm_decode.py`` keeps on the device), after
  the program's latent cache of the positions before them (``prefix``).  So each layer's reading
  is one layer's rounding, with no drift from the layers below.  It gives

  - ``latent_gap``: the largest over the layers of the latent cache rows the
    program wrote at those positions (the normed latent and the rotated rope
    key) against the reference's, the same measure as the logits';
  - ``layer_gap``: the largest over the layers of the program's output of the
    layer (the next layer's input) against the reference's, over the
    largest magnitude of the reference layer's own change to its input;
  - ``route_mismatches``: the choices of experts at which the reference's
    margin between its k-th and (k+1)-th biased score is at least
    ``replay_margin`` and its own top k differs from the program's (limit
    0).  Below that margin the program's bfloat16 run and the float32
    reference rank two experts either way, and the reference takes the
    program's choice (routing replay), reporting the share so replayed;
    above it the reference runs on its own choice;
  - ``replayed_share``: the share of the choices so replayed, held under a
    limit so that the routing check never concedes most of them.

The limits of the logit gaps are the cell's ``limits``; ``latent_limit``,
``layer_limit``, ``replay_margin`` and ``replay_limit`` are the cell file's
own keys.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Tuple

import torch


def _finite(r: float) -> float:
    return r if r == r and r != float("inf") else float("inf")


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest absolute difference over the reference's largest magnitude (inf where not finite)."""
    return _finite(float((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)))


def reference_weights(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A layer of the port's weights (``decoder/blocks/<l>``) in the
    reference's layout and names, in float32."""
    def f(t):
        return t.float()

    def swiglu(m):
        return {"gate": f(m["wg"]["kernel"]), "up": f(m["wi"]["kernel"]), "down": f(m["wo"]["kernel"])}

    a = tree["attn"]
    w = {"attn_norm": f(tree["ln1"]["scale"]), "wq": f(a["wq"]["kernel"]), "wkv_a": f(a["wkv_a"]["kernel"]),
         "kv_norm": f(a["kv_norm"]["scale"]), "wkv_b": f(a["wkv_b"]["kernel"]), "wo": f(a["wo"]["kernel"]),
         "ffn_norm": f(tree["ln2"]["scale"])}
    if "mlp" in tree:
        w["mlp"] = swiglu(tree["mlp"])
        return w
    m = tree["moe"]
    w.update(router=f(m["router"]["kernel"]), bias=f(m["router"]["bias"]), shared=swiglu(m["shared"]),
             experts={"gate": f(m["wg"]), "up": f(m["wi"]), "down": f(m["wo"])})
    return w


class Forced:
    """``choose`` for the reference's router in a layer run from the
    program's input: the program's choice (``choices``, of the positions
    being run) where the reference's margin between its k-th and (k+1)-th
    biased score is below ``margin``, else its own, counted where it
    differs from the program's."""

    def __init__(self, margin: float):
        self.margin = margin
        self.choices = None
        self.decisions = self.replayed = self.mismatches = 0
        self.widest = 0.0  # the widest margin at which the reference's own choice differs

    def __call__(self, biased: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        k = ids.shape[-1]
        top = torch.topk(biased, k + 1, dim=-1).values
        margin = top[:, k - 1] - top[:, k]
        near = margin < self.margin
        port = self.choices.to(ids.dtype)
        differ = (ids.sort(-1).values != port.sort(-1).values).any(-1)
        self.decisions += int(near.numel())
        self.replayed += int(near.sum())
        self.mismatches += int((differ & ~near).sum())
        if bool(differ.any()):
            self.widest = max(self.widest, float(margin[differ].max()))
        return torch.where(near[:, None], port, ids)


def compare(spec, kept, record, device, ranks) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    from bench import harness

    t0 = time.perf_counter()
    cfg = spec["cfg"]
    extra = json.loads((harness.BENCH / "workloads" / f"{spec['cell']}.json").read_text())
    inputs = harness.module("inputs", cfg["inputs"]).Inputs(cfg, spec["seed"], device)
    ref = harness.module("reference", cfg["reference"])
    steps = int(record["steps_per_call"])
    prompt, latent_w = inputs.prompt, int(cfg["kv_lora_rank"])
    rows = inputs.checked_rows()
    tokens = torch.cat([inputs.prompts()[rows], inputs.decoded(steps)[rows]], dim=1)  # (R, prompt + steps)
    first = kept["first"]
    choices = first["choices"]  # (R, MoE layers, prompt + steps, k)
    latent = first["latent"]  # (R, layers, prompt + steps, latent + rope)
    layer_in = first["inputs"]  # (R, layers + 1, tail + steps, d): each layer's input, then the stack's output
    start = prompt + steps - layer_in.shape[2]  # the first position the layer pass runs
    n_dense = int(cfg["first_k_dense_replace"])
    forced = Forced(float(extra["replay_margin"]))
    latent_by_layer, layer_by_layer = [], []
    with torch.no_grad(), ref.exact_products():
        head = inputs.weights("embed")
        xs = [ref.embed({"embed": head["embedding"].float()}, tokens[i]) for i in range(len(rows))]
        del head
        for layer in range(int(cfg["num_hidden_layers"])):
            w = reference_weights(inputs.weights(f"decoder/blocks/{layer}"))
            moe = layer >= n_dense
            lat_got, lat_want, out_got, out_want, change = [], [], [], [], []
            for i in range(len(rows)):
                mine = choices[i, layer - n_dense] if moe else None
                # the chain, on the program's choices
                xs[i], _info = ref.layer(w, xs[i], cfg, (lambda biased, ids, c=mine: c.to(ids.dtype)) if moe else None)
                # the layer from the program's input to it
                x_in = layer_in[i, layer].float()
                prefix = (latent[i, layer, :start, :latent_w].float(), latent[i, layer, :start, latent_w:].float())
                if moe:
                    forced.choices = mine[start:]
                x_out, info = ref.layer(w, x_in, cfg, forced if moe else None, prefix)
                lat_got.append(latent[i, layer, start:])
                lat_want.append(torch.cat([info["c_kv"], info["k_pe"]], -1))
                out_got.append(layer_in[i, layer + 1])
                out_want.append(x_out)
                change.append(x_out - x_in)
            latent_by_layer.append(gap(torch.stack(lat_got), torch.stack(lat_want)))
            diff = (torch.stack(out_got).float() - torch.stack(out_want)).abs().max()
            layer_by_layer.append(_finite(float(diff / torch.stack(change).abs().max().clamp_min(1e-30))))
            del w
        top = {"final_norm": inputs.weights("final_norm")["scale"].float(),
               "lm_head": inputs.weights("lm_head")["kernel"].float()}
        want = ref.logits(top, torch.stack([x[-1] for x in xs]), cfg)
    del xs
    checks = {
        "start_gap": {"value": gap(first["logits"][rows], want), "limit": spec["limits"]["start_gap"]},
        "last_gap": {"value": gap(kept["final"]["logits"][rows], want), "limit": spec["limits"]["last_gap"]},
        "latent_gap": {"value": max(latent_by_layer), "limit": float(extra["latent_limit"])},
        "layer_gap": {"value": max(layer_by_layer), "limit": float(extra["layer_limit"])},
        "route_mismatches": {"value": forced.mismatches, "limit": 0},
        "replayed_share": {"value": forced.replayed / max(1, forced.decisions), "limit": float(extra["replay_limit"])},
    }
    state = {"rows": rows, "layer_positions": [start, prompt + steps], "routing_decisions": forced.decisions,
             "widest_difference_margin": forced.widest,
             "latent_gap_by_layer": latent_by_layer, "layer_gap_by_layer": layer_by_layer,
             "first_equals_final": bool(torch.equal(first["logits"], kept["final"]["logits"])),
             "logits_max": float(want.abs().max())}
    print(f"logit_gap: the reference took {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return checks, state
