"""``LM.decode_step`` of a batch of sequences at a long context: the port's
serving path (``build_model``, ``init_params``, ``make_cache``, ``prefill``,
``decode_step``) on the configuration's model.

Set-up draws the weights, then prefills every row's prompt through
``LM.prefill``, ``prefill_rows`` rows at a time (each group into its rows
of the one cache), so that the activations fit.  A call is ``steps_per_call``
decode steps of the whole batch at positions ``prompt ..``, with the tokens
drawn from the seed; each call starts again at ``prompt``, so every call does
the same work on the same cache rows.  On the card each step is replayed as
a CUDA graph of ``LM.decode_step`` (``models.model.cuda_graph``), captured
in set-up: a step launches some thousands of kernels, which the host cannot
launch one by one as fast as the card runs them.  ``state()`` is the last step's
float32 logits and, for the checked rows, their latent cache (the prompt's
and the decode steps' rows), their layer inputs and the stack's output at
the prompt's last ``FORCED_TAIL`` positions and the decode steps, and the
expert choices they took, all recorded on the device once, in the prefill
and the first call, through the model's taps (``obs.trace.tapping``): the
check runs each reference layer from the port's own input to it.

While the counters are reset (``reset_counters``, the traced window), the
port's device probe (``obs.trace.arm_probe``) is armed: the model's spans
timed by CUDA events at their bounds, and its counts of latent bytes read
and experts touched; ``counters()`` returns them summed over the window's
steps, under ``lm``."""

from __future__ import annotations

import sys
import time

from .common import Session


FORCED_TAIL = 112  # the prompt's last positions whose layer inputs the check starts from, beside the decode steps


class _Taps:
    """The sink of ``obs.trace.tapping``: while ``active`` lists (local row,
    row) pairs, keeps those rows' layer inputs and stack output (at the
    last ``tail`` positions of a prompt, or a step's one) and their expert
    choices (every position), on the device."""

    def __init__(self, rows, tail):
        self.active, self.tail = None, tail
        self.seen = {r: {"layer.input": [], "stack.output": [], "moe.choice": []} for r in rows}

    def __call__(self, name, t):
        for local, row in self.active or ():
            v = t[local] if name == "moe.choice" else t[local, -self.tail:]
            self.seen[row][name].append(v.detach().clone())


def build(cfg, traffic, seed, device, rank=0, world=1) -> Session:
    import torch

    from bench import harness
    from repro_torch.models import build_model
    from repro_torch.models.model import cuda_graph
    from repro_torch.obs import trace as otrace

    inputs = harness.module("inputs", cfg["inputs"]).Inputs(cfg, seed, device)
    acfg = harness.module("inputs", cfg["inputs"]).arch(cfg)
    card = device.type == "cuda"
    steps, group = int(traffic["steps_per_call"]), int(traffic["prefill_rows"])
    batch, prompt = inputs.batch, inputs.prompt
    rows = inputs.checked_rows()

    def now():
        if card:
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = now()
    model = build_model(acfg)
    params = model.init_params(inputs.generator(), device=device)
    t1 = now()
    print(f"lm_decode: weights drawn in {t1 - t0:.3f} s", file=sys.stderr, flush=True)
    cache = model.make_cache(batch, prompt + steps, device=device)
    taps = _Taps(rows, min(FORCED_TAIL, prompt))
    tokens = inputs.prompts()
    with torch.no_grad(), otrace.tapping(taps):
        for r0 in range(0, batch, group):
            r1 = min(batch, r0 + group)
            part = {"layers": {n: t[:, r0:r1] for n, t in cache["layers"].items()},
                    "pos": torch.zeros((), dtype=torch.int32, device=device)}
            taps.active = [(r - r0, r) for r in rows if r0 <= r < r1]
            model.prefill(params, {"tokens": tokens[r0:r1]}, part)
    del tokens
    t2 = now()
    held = {"params": params, "cache": cache, "decoded": inputs.decoded(steps),
            "pos": torch.full((), prompt, dtype=torch.int32, device=device)}
    out = {}

    def step():
        """One decode step at the position ``held["pos"]`` holds, on its
        token, which it then advances: no host read."""
        pos = held["pos"]
        tok = held["decoded"].index_select(1, (pos - prompt).long().reshape(1))
        with torch.no_grad():
            out["logits"], c = model.decode_step(held["params"], {"tokens": tok}, dict(held["cache"], pos=pos))
        pos.copy_(c["pos"])

    def run(one_step):
        held["pos"].fill_(prompt)
        for _ in range(steps):
            one_step()

    def call(exec_info=None):
        run(held.get("probed") or held["step"])

    def state():
        lat = held["cache"]["layers"]
        rows_lat = torch.cat([lat["ckv"][:, rows], lat["kpe"][:, rows]], dim=-1)  # (layers, R, prompt + steps, .)
        return {"logits": out["logits"], "latent": rows_lat.transpose(0, 1), "inputs": held["inputs"],
                "choices": held["choices"]}

    def reset_counters():
        """The counters' window runs the step with the device probe armed:
        on the card a graph captured with it armed (its events and counts
        are the graph's, read after each replay), else the step itself."""
        held["probe_runs"] = runs = []
        if card:
            probe = otrace.arm_probe(device)
            replay = cuda_graph(step)
            otrace.disarm_probe()

            def probed():
                replay()
                runs.append(probe.result())
        else:
            def probed():
                otrace.arm_probe(device)
                step()
                runs.append(otrace.disarm_probe().result())
        held["probed"] = probed

    def counters():
        held.pop("probed", None)
        return {"lm": _merge(held.pop("probe_runs", []))}

    # a first call records the checked rows' decode steps
    taps.active = [(r, r) for r in rows]
    with otrace.tapping(taps):
        run(step)
    held["inputs"], held["choices"] = _recorded(taps, rows, steps)
    # on the card each step is a CUDA graph, so that the host launches one graph a step
    held["step"] = cuda_graph(step) if card else step
    t3 = now()
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if card else 0.0
    print(f"lm_decode: weights {t1 - t0:.3f} s, prefill {t2 - t1:.3f} s ({batch} x {prompt} tokens), "
          f"first call and capture {t3 - t2:.3f} s; peak {peak:.3f} GB", file=sys.stderr)
    def free():
        held.clear()
        out.clear()

    return Session(call=call, state=state, steps=steps, free=free, counters=counters,
                   reset_counters=reset_counters)


def _merge(runs):
    """The probe records of several steps as one: seconds, calls and counts summed."""
    if not runs:
        return {}
    out = {"clock": runs[0]["clock"], "seconds": {}, "calls": {}, "counts": {}}
    for r in runs:
        for key in ("seconds", "calls", "counts"):
            for name, v in r[key].items():
                if name not in out[key]:
                    out[key][name] = v
                elif isinstance(v, list):
                    out[key][name] = [a + b for a, b in zip(out[key][name], v)]
                else:
                    out[key][name] += v
    return out


def _recorded(taps, rows, steps):
    """What the taps kept of the prefill and the first call (step-major, a
    layer a call): the layer inputs and the stack's output, (rows, layers
    + 1, tail + steps, d), and the expert choices, (rows, MoE layers,
    prompt + steps, k) int16."""
    import torch

    def joined(seen, n):
        """(n, positions, .): a forward pass's n entries, the prefill's then each step's."""
        pre, dec = seen[:n], seen[n:]
        return torch.cat([torch.stack(pre), torch.stack(dec).reshape(steps, n, *dec[0].shape).transpose(0, 1)
                          .flatten(1, 2)], dim=1)

    inputs, choices = [], []
    for r in rows:
        seen = taps.seen[r]
        n_layers, n_moe = len(seen["layer.input"]) // (1 + steps), len(seen["moe.choice"]) // (1 + steps)
        inputs.append(torch.cat([joined(seen["layer.input"], n_layers), joined(seen["stack.output"], 1)]))
        choices.append(joined(seen["moe.choice"], n_moe))
    return torch.stack(inputs), torch.stack(choices).to(torch.int16)
