"""The port's sharded models on CPU ranks: the DTensor train step, sharded
serving, the elastic checkpoint restore and expert-parallel MoE.

The port runs one process per rank: each module fixture spawns one gloo
process group (``launch.ranks.run_ranks``, a ``file://`` store under the
test's temporary directory, one CPU thread a rank) and every rank runs a
program of ``torch_sharded_ranks`` and returns its deviations from the
single-process port on the same seeded weights and batches.  The
expert-parallel dispatch is also held against the reference's
``_dispatch_combine_local`` on the same routing, and a forward on weights
carried from the reference against the reference's logits.

Tolerances (of each leaf's, or each output's, largest value):

* float64 (every leaf float64): 1e-12 after 2 AdamW steps, prefill and 2
  decode steps 1e-12 (measured about 6e-14 and 1e-15);
* float32: 1e-5 for the reduced, clipped gradients of the first step (the
  first moment after it, ``(1 - b1) g``; measured up to 1.6e-6) and for the
  losses of both steps.  What follows the first update is not held in
  float32 at 1e-5: the ranks' sums run in another order, and AdamW's
  normalised update turns a last-bit difference of a gradient entry that
  nearly cancels into one of up to lr (the parameters after 2 steps
  measured up to 7.6e-5 of a leaf's largest, the moments 1.6e-5);
* path K2's moment gate (``K2_MOMENT_GATE``, the largest over the moment
  leaves of ||sharded - single|| / ||single||), measured here at reduced
  width in K2's precision (bf16 compute, float32 master weights): sound
  runs stay under it, and a run whose data rank 1 drops its gradient
  exceeds it;
* int8-compressed data-parallel gradients: 0.05 of the exact ones (the
  reference's bound for ``dp_allreduce_compressed``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402
from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402

F64, F32, COMPRESSED = 1e-12, 1e-5, 0.05
K2_MOMENT_GATE = 0.2  # chip_smoke.py's K2_MOMENT_REL


def _carried():
    """The reference's reduced phi3-mini weights (its attention kernels
    rescaled to their true fan-in, as ``tests/test_torch_lm.py`` carries
    them), as numpy, and the reference model."""
    cfg = r_get_arch(ranks.TRAIN_ARCHS[0]).reduced
    model = r_build_model(cfg)
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    factor = {"wq": np.sqrt(h / d), "wk": np.sqrt(h / d), "wv": np.sqrt(h / d), "wo": np.sqrt(hd / (h * hd))}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        node = np.asarray(node)
        if len(path) >= 3 and path[-3] == "attn" and path[-1] == "kernel":
            return (node * factor[path[-2]]).astype(node.dtype)
        return node

    return model, walk(model.init_params(jax.random.PRNGKey(2)), ())


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded4")
    _model, tree = _carried()
    return run_ranks(ranks.four_rank_cases, 4, (str(tmp / "ckpt"), tree), store_dir=tmp, timeout=600)


def _routing(seed=0, b=4, s=8, d=64, e=8, k=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d))
    idx = np.argsort(rng.random(size=(b, s, e)), axis=-1)[..., :k].astype(np.int64)
    gates = rng.random(size=(b, s, k))
    gates /= gates.sum(-1, keepdims=True)
    return x, idx, gates


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded8")
    x, idx, gates = _routing()
    return run_ranks(ranks.moe_cases, 8, (x, idx, gates, 3), store_dir=tmp, timeout=600)


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("staged4")
    return run_ranks(ranks.staged_cases, 4, (), store_dir=tmp, backend="gloo_staged", timeout=600)


def _train_results(results, dtype):
    out = {k: v for r in results for k, v in r.items() if k.startswith("train/") and f"/{dtype}/" in k}
    assert out, f"no {dtype} train case ran"
    return out


@pytest.mark.parametrize("arch", ranks.TRAIN_ARCHS)
def test_sharded_train_step_float64_matches_single_process(four, arch):
    """Two steps on (2, 2) and (1, 4): every leaf of parameters and moments
    within 1e-12 of the single-process step's; the losses too."""
    cases = {k: v for k, v in _train_results(four, "float64").items() if f"/{arch}/" in k}
    assert {k.split("/")[3] for k in cases} == {"2x2", "1x4"}
    for key, res in cases.items():
        rel, path = res["dev"]["float64"]
        assert rel <= F64, (key, path, rel)
        assert res["loss"] <= F64, (key, res["loss"])


@pytest.mark.parametrize("arch", ranks.OTHER_ARCHS)
def test_other_families_shard(four, arch):
    """The ssm, enc-dec and vlm families on (2, 2): loss and every gradient
    within 1e-12 of the single process's (of the leaf's largest; 1e-3
    absolute floor for the key biases, whose exact gradient is zero)."""
    res = four[0][f"family/{arch}"]
    assert res["loss"] <= F64 and res["grad"] <= F64, res


def test_carried_reference_weights_shard(four):
    """The reference's weights carried with ``models.convert`` and placed over
    (2, 2) by ``distribute_tree``: the sharded forward's logits within 1e-5
    of the reference's largest (the bound ``tests/test_torch_lm.py`` holds the
    single-device port to)."""
    model, tree = _carried()
    ref, _ = model.forward(jax.tree_util.tree_map(jnp.asarray, tree),
                           {"tokens": jnp.asarray(four[0]["carried_tokens"])}, remat=False)
    ref = np.asarray(ref, np.float64)
    for r in four:
        assert np.abs(r["carried_logits"] - ref).max() <= 1e-5 * np.abs(ref).max()


def test_sharded_train_step_with_microbatches(four):
    """Two microbatches (the same global rows as the single-process split)."""
    res = four[0][f"train/{ranks.TRAIN_ARCHS[0]}/float64/2x2/mb2"]
    assert res["dev"]["float64"][0] <= F64 and res["loss"] <= F64


@pytest.mark.parametrize("arch", ranks.TRAIN_ARCHS)
def test_sharded_train_step_float32(four, arch):
    """float32 on (2, 2) and (1, 4): the first step's reduced, clipped
    gradients and both steps' losses within 1e-5 of the single-process
    step's."""
    cases = {k: v for k, v in _train_results(four, "float32").items() if f"/{arch}/" in k}
    assert {k.split("/")[3] for k in cases} == {"2x2", "1x4"}
    for key, res in cases.items():
        assert res["grad"] <= F32, (key, res)
        assert res["loss"] <= F32, (key, res["loss"])


def test_moment_gate_catches_a_dropped_data_rank(four):
    """Path K2's gate on the moments, at reduced width in K2's precision on
    (2, 2): the sound run under it, the run that drops data rank 1's
    gradient well over it."""
    gaps = four[0]["moment_gap"]
    assert gaps["sound"][0] <= K2_MOMENT_GATE < gaps["dropped"][0], gaps


@pytest.mark.parametrize("arch", ranks.TRAIN_ARCHS + ranks.OTHER_ARCHS)
def test_sharded_prefill_and_decode(four, arch):
    """Prefill and 2 decode steps over (2, 2) (the cache sharded on its rows
    over 'model'; Whisper's frames and InternVL2's patches placed on 'data'):
    logits within 1e-12 of the single-process run."""
    for r in four:
        assert r[arch] <= F64, r[arch]


def test_checkpoint_restores_elastically(four):
    """Saved on (2, 2); restored on (1, 4) and on one process bit for bit."""
    for rank, r in enumerate(four):
        ck = r["ckpt"]
        assert ck["step"] == ranks.STEPS
        assert ck["mesh14_bits"] and ck["placed"] == ck["leaves"]
        assert ck.get("alone_bits", rank != 0)


def test_compressed_dp_reduction(four):
    """int8 payloads as the data-axis reduction: within the reference's bound."""
    for r in four:
        assert r["compress"] <= COMPRESSED


def test_expert_parallel_moe_matches_local_and_reference(eight):
    """Expert-parallel dispatch on (2, 4) (2 experts a rank) against the
    port's local path and the reference's ``_dispatch_combine_local`` on the
    same routing (capacity 3 drops some assignments; the reference's sum is
    float32, so 1e-6 there), and ``moe_layer`` against the single-device
    port."""
    x, idx, gates = _routing()
    r0 = eight[0]
    model_params = ranks.build_model(ranks.config("moonshot-v1-16b-a3b", "float64")).init_params(
        torch.Generator().manual_seed(0), device="cpu")["decoder"]["blocks"][0]["moe"]
    p = {k: jnp.asarray(model_params[k].detach().numpy()) for k in ("wi", "wg", "wo")}
    cfg = ranks.config("moonshot-v1-16b-a3b", "float64")
    ref = np.asarray(r_moe._dispatch_combine_local(p, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates), 3,
                                                   cfg.moe.n_experts, cfg.moe.top_k, cfg.activation))
    scale = np.abs(ref).max()
    for r in eight:
        assert np.abs(r["dispatch"] - r["local"]).max() <= F64 * scale
        # the reference combines into float32 whatever the input dtype
        assert np.abs(r["dispatch"] - ref).max() <= 1e-6 * scale
        assert r["layer"] <= F64
    assert r0["wi_local"] == (cfg.moe.n_experts // 4, cfg.d_model, cfg.moe.d_ff_expert)


def test_staged_gloo_takes_every_collective(staged):
    """``gloo_staged`` (gloo, DTensor's collectives staged through host
    buffers and reduced on the device, for ranks that share a card; forced
    for the host's tensors here): all-to-all, all-gather, reduce-scatter and
    all-reduce through the functional collectives give gloo's own answers,
    and a sharded hybrid's prefill and decode over it agree with one
    process."""
    world = len(staged)
    ts = [np.arange(8.0) + 10 * r for r in range(world)]
    total = sum(ts)
    for rank, r in enumerate(staged):
        assert r["backend"] == "gloo"
        np.testing.assert_array_equal(np.asarray(r["max"]), ts[-1])
        a2a = np.concatenate([t[2 * rank:2 * rank + 2] for t in ts])
        want = [a2a, np.concatenate(ts), total[2 * rank:2 * rank + 2], total]
        for got in (r["direct"], r["functional"]):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g), w)
        assert r["serve"] <= F64
