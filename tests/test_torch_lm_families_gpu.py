"""The port's hybrid, moe, ssm, enc-dec and vlm families on a CUDA card:
the RG-LRU block against its plain version, the MoE layer and the SSD block
against the CPU, the hybrid model's kernel launches, and the new entry
points' default device.

Needs a GPU and nvcc; skipped elsewhere.  This file imports neither JAX nor
the reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_lm_families_gpu.py
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import codegen_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_scan_ref  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import rglru as t_rglru  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models.layers import init_param_tree  # noqa: E402

pytestmark = pytest.mark.gpu

FAMILIES = ["recurrentgemma-2b", "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b", "mamba2-370m",
            "whisper-medium", "internvl2-1b"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _randn(shape, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device)


def test_hybrid_block_on_the_card_matches_its_plain_version(card):
    """RecurrentGemma's rglru layer at width 256: the prompt through the
    kernel (one launch) gives the plain loop's bits, and a decode step
    launches nothing; the state in the cache is the same."""
    cfg = dataclasses.replace(get_arch("recurrentgemma-2b").reduced, d_model=256, d_ff=512,
                              rglru=dataclasses.replace(get_arch("recurrentgemma-2b").reduced.rglru, d_rnn=256))
    params = init_param_tree(transformer.rglru_block_spec(cfg), torch.Generator().manual_seed(0), card)
    x = _randn((3, 70, 256), 1, card)
    outs = []
    for scan in (rglru_ops.rglru_scan, rglru_scan_ref):
        cache = t_rglru.make_rglru_cache(3, 256, cfg.rglru, torch.float32, device=card)
        codegen_cuda.reset_launch_counts()
        y, cache, _ = transformer.rglru_block(params, x[:, :69], cfg, cache=cache, scan=scan)
        torch.cuda.synchronize()
        prompt = rglru_ops.KERNEL.launches
        codegen_cuda.reset_launch_counts()
        y1, cache, _ = transformer.rglru_block(params, x[:, 69:], cfg, cache=cache, scan=scan)
        torch.cuda.synchronize()
        assert sum(codegen_cuda.launch_counts().values()) == 0  # decode: rglru_step
        outs.append((prompt, y, y1, cache["h"].clone(), cache["conv"].clone()))
    assert outs[0][0] == 1 and outs[1][0] == 0
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.parametrize("capacity", [None, 5])
def test_moe_layer_on_the_card_matches_the_cpu(card, capacity):
    """Moonlight's reduced MoE layer (8 experts, top-2, a shared expert) on
    the card against the same layer on the CPU, with and without drops."""
    cfg = get_arch("moonshot-v1-16b-a3b").reduced
    spec = t_moe.moe_spec(cfg.d_model, cfg.moe, cfg.activation, cfg.use_bias)
    params = init_param_tree(spec, torch.Generator().manual_seed(0), "cpu")
    x = _randn((2, 40, cfg.d_model), 2, "cpu")
    ref, ref_aux = t_moe.moe_layer(params, x, cfg.moe, cfg.activation, capacity=capacity)
    got, aux = t_moe.moe_layer(params.to(card), x.to(card), cfg.moe, cfg.activation, capacity=capacity)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-5)
    for k in ref_aux:
        torch.testing.assert_close(aux[k].cpu(), ref_aux[k], rtol=1e-5, atol=1e-6)


def test_ssd_block_on_the_card_matches_the_cpu(card):
    """Mamba-2's SSD block (no kernel of its own: plain torch on the card) at
    a prompt that is not a multiple of its chunk, then two decode steps,
    against the same block on the CPU; the cache state too."""
    cfg = get_arch("mamba2-370m").reduced
    spec = t_ssm.ssd_spec(cfg.d_model, cfg.ssm)
    params = init_param_tree(spec, torch.Generator().manual_seed(0), "cpu")
    x = _randn((2, 21, cfg.d_model), 6, "cpu")
    outs = {}
    for dev in ("cpu", card):  # the CPU run first: .to(card) moves the parameters
        cache = t_ssm.make_ssd_cache(2, cfg.d_model, cfg.ssm, torch.float32, device=dev)
        ys = [t_ssm.ssd_block(params.to(dev), x[:, lo:hi].to(dev), cfg.ssm, cache=cache)[0].cpu()
              for lo, hi in ((0, 19), (19, 20), (20, 21))]
        outs[str(dev)] = ys + [cache["state"].cpu(), cache["conv"].cpu()]
    for a, b in zip(outs["cpu"], outs[str(card)]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


def test_hybrid_model_prefill_launches_the_kernels(card):
    """The reduced RecurrentGemma (head_dim 16, flash, bfloat16, window 8,
    prompt 24): prefill launches the RG-LRU kernel once per rglru layer (3)
    and bf16 flash once per attention layer (1); decode launches nothing; the
    logits agree with the plain run (chunked attention, the plain scan)."""
    cfg = dataclasses.replace(get_arch("recurrentgemma-2b").reduced, head_dim=16, attention_impl="flash",
                              dtype="bfloat16")
    model, plain = build_model(cfg), build_model(dataclasses.replace(cfg, attention_impl="chunked"), rglru_scan_ref)
    params = model.serving_params(model.init_params(torch.Generator(device=card).manual_seed(0)))
    tokens = torch.randint(0, cfg.vocab, (2, 28), generator=torch.Generator().manual_seed(3)).to(card)
    outs = []
    for m in (model, plain):
        cache = m.make_cache(2, 32)
        codegen_cuda.reset_launch_counts()
        logits, cache = m.prefill(params, {"tokens": tokens[:, :24]}, cache)
        torch.cuda.synchronize()
        pre = {k: n for k, n in codegen_cuda.launch_counts().items() if n}
        codegen_cuda.reset_launch_counts()
        steps = [logits]
        for t in range(24, 28):
            logits, cache = m.decode_step(params, {"tokens": tokens[:, t:t + 1]}, cache)
            steps.append(logits)
        torch.cuda.synchronize()
        assert sum(codegen_cuda.launch_counts().values()) == 0
        outs.append((pre, steps))
    assert outs[0][0] == {rglru_ops.KERNEL.key: 3, flash_ops.KERNEL_BF16.key: 1} and outs[1][0] == {}
    for a, b in zip(outs[0][1], outs[1][1]):
        a, b = a[:, :cfg.vocab], b[:, :cfg.vocab]
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 5e-2 * float(b.abs().max())


@pytest.mark.parametrize("arch", FAMILIES)
def test_new_families_default_to_the_card(card, arch):
    """``init_params``, ``make_cache`` and (enc-dec) ``encode`` put what they
    make on the card when no device is named; a prefill and a decode step
    run there."""
    cfg = get_arch(arch).reduced
    model = build_model(cfg)
    params = model.init_params()
    assert all(p.is_cuda for p in params.parameters())
    cache = model.make_cache(2, 24)
    leaves = [t for t in _leaves(cache)]
    assert leaves and all(t.is_cuda for t in leaves)
    batch = {"tokens": torch.zeros((2, 6), dtype=torch.int32, device=card)}
    if cfg.frontend == "vision":
        batch["patches"] = _randn((2, cfg.encoder_seq, cfg.d_model), 4, card)
    if cfg.is_encdec:
        batch["enc_kv"] = model.encode(params, _randn((2, cfg.encoder_seq, cfg.d_model), 5, card))
        assert all(k.is_cuda and v.is_cuda for k, v in batch["enc_kv"])
    logits, cache = model.prefill(params, batch, cache)
    step = {"tokens": logits.argmax(-1, keepdim=True)}
    if cfg.is_encdec:
        step["enc_kv"] = batch["enc_kv"]
    logits, cache = model.decode_step(params, step, cache)
    assert logits.is_cuda and bool(torch.isfinite(logits[:, :cfg.vocab]).all())
    assert int(cache["pos"]) == 7 + (cfg.encoder_seq if cfg.frontend == "vision" else 0)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
