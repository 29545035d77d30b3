"""Quickstart on the PyTorch/CUDA port: write a stencil in the GTScript DSL,
run it on four backends.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # the host

The port of ``examples/quickstart.py``.  The backends ``debug``, ``numpy``,
``torch`` and ``cuda`` agree to 1e-12; on the card the ``cuda`` backend
launches the generated kernel (on CPU tensors it runs its plain torch
module), whose source's first lines are printed where the reference prints
the generated JAX source.  Without ``--device cpu`` it needs a GPU and says
so.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import gtscript, storage  # noqa: E402
from repro_torch.core.gtscript import PARALLEL, Field, computation, interval  # noqa: E402

BACKENDS = ("debug", "numpy", "torch", "cuda")
NI, NJ, NK, H = 32, 32, 4, 1
WEIGHT = 0.2


# A reusable function — inlined at compile time with offset composition
@gtscript.function
def laplacian(phi):
    return -4.0 * phi[0, 0, 0] + phi[-1, 0, 0] + phi[1, 0, 0] + phi[0, -1, 0] + phi[0, 1, 0]


def smooth_defs(inp: Field[np.float64], out: Field[np.float64], *, weight: np.float64):
    """One Jacobi smoothing step: out = inp + w · ∇²inp."""
    with computation(PARALLEL), interval(...):
        out = inp + weight * laplacian(inp)


def smooth_input(seed: int = 0) -> np.ndarray:
    """The reference's input: (NI + 2H, NJ + 2H, NK) normal draws."""
    return np.random.default_rng(seed).normal(size=(NI + 2 * H, NJ + 2 * H, NK))


def run_backend(backend: str, data: np.ndarray, device) -> tuple:
    """``smooth`` on one backend: (the output, host array; run ms)."""
    st = gtscript.stencil(backend=backend)(smooth_defs)
    kw = {"device": device} if backend in storage.TORCH_BACKENDS else {}
    i = storage.from_array(data, backend=backend, default_origin=(H, H, 0), **kw)
    o = storage.zeros(data.shape, backend=backend, default_origin=(H, H, 0), **kw)
    info = {}
    st(i, o, weight=WEIGHT, exec_info=info)
    o.synchronize()
    return o.to_numpy(), 1e3 * (info["run_end_time"] - info["run_start_time"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="device of the torch and cuda backends' fields")
    args = ap.parse_args(argv)
    device = storage.resolve_device(args.device)

    data = smooth_input()
    results, run_ms = {}, {}
    for backend in BACKENDS:
        results[backend], run_ms[backend] = run_backend(backend, data, device)
        print(f"{backend:>6}: run {run_ms[backend]:.2f} ms, "
              f"interior mean {results[backend][H:-H, H:-H].mean():+.5f}")

    for b in BACKENDS[1:]:
        np.testing.assert_allclose(results[b], results["debug"], rtol=1e-12)
    print(f"all backends agree ✔ (cuda on {device})")

    source = gtscript.stencil(backend="cuda")(smooth_defs).generated_source
    print("\n--- generated CUDA source (inspectable, cached by fingerprint) ---")
    print("\n".join(source.splitlines()[:18]))
    return {"results": results, "run_ms": run_ms, "device": str(device)}


if __name__ == "__main__":
    main()
