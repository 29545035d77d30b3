"""Checkpoint store: compressed npz shards with atomic commit and async IO.

The reference's format (``repro/checkpoint/store.py``), so either package
reads what the other wrote for a tree of the same paths.  Shards are
zstd-compressed when the optional ``zstandard`` package is installed and
fall back to stdlib ``zlib`` otherwise; the codec is recorded in
``meta.json`` and in the shard suffix.  Reading a zstd-compressed checkpoint
without ``zstandard`` raises an explicit error at load time; importing this
module never requires it.

Layout::

    <dir>/step_000042/
        meta.json            # step, leaf manifest (path, key, shape, dtype), codec
        shard_00000.npz.zst  # leaf arrays (.zlib fallback)
        COMMIT               # written last: partial checkpoints are ignored

Leaves are keyed by their path in the tree (``models.layers.tree_leaves``:
dict keys, NamedTuple fields, list indices and a ``ParamTree``'s
``named_parameters`` joined with '/'), so a plain dict tree gets the
reference's paths.  bfloat16 leaves are stored as their 16-bit patterns
(numpy has no bfloat16) with ``"bfloat16"`` in the manifest.

A tree of DTensors (a sharded train state, one process per rank) is saved
by every rank together: each leaf is gathered whole (a collective), rank 0
writes the same format, and the ranks meet at a barrier once it is
committed.  ``load_checkpoint(..., shardings=)`` places the restored leaves
by a tree of ``NamedSharding``s, on any mesh, whatever mesh wrote them: the
elastic restore.
"""

from __future__ import annotations

import io
import json
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.layers import ParamTree, tree_leaves

try:
    import zstandard
except ImportError:  # optional: the [compression] extra
    zstandard = None

_COMMIT = "COMMIT"


def _compress(data: bytes) -> Tuple[bytes, str]:
    """Returns (payload, codec name).  Without zstandard, one zlib stream of
    stored blocks (level 0): float weights hardly deflate (about 0.93 at
    level 1), and deflating gigabytes would take minutes."""
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=3).compress(data), "zst"
    return zlib.compress(data, 0), "zlib"


def _decompress(payload: bytes, codec: str, src: Path) -> bytes:
    if codec == "zst":
        if zstandard is None:
            raise RuntimeError(
                f"checkpoint {src} is zstd-compressed but the 'zstandard' package is not "
                "installed — install the [compression] extra to read it"
            )
        return zstandard.ZstdDecompressor().decompress(payload)
    if codec == "zlib":
        return zlib.decompress(payload)
    raise ValueError(f"checkpoint {src} uses unknown codec {codec!r}")


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(a host array that owns its memory, the manifest dtype); a DTensor is
    gathered whole first (every rank must call)."""
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _snapshot(tree: Any) -> List[Tuple[str, np.ndarray, str]]:
    """Every leaf copied to the host: a later in-place update of a parameter
    (AdamW's) must not reach a checkpoint still being written."""
    return [(path, *_to_numpy(leaf)) for path, leaf in tree_leaves(tree)]


def _gather_only(tree: Any) -> None:
    """A rank that does not write takes part in each leaf's gather."""
    for _path, leaf in tree_leaves(tree):
        if _is_dtensor(leaf):
            leaf.full_tensor()


def _write(directory: Path, step: int, leaves: List[Tuple[str, np.ndarray, str]], keep: int) -> Path:
    target = directory / f"step_{step:09d}"
    tmp = directory / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest, arrays = [], {}
    for i, (path, arr, dtype) in enumerate(leaves):
        key = f"leaf_{i:05d}"
        arrays[key] = arr
        manifest.append({"path": path, "key": key, "shape": list(arr.shape), "dtype": dtype})
    raw = io.BytesIO()
    np.savez(raw, **arrays)
    payload, codec = _compress(raw.getbuffer())
    del raw
    (tmp / f"shard_00000.npz.{codec}").write_bytes(payload)
    meta = {"step": step, "format": 1, "codec": codec, "leaves": manifest, "written_at": time.time()}
    (tmp / "meta.json").write_text(json.dumps(meta))
    (tmp / _COMMIT).write_text("ok")
    if target.exists():
        shutil.rmtree(target)
    tmp.rename(target)
    _gc_old(directory, keep)
    return target


def _sharded(tree: Any) -> bool:
    """Whether ``tree`` holds DTensors (every rank then saves it together)."""
    return any(_is_dtensor(leaf) for _p, leaf in tree_leaves(tree))


def _writes(sharded: bool) -> bool:
    """Whether this process writes: always alone, rank 0 of a sharded tree."""
    import torch.distributed as dist

    return not sharded or dist.get_rank() == 0


def save_checkpoint(directory: str | Path, step: int, tree: Any, *, keep: int = 3) -> Path:
    """Synchronous save with atomic COMMIT; keeps the newest ``keep``.  A
    sharded tree: every rank calls, rank 0 writes, all return once committed."""
    sharded = _sharded(tree)
    target = Path(directory) / f"step_{step:09d}"
    if _writes(sharded):
        target = _write(Path(directory), step, _snapshot(tree), keep)
    else:
        _gather_only(tree)
    if sharded:
        import torch.distributed as dist

        dist.barrier()
    return target


def _gc_old(directory: Path, keep: int) -> None:
    steps = sorted(p for p in directory.glob("step_*") if (p / _COMMIT).exists())
    for old in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(
        int(p.name.split("_")[1]) for p in directory.glob("step_*") if (p / _COMMIT).exists()
    )
    return steps[-1] if steps else None


def _from_numpy(arr: np.ndarray, stored: str, want: torch.dtype, device) -> torch.Tensor:
    if stored == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))
    return t.to(device=device, dtype=want)


def _rebuild(template: Any, path: str, load: Callable[[str, Any], torch.Tensor]) -> Any:
    """``template``'s structure with each leaf replaced by ``load(path, leaf)``."""
    if isinstance(template, ParamTree):
        trainable = any(p.requires_grad for p in template.parameters())
        return ParamTree(_rebuild(template.to_tree(data=False), path, load)).trainable_(trainable)

    def sub(k):
        return f"{path}/{k}" if path else str(k)

    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(v, sub(k), load) for k, v in zip(template._fields, template)))
    if isinstance(template, dict):
        return {k: _rebuild(v, sub(k), load) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, sub(i), load) for i, v in enumerate(template))
    return load(path, template)


def load_checkpoint(directory: str | Path, template: Any, step: Optional[int] = None,
                    device="cuda", shardings: Any = None) -> Tuple[int, Any]:
    """Restore into the structure of ``template`` (its leaves' dtypes kept,
    their values ignored: meta tensors serve), as tensors on ``device``.
    A ``ParamTree`` comes back as one, trainable if the template's was.
    ``shardings``: a tree like ``template`` of ``NamedSharding``s; each
    rank then keeps its shard of every leaf, as a DTensor.  Ranks load one
    at a time (a barrier between): each holds the whole checkpoint in host
    memory while it places its shards, and ranks often share a host."""
    import torch.distributed as dist

    if shardings is None or not dist.is_initialized() or dist.get_world_size() == 1:
        return _load(directory, template, step, device, shardings)
    out = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            out = _load(directory, template, step, device, shardings)
        dist.barrier()
    return out


def _load(directory, template: Any, step: Optional[int], device, shardings: Any) -> Tuple[int, Any]:
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {directory}")
    src = directory / f"step_{step:09d}"
    if not (src / _COMMIT).exists():
        raise FileNotFoundError(f"checkpoint {src} is not committed")
    meta = json.loads((src / "meta.json").read_text())
    # codec recorded since format 1+codec; older checkpoints are zstd-only
    codec = meta.get("codec", "zst")
    shard = src / f"shard_00000.npz.{codec}"
    arrays = np.load(io.BytesIO(_decompress(shard.read_bytes(), codec, src)))
    by_path = {m["path"]: (m["key"], m["dtype"]) for m in meta["leaves"]}
    missing = [p for p, _leaf in tree_leaves(template) if p not in by_path]
    if missing:
        raise KeyError(f"checkpoint {src} is missing leaves: {missing[:5]}... ({len(missing)} total)")

    placed = dict(tree_leaves(shardings)) if shardings is not None else {}

    def load(path: str, leaf: Any) -> torch.Tensor:
        key, stored = by_path[path]
        arr = arrays[key]
        want = leaf.dtype if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.asarray(arr)).dtype
        t = _from_numpy(arr, stored, want, device)
        if path not in placed:
            return t
        from torch.distributed.tensor import distribute_tensor

        sh = placed[path]
        return distribute_tensor(t, sh.mesh, sh.placements(), src_data_rank=None)

    return meta["step"], _rebuild(template, "", load)


class CheckpointManager:
    """Async wrapper: ``save_async`` copies every leaf to host memory
    synchronously and writes in a background thread; ``wait`` joins (and
    raises what the write raised); ``restore_or_init`` resumes."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._sharded = False  # a sharded save in flight: wait() meets the other ranks

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        self._sharded = _sharded(tree)
        if not _writes(self._sharded):
            _gather_only(tree)
            return
        leaves = _snapshot(tree)

        def _work():
            try:
                _write(self.directory, step, leaves, self.keep)
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:  # the other ranks wait for rank 0's commit
            import torch.distributed as dist

            self._sharded = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_or_init(self, template: Any, init_fn: Callable[[], Any], device="cuda",
                        shardings: Any = None) -> Tuple[int, Any]:
        step = latest_step(self.directory)
        if step is None:
            return 0, init_fn()
        return load_checkpoint(self.directory, template, step, device, shardings)
