"""Input-shape sets for the assigned LM architectures.

``train_*`` lowers ``train_step``; ``prefill_*`` lowers ``prefill``;
``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``), per the assignment.  ``long_500k`` requires
sub-quadratic attention and only applies to the ssm/hybrid families
(skips recorded in configs + DESIGN.md §4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

ALL_SHAPE_IDS: Tuple[str, ...] = tuple(SHAPES)


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]
