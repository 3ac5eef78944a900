"""Kernel dispatch: TiM matmuls, paged attention and flash attention.

Each CUDA kernel (``csrc/*.cu``) has a wrapper that counts its launches;
``launch_counts`` reads every counter and ``reset_launch_counts`` sets
them to 0.
"""
from __future__ import annotations

from typing import Dict


def _tables():
    from repro_torch.kernels import (flash_attention, paged_attention,
                                     tim_matmul)
    return (tim_matmul.LAUNCHES, paged_attention.LAUNCHES,
            flash_attention.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for t in _tables():
        out.update(t)
    return out


def reset_launch_counts() -> None:
    for t in _tables():
        for k in t:
            t[k] = 0
