"""Reference params (as numpy) -> the port's params tree.

``params_from_numpy(tree, cfg, device)`` takes the reference's serving
params as nested dicts of numpy arrays (the caller converts from its
framework; this module never imports it).  A TernaryWeight arrives as
``{"data", "pos", "neg", "sym", "packed", "k_dim"}``.  The reference
stacks layers over periods (``tree["layers"]["b<j>"]`` with a leading
period axis); the port's ``params["layers"]`` is the list of per-layer
dicts, layer ``period * len(layout) + j``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.ternary import TernaryScales
from repro_torch.core.weights import TernaryWeight

_TW_KEYS = {"data", "pos", "neg", "sym", "packed", "k_dim"}


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16, viewed through uint16) -> torch."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(tree, period, device):
    if isinstance(tree, dict) and _TW_KEYS <= set(tree):
        def take(a):
            a = np.asarray(a)
            return a[period] if period is not None else a
        return TernaryWeight(
            tensor_from_numpy(take(tree["data"]), device),
            TernaryScales(
                tensor_from_numpy(take(tree["pos"]), device).reshape(-1),
                tensor_from_numpy(take(tree["neg"]), device).reshape(-1),
                bool(tree["sym"])),
            bool(tree["packed"]),
            None if tree["k_dim"] is None else int(tree["k_dim"]))
    if isinstance(tree, dict):
        return {k: _convert(v, period, device) for k, v in tree.items()}
    a = np.asarray(tree)
    return tensor_from_numpy(a[period] if period is not None else a, device)


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                      device="cuda") -> Dict[str, Any]:
    """Unstack the reference's period-stacked serving params."""
    dev = resolve_device(device)
    out = {k: _convert(v, None, dev) for k, v in tree.items()
           if k != "layers"}
    out["layers"] = [
        _convert(tree["layers"][f"b{j}"], p, dev)
        for p in range(cfg.n_periods) for j in range(len(cfg.layout))]
    return out
