"""Configuration of the port: the RADS engine config (:mod:`.rads`) and
the registry of the LM, GNN and recsys architectures,
``get_config(arch_id)`` / ``get_reduced(arch_id)`` / ``all_cells()``,
with the same ids, configs and cells as the reference's registry.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, GNN_SHAPES, GNNConfig,
                                      LM_SHAPES, MLAConfig, MoEConfig,
                                      RECSYS_SHAPES, RecsysConfig, ShapeSpec,
                                      TransformerConfig, scaled_transformer)

_ARCH_MODULES: dict[str, str] = {
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_05b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "graphcast": "repro_torch.configs.graphcast",
    "schnet": "repro_torch.configs.schnet",
    "pna": "repro_torch.configs.pna",
    "gat-cora": "repro_torch.configs.gat_cora",
    "din": "repro_torch.configs.din",
}
# architectures of the reference's registry whose modules are not ported
# yet, each with the ROADMAP.md item that ports them (none is left)
_NOT_PORTED: dict[str, str] = {}

ARCH_IDS: tuple[str, ...] = tuple(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet: ROADMAP.md "
            f"{_NOT_PORTED[arch_id]}")
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: "
                       f"{list(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch_id])


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> TransformerConfig | GNNConfig | RecsysConfig:
    return _module(arch_id).reduced()


def all_cells() -> list[tuple[str, str]]:
    """Every (arch_id, shape_name) cell, 40 in all, in the reference's
    order."""
    return [(a, s.name) for a in ARCH_IDS for s in get_config(a).shapes]


__all__ = [
    "ArchConfig", "TransformerConfig", "MoEConfig", "MLAConfig", "GNNConfig",
    "RecsysConfig", "ShapeSpec", "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES",
    "ARCH_IDS", "get_config",
    "get_reduced", "all_cells", "scaled_transformer",
]
