"""Model weights: conversion from the JAX package's parameter tree, and seeded
random weights.

The JAX tree is ``{"params": {"stage1": {...}, "stage2": {...}}}`` with each
conv at ``<layer>/conv/{kernel (HWIO), bias}``. The port's state dicts use the
reference names, OIHW:

    conv1a/conv/kernel    → conv1a.0.weight
    conv6_0/conv/kernel   → conv6.0.0.weight
    final_conv/conv/kernel → final_conv.weight
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

from superslomo_tpu_torch.config import ModelSpec
from superslomo_tpu_torch.models.unet import UNet


def _torch_prefix(layer: str) -> str:
    if layer == "final_conv":
        return "final_conv"
    m = re.fullmatch(r"conv6_([01])", layer)
    if m:
        return f"conv6.{m.group(1)}.0"
    if re.fullmatch(r"conv\d+[ab]|fuse_conv", layer):
        return f"{layer}.0"
    raise KeyError(f"unknown layer in the JAX parameter tree: {layer!r}")


def _stage_keys() -> set:
    with torch.device("meta"):
        return set(UNet(6, 4).state_dict())


def _convert_stage(tree: dict, stage: str) -> "OrderedDict[str, torch.Tensor]":
    sd = OrderedDict()
    for layer, node in tree.items():
        prefix = _torch_prefix(layer)
        if set(node) != {"conv"} or set(node["conv"]) != {"kernel", "bias"}:
            raise KeyError(f"{stage}/{layer}: expected conv/{{kernel, bias}}, got {node!r:.200}")
        kernel = np.asarray(node["conv"]["kernel"], dtype=np.float32)
        sd[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(node["conv"]["bias"], dtype=np.float32).copy())
    missing = _stage_keys() - set(sd)
    if missing:
        raise KeyError(f"{stage}: missing parameters {sorted(missing)[:6]}")
    return sd


def torch_state_from_jax(params: dict) -> dict:
    """JAX param tree (numpy or JAX arrays) → ``{"stage1": state_dict,
    "stage2": state_dict}`` for ``SuperSloMo.load_state``. Unknown or
    missing keys raise KeyError."""
    tree = params["params"]
    if set(tree) != {"stage1", "stage2"}:
        raise KeyError(f"expected stages stage1 and stage2, got {sorted(tree)}")
    return {stage: _convert_stage(tree[stage], stage) for stage in ("stage1", "stage2")}


def seeded_state(spec: ModelSpec, seed: int) -> dict:
    """Random weights made with numpy from ``seed``: fan-in-scaled normal
    kernels (std sqrt(2 / fan_in)) and small normal biases (std 0.01),
    drawn stage by stage in sorted key order."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {
            "stage1": UNet(6, 4, spec.stage1_bottleneck, emit_encoding=spec.cross_skip),
            "stage2": UNet(16, 5, spec.stage2_bottleneck, accept_encoding=spec.cross_skip),
        }
    state = {}
    for stage, module in shapes.items():
        sd = OrderedDict()
        for key, t in sorted(module.state_dict().items()):
            if key.endswith("weight"):
                std = np.sqrt(2.0 / np.prod(t.shape[1:]))
            else:
                std = 0.01
            sd[key] = torch.from_numpy((rng.standard_normal(tuple(t.shape)) * std).astype(np.float32))
        state[stage] = sd
    return state
