"""Model weights: conversion from the JAX package's parameter trees, seeded
random weights, and the reference ``.pt`` checkpoint layout.

The JAX tree is ``{"params": {"stage1": {...}, "stage2": {...}}}`` with each
conv at ``<layer>/conv/{kernel (HWIO), bias}``. The port's state dicts use the
reference names, OIHW:

    conv1a/conv/kernel    → conv1a.0.weight
    conv6_0/conv/kernel   → conv6.0.0.weight
    final_conv/conv/kernel → final_conv.weight

The reference checkpoint is a ``torch.save``d dict with ``stage1_state_dict``,
``stage2_state_dict``, ``self.optimizer`` (a ``torch.optim.Adam`` state dict
whose parameters are stage 1's state-dict keys, then stage 2's) and
``epoch``; the JAX package reads the same keys
(``training/checkpoint.py::convert_torch_checkpoint``,
``convert_torch_opt_state``). The JAX package's native msgpack checkpoint is
not read: the port has no msgpack decoder.
"""

from __future__ import annotations

import os
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


def vgg_state_from_jax(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX VGG tree ``{"params": {"features_{i}": {kernel (HWIO), bias}}}`` →
    the state dict of ``models.vgg.VGG16Features`` (OIHW)."""
    sd = OrderedDict()
    for name, node in sorted(params["params"].items(), key=lambda kv: int(kv[0].split("_")[1])):
        idx = int(name.split("_")[1])
        kernel = np.asarray(node["kernel"], dtype=np.float32)
        sd[f"features.{idx}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        sd[f"features.{idx}.bias"] = torch.from_numpy(np.asarray(node["bias"], dtype=np.float32).copy())
    return sd


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, stage1: dict, stage2: dict, optimizer: dict, epoch: int, step: int) -> str:
    """Write the reference ``.pt`` layout (all tensors on the CPU) through a
    temporary file and an atomic rename; returns ``path``."""
    blob = {
        "stage1_state_dict": _to_cpu(stage1), "stage2_state_dict": _to_cpu(stage2),
        "self.optimizer": _to_cpu(optimizer), "epoch": int(epoch), "step": int(step),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> dict:
    """Read a ``.pt`` checkpoint onto the CPU. A directory (the JAX package's
    native msgpack checkpoint) raises NotImplementedError."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a native msgpack checkpoint of the JAX package; the port reads only "
            "the reference .pt layout (stage1_state_dict / stage2_state_dict / self.optimizer / epoch)")
    return torch.load(path, map_location="cpu", weights_only=True)


def stage_state_from_checkpoint(blob: dict, stage: str):
    """One stage's state dict from a loaded ``.pt``: ``{stage}_state_dict``,
    or the whole blob as stage 1's raw state dict when it holds neither
    stage key (as the reference's loader allows); None when absent."""
    if "stage1_state_dict" in blob or "stage2_state_dict" in blob:
        return blob.get(f"{stage}_state_dict")
    return blob if stage == "stage1" else None
