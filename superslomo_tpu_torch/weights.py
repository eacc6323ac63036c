"""Model weights: conversion from the JAX package's parameter trees, seeded
random weights, and the reference ``.pt`` checkpoint layout.

The JAX tree is ``{"params": {"stage1": {...}, "stage2": {...}}}`` with each
conv at ``<layer>/conv/{kernel (HWIO), bias}`` and a recurrent bottleneck's
at ``conv6/{fwd,rev}_l{L}/{gates,candidate}/{kernel, bias}``. The port's
state dicts use the reference names, OIHW:

    conv1a/conv/kernel    → conv1a.0.weight
    conv6_0/conv/kernel   → conv6.0.0.weight
    conv6/fwd_l1/gates/kernel     → conv6.forward_net.cell_list.1.conv.weight
    conv6/rev_l0/candidate/kernel → conv6.reverse_net.cell_list.0.conv_can.weight
    final_conv/conv/kernel → final_conv.weight

A recurrent model's state (``rnn_carry``) crosses between the frameworks with
``torch_carry_from_jax`` / ``jax_carry_from_torch``: the same dict and tuple
structure, each leaf NHWC on the JAX side and NCHW on the port's.

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
from superslomo_tpu_torch.models.superslomo import check_stage_shapes, stage_unets

_DIRECTIONS = {"fwd": "forward_net", "rev": "reverse_net"}
_RECURRENT_CONVS = {"gates": "conv", "candidate": "conv_can"}


def _torch_prefix(layer: str) -> str:
    if layer == "final_conv":
        return "final_conv"
    m = re.fullmatch(r"conv6_([01])", layer)
    if m:
        return f"conv6.{m.group(1)}.0"
    if re.fullmatch(r"conv\d+[ab]|fuse_conv", layer):
        return f"{layer}.0"
    raise KeyError(f"unknown layer in the JAX parameter tree: {layer!r}")


def _put_conv(sd: dict, prefix: str, node: dict, where: str) -> None:
    if set(node) != {"kernel", "bias"}:
        raise KeyError(f"{where}: expected {{kernel, bias}}, got {node!r:.200}")
    kernel = np.asarray(node["kernel"], dtype=np.float32)
    sd[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(node["bias"], dtype=np.float32).copy())


def _convert_recurrent(sd: dict, tree: dict, where: str) -> None:
    """``conv6/{fwd,rev}_l{L}/{gates,candidate}`` → the BiConvRNN's convs."""
    for name, cell in tree.items():
        m = re.fullmatch(r"(fwd|rev)_l(\d+)", name)
        if m is None or not cell or not set(cell) <= set(_RECURRENT_CONVS):
            raise KeyError(f"{where}/{name}: not a recurrent cell's convs, got {cell!r:.200}")
        for conv, node in cell.items():
            prefix = f"conv6.{_DIRECTIONS[m.group(1)]}.cell_list.{m.group(2)}.{_RECURRENT_CONVS[conv]}"
            _put_conv(sd, prefix, node, f"{where}/{name}/{conv}")


def _convert_stage(tree: dict, stage: str, spec: ModelSpec) -> "OrderedDict[str, torch.Tensor]":
    sd = OrderedDict()
    for layer, node in tree.items():
        if layer == "conv6":
            _convert_recurrent(sd, node, f"{stage}/conv6")
            continue
        prefix = _torch_prefix(layer)
        if set(node) != {"conv"}:
            raise KeyError(f"{stage}/{layer}: expected conv/{{kernel, bias}}, got {node!r:.200}")
        _put_conv(sd, prefix, node["conv"], f"{stage}/{layer}/conv")
    check_stage_shapes(sd, spec, stage)
    return sd


def torch_state_from_jax(params: dict, spec: ModelSpec = ModelSpec()) -> dict:
    """JAX param tree (numpy or JAX arrays) → ``{"stage1": state_dict,
    "stage2": state_dict}`` for ``SuperSloMo.load_state`` of a ``spec``
    model. Unknown or missing keys raise KeyError, other shapes than the
    model's ValueError; for the bottleneck both name ``[TPU] CLSTM_MERGE``
    and ``CLSTM_GATE_ORDER``."""
    tree = params["params"]
    if set(tree) != {"stage1", "stage2"}:
        raise KeyError(f"expected stages stage1 and stage2, got {sorted(tree)}")
    return {stage: _convert_stage(tree[stage], stage, spec) for stage in ("stage1", "stage2")}


def _map_carry(carry, leaf_fn):
    if carry is None:
        return None
    if isinstance(carry, dict):
        return {k: _map_carry(v, leaf_fn) for k, v in carry.items()}
    if isinstance(carry, (tuple, list)):
        return tuple(_map_carry(v, leaf_fn) for v in carry)
    return leaf_fn(carry)


def _torch_leaf(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # numpy's bfloat16 extension type: through f32, exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).permute(0, 3, 1, 2)
    return torch.from_numpy(a.copy()).permute(0, 3, 1, 2)


def torch_carry_from_jax(carry):
    """A JAX model's ``rnn_carry`` (NHWC leaves) → the port's (NCHW leaves,
    channels_last views on the CPU), the same dict and tuple structure."""
    return _map_carry(carry, _torch_leaf)


def jax_carry_from_torch(carry):
    """The port's ``rnn_carry`` (NCHW leaves) → numpy NHWC leaves for a JAX
    model, the same structure. bf16 leaves come back as their exact f32
    values (numpy has no bfloat16): cast them to the model's dtype."""
    return _map_carry(carry, lambda x: x.detach().float().permute(0, 2, 3, 1).cpu().numpy())


def seeded_state(spec: ModelSpec, seed: int) -> dict:
    """Random weights made with numpy from ``seed``: fan-in-scaled normal
    kernels (std sqrt(2 / fan_in)) and small normal biases (std 0.01),
    drawn stage by stage in sorted key order."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = dict(zip(("stage1", "stage2"), stage_unets(spec)))
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
