"""The JAX package's native checkpoint directory, read and written by the
port (the counterpart of ``superslomo_tpu/training/checkpoint.py``'s
``save_checkpoint`` / ``load_checkpoint``).

A directory holds ``stage1.msgpack`` and ``stage2.msgpack``, each stage's
flax parameter subtree (HWIO kernels, the names of ``weights.py``'s
docstring), ``meta.json``, and for a resume ``opt.msgpack``: the state of
optax's ``inject_hyperparams(adam)``, as flax serializes it:

    {count, hyperparams: {learning_rate, b1, b2, eps, eps_root},
     hyperparams_states: {},
     inner_state: {"0": {count, mu: {params: {stage1, stage2}}, nu: {...}},
                   "1": {}}}

The port's side of Adam's state is ``{"step", "learning_rate", "exp_avg":
{stage: state_dict}, "exp_avg_sq": {stage: state_dict}}`` over the stages
that train: optax's ``count`` is torch Adam's ``step``, ``mu`` its
``exp_avg`` and ``nu`` its ``exp_avg_sq``. The JAX trainer keeps moments
for a frozen stage too (zeros: it zeroes the stage's gradients); the port
drops them on reading and writes zeros for them.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from superslomo_tpu_torch import weights as wio
from superslomo_tpu_torch.config import ModelSpec
from superslomo_tpu_torch.utils import msgpack

STAGES = ("stage1", "stage2")
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8  # optax.adam's defaults
OPTAX_LAYOUT = ("optax's inject_hyperparams(adam) state {count, hyperparams: {learning_rate, b1, b2, eps, "
                "eps_root}, hyperparams_states, inner_state: {'0': {count, mu, nu}, '1': {}}}")


def trainable_stages(spec: ModelSpec) -> tuple:
    """The stages the optimizer holds, in its order."""
    frozen = {"stage1": spec.stage1_freeze, "stage2": spec.stage2_freeze}
    return tuple(s for s in STAGES if not frozen[s])


def _write(path: str, data: bytes) -> None:
    """Through a temporary file and an atomic rename."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _zeros_like(tree):
    return {k: _zeros_like(v) for k, v in tree.items()} if isinstance(tree, dict) else np.zeros_like(tree)


def save_native_checkpoint(ckpt_dir: str, state: dict, optimizer_state: Optional[dict] = None,
                           meta: Optional[dict] = None) -> str:
    """Write ``state`` (``{stage: state_dict}``; a stage left out is written
    as an empty map, as the JAX package's converter writes it),
    ``optimizer_state`` (the port's side of Adam's state, see the module's
    docstring; a stage without moments gets zeros) as ``opt.msgpack``, and
    ``meta`` as ``meta.json``; returns ``ckpt_dir``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tree = wio.jax_tree_from_torch_state({s: state[s] for s in STAGES if state.get(s) is not None})["params"]
    for stage in STAGES:
        _write(os.path.join(ckpt_dir, f"{stage}.msgpack"), msgpack.packb(tree.get(stage, {})))
    if optimizer_state is not None:
        step = np.asarray(optimizer_state["step"], np.int32)
        moments = {}
        for key in ("exp_avg", "exp_avg_sq"):
            given = wio.jax_tree_from_torch_state(optimizer_state[key])["params"]
            moments[key] = {"params": {s: given.get(s) or _zeros_like(tree[s]) for s in tree}}
        hyper = {"learning_rate": optimizer_state["learning_rate"], "b1": ADAM_BETAS[0], "b2": ADAM_BETAS[1],
                 "eps": ADAM_EPS, "eps_root": 0.0}
        opt = {
            "count": step,
            "hyperparams": {k: np.asarray(v, np.float32) for k, v in hyper.items()},
            "hyperparams_states": {},
            "inner_state": {"0": {"count": step, "mu": moments["exp_avg"], "nu": moments["exp_avg_sq"]}, "1": {}},
        }
        _write(os.path.join(ckpt_dir, "opt.msgpack"), msgpack.packb(opt))
    _write(os.path.join(ckpt_dir, "meta.json"), json.dumps(meta or {}, indent=2).encode())
    return ckpt_dir


def _read(path: str):
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


def _field(node, key: str, where: str):
    if not isinstance(node, dict) or key not in node:
        raise KeyError(f"opt.msgpack: {where} has no {key!r}; expected {OPTAX_LAYOUT}")
    return node[key]


def _adam_from_optax(opt: dict, stages: tuple, spec: ModelSpec) -> dict:
    """optax's state → the port's side of Adam's state for ``stages``."""
    hyper = _field(opt, "hyperparams", "the state")
    want = {"b1": ADAM_BETAS[0], "b2": ADAM_BETAS[1], "eps": ADAM_EPS, "eps_root": 0.0}
    for key, value in want.items():
        got = np.float32(np.asarray(_field(hyper, key, "hyperparams")))
        if got != np.float32(value):
            raise ValueError(f"opt.msgpack: Adam's {key} is {got}, the port's Adam uses {value}")
    inner = _field(_field(opt, "inner_state", "the state"), "0", "inner_state")
    adam = {"step": int(np.asarray(_field(inner, "count", "inner_state['0']"))),
            "learning_rate": float(np.asarray(_field(hyper, "learning_rate", "hyperparams")))}
    for key, name in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        tree = _field(_field(inner, name, "inner_state['0']"), "params", f"inner_state['0'][{name!r}]")
        adam[key] = {s: wio.stage_state_from_jax(_field(tree, s, f"{name}['params']"), s, spec) for s in stages}
    return adam


def load_native_checkpoint(ckpt_dir: str, spec: ModelSpec = ModelSpec()):
    """Read a native checkpoint directory for a ``spec`` model: ``(state,
    adam, meta)``. ``state`` holds each stage whose file is there and not an
    empty map (a stage the directory lacks is left out, as the JAX package's
    ``load_checkpoint`` allows), converted by ``weights.stage_state_from_jax``;
    ``adam`` is the port's side of Adam's state over the stages that train
    in ``spec`` (None without ``opt.msgpack``); ``meta`` is ``meta.json``
    ({} without it). Adam's b1, b2, eps and eps_root must be the port's."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"{ckpt_dir} is not a checkpoint directory")
    state = {}
    for stage in STAGES:
        path = os.path.join(ckpt_dir, f"{stage}.msgpack")
        if os.path.exists(path):
            tree = _read(path)
            if tree:
                state[stage] = wio.stage_state_from_jax(tree, stage, spec)
    adam = None
    opt_path = os.path.join(ckpt_dir, "opt.msgpack")
    if os.path.exists(opt_path):
        adam = _adam_from_optax(_read(opt_path), trainable_stages(spec), spec)
    meta = {}
    meta_path = os.path.join(ckpt_dir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, adam, meta
