"""The port's checkpoint I/O against the JAX package's, on the CPU: the
msgpack codec against the ``msgpack`` package (which the port may not
import) with flax's extension hooks, the native checkpoint directory both
ways (JAX's ``save_checkpoint`` read by the port, the port's
``save_native_checkpoint`` read by JAX's ``load_checkpoint``), Adam's state
through the Trainer and back to JAX's ``.pt`` converter, the convert CLI and
``make_clips`` against the JAX tools' output. No jitted JAX program: the JAX
side is numpy, optax and flax serialization."""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import msgpack as msgpack_pkg
import numpy as np
import pytest
import torch
from flax import serialization

from superslomo_tpu.cli import convert_checkpoint as jax_convert_cli
from superslomo_tpu.training import checkpoint as jckpt
from superslomo_tpu.training.checkpoint import _replace_adam_state
from superslomo_tpu.training.trainer import make_optimizer
from superslomo_tpu.utils import make_clips as jax_make_clips
from superslomo_tpu_torch import Trainer, default_config, weights
from superslomo_tpu_torch.cli import convert_checkpoint as convert_cli
from superslomo_tpu_torch.cli.common import load_model_params
from superslomo_tpu_torch.config import ModelSpec
from superslomo_tpu_torch.training.checkpoint import load_native_checkpoint, save_native_checkpoint
from superslomo_tpu_torch.utils import make_clips, msgpack
from tests.test_torch_package import one_torch_thread  # noqa: F401

STAGES = ("stage1", "stage2")


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """A test here writes up to ~0.5 GB of checkpoints, and pytest keeps the
    temporary directories of its last runs: each test's go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _flax_packb(obj):
    return msgpack_pkg.packb(obj, default=serialization._msgpack_ext_pack, strict_types=True, use_bin_type=True)


def _flax_unpackb(data):
    return msgpack_pkg.unpackb(data, ext_hook=serialization._msgpack_ext_unpack, raw=False)


def _assert_tree_equal(got, want, where="tree"):
    """Equal keys in the same order, values and types; arrays of equal dtype,
    shape and values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (where, list(got)[:5], list(want)[:5])
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want), where
    else:
        assert got == want and type(got) is type(want), (where, got, want)


INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
        -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
CODEC_CASES = {
    "ints": INTS,
    "scalars": [None, True, False, 1.5, -0.0, 1e300],
    "str_forms": ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "é" * 40000],
    "bin_forms": [b"", b"x" * 255, b"x" * 256, b"x" * 70000],
    "array_forms": [list(range(15)), list(range(16)), list(range(70000))],
    "map_forms": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)}, {str(i): i for i in range(70000)}],
    "nested_maps": {"params": {"stage1": {"conv1a": {"conv": {"bias": np.arange(3, dtype=np.float32),
                                                                "kernel": np.ones((3, 3, 6, 32), np.float32)}}},
                               "stage2": {}}, "meta": {"n": [1, 2, {"k": None}]}},
    "ext_ndarray": {k: np.arange(n, dtype=d) for k, n, d in (("a", 1, np.uint8), ("b", 1, np.uint16),
                                                             ("c", 1, np.float32), ("d", 1, np.float64),
                                                             ("e", 4, np.float32), ("f", 7, np.int64),
                                                             ("g", 0, np.float32), ("h", 300, np.int8),
                                                             ("i", 70000, np.float32))},
    "ext_npscalar": [np.float32(3.5), np.int32(-7), np.float64(2.0), np.int64(1 << 40), np.uint8(200)],
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_matches_msgpack_package(case):
    obj = CODEC_CASES[case]
    data = _flax_packb(obj)
    assert msgpack.packb(obj) == data
    _assert_tree_equal(msgpack.unpackb(data), _flax_unpackb(data), case)


def test_codec_reads_chunked_and_bfloat16_arrays(monkeypatch):
    """flax chunks arrays over MAX_CHUNK_SIZE bytes (2**30; made 64 here);
    bfloat16 comes back as a torch tensor of the same values."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    bf = (jnp.arange(40, dtype=jnp.float32) / 3).astype(jnp.bfloat16)
    data = serialization.msgpack_serialize({"big": big, "bf": bf, "nested": {"small": np.ones(3, np.float32)}})
    assert b"__msgpack_chunked_array__" in data
    got = msgpack.unpackb(data)
    np.testing.assert_array_equal(got["big"], big)
    np.testing.assert_array_equal(got["nested"]["small"], np.ones(3, np.float32))
    assert got["bf"].dtype == torch.bfloat16 and got["bf"].shape == (40,)
    assert torch.equal(got["bf"].float(), torch.from_numpy(np.asarray(bf.astype(jnp.float32))))
    monkeypatch.undo()
    one = msgpack.unpackb(serialization.to_bytes({"bf": bf[:3].reshape(1, 3), "s": jnp.bfloat16(1.5)}))
    assert one["bf"].shape == (1, 3) and one["s"].shape == () and one["s"].item() == 1.5


@pytest.mark.parametrize("data,message", [
    (_flax_packb(msgpack_pkg.ExtType(2, b"\x92\x01\x02")), "extension type 2"),
    (b"\xc1", "type code 0xc1"),
    (b"\x91\x01\x02", "bytes after"),
    (b"\xc4\x05ab", "truncated"),
])
def test_codec_raises_on_what_flax_does_not_write(data, message):
    with pytest.raises(ValueError, match=message):
        msgpack.unpackb(data)
    with pytest.raises(TypeError, match="set"):
        msgpack.packb({1, 2})


# --------------------------------------------------------------------------- #
SPECS = {
    "conv": ModelSpec(),
    "clstm_stage1": ModelSpec(stage1_bottleneck="CLSTM"),
}


def _jax_params(state):
    """The port's state dicts → the JAX tree, by the JAX package's converter."""
    return {"params": {s: jckpt.convert_unet_state_dict({k: v.numpy() for k, v in sd.items()})
                       for s, sd in state.items()}}


def _jax_opt(params, count, seed, learning_rate=1e-4):
    """optax's inject_hyperparams(adam) state over ``params`` with random
    moments (``_replace_adam_state``) and ``count``."""
    rng = np.random.default_rng(seed)
    rand = lambda scale: jax.tree.map(  # noqa: E731
        lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32), params)
    mu, nu = rand(1e-3), jax.tree.map(np.abs, rand(1e-6))
    return _replace_adam_state(make_optimizer(None, learning_rate).init(params), mu, nu, count)


def _jax_native(name, root):
    """A native directory written by JAX's ``save_checkpoint``: the port's
    seeded weights through JAX's converter, an optax state with random
    moments at count 7, and the JAX trainer's meta."""
    spec = SPECS[name]
    state = weights.seeded_state(spec, seed=3)
    params = _jax_params(state)
    opt = _jax_opt(params, count=7, seed=4)
    path = str(root / "ckpt")
    jckpt.save_checkpoint(path, params, opt_state=opt, meta={"epoch": 3, "step": 42, "spec": {}})
    return name, spec, path, state, params, opt


@pytest.fixture(scope="module", params=sorted(SPECS))
def jax_native(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"native_{request.param}")
    yield _jax_native(request.param, root)
    shutil.rmtree(root, ignore_errors=True)


def _moments(opt, stage, spec):
    adam = opt.inner_state[0]
    return [weights.stage_state_from_jax(jax.tree.map(np.asarray, t["params"][stage]), stage, spec)
            for t in (adam.mu, adam.nu)]


@pytest.mark.parametrize("frozen", [None, "stage1", "stage2"])
def test_port_reads_jax_native_checkpoint(jax_native, frozen):
    name, spec, path, state, params, opt = jax_native
    spec = ModelSpec(**{**spec.__dict__, **({f"{frozen}_freeze": True} if frozen else {})})
    got, adam, meta = load_native_checkpoint(path, spec)
    assert meta == {"epoch": 3, "step": 42, "spec": {}}
    for stage in STAGES:
        assert sorted(got[stage]) == sorted(state[stage])
        assert all(torch.equal(got[stage][k], v) for k, v in state[stage].items()), stage
    trainable = [s for s in STAGES if s != frozen]
    assert adam["step"] == 7 and np.float32(adam["learning_rate"]) == np.float32(1e-4)
    assert sorted(adam["exp_avg"]) == sorted(adam["exp_avg_sq"]) == trainable  # a frozen stage's moments dropped
    for stage in trainable:
        mu, nu = _moments(opt, stage, spec)
        assert all(torch.equal(adam["exp_avg"][stage][k], v) for k, v in mu.items())
        assert all(torch.equal(adam["exp_avg_sq"][stage][k], v) for k, v in nu.items())


def _cfg(tmp_path, spec_name="conv", **overrides):
    over = {"TRAIN_ALLOW_RANDOM_VGG": "TRUE", "TRAIN_CKPT_DIR": str(tmp_path), "TRAIN_BATCH_SIZE": 1,
            "SEED_VALUE": 42, "TRAIN_LR_PERIOD": 2, "TRAIN_LR_DECAY": 0.5}
    if spec_name == "clstm_stage1":
        over["STAGE1_BOTTLENECK"] = "CLSTM"
    over.update(overrides)
    return default_config(**over)


def test_trainer_resumes_from_jax_native_checkpoint(jax_native, tmp_path):
    """Every weight, Adam moment and step, the epoch and step from
    meta.json, the learning rate of the schedule at that epoch; then the
    Trainer's .pt read by JAX's converters gives back optax's moments and
    count (the closed loop)."""
    name, spec, path, state, params, opt = jax_native
    tr = Trainer(_cfg(tmp_path, name, STAGE1_LOADPREV="TRUE", STAGE1_WEIGHTS=path, STAGE2_LOADPREV="TRUE",
                      STAGE2_WEIGHTS=path), expt_name="resumed", device="cpu")
    assert (tr.epoch, tr.step) == (3, 42)
    assert tr.optimizer.param_groups[0]["lr"] == tr.lr_schedule(3) == 1e-4 * 0.5
    for stage in STAGES:
        for k, v in getattr(tr.model, stage).state_dict().items():
            assert torch.equal(v, state[stage][k]), (stage, k)
        mu, nu = _moments(opt, stage, spec)
        named = dict(getattr(tr.model, stage).named_parameters())
        for k, p in named.items():
            st = tr.optimizer.state[p]
            assert st["step"].item() == 7.0 and st["step"].dtype == torch.float32
            assert torch.equal(st["exp_avg"], mu[k]) and torch.equal(st["exp_avg_sq"], nu[k]), (stage, k)
            assert st["exp_avg"].stride() == p.stride()

    pt = tr.save()
    template = jax.tree.map(np.zeros_like, params)
    back, epoch = jckpt.convert_torch_opt_state(pt, template, make_optimizer(None, 1e-4).init(template))
    assert epoch == 3 and int(back.inner_state[0].count) == 7
    for key in ("mu", "nu"):
        _assert_tree_equal(jax.tree.map(np.asarray, getattr(back.inner_state[0], key)),
                           jax.tree.map(np.asarray, getattr(opt.inner_state[0], key)), key)


def test_missing_stage_file_and_foreign_adam_settings(tmp_path):
    """A directory without stage2.msgpack leaves stage 2 seeded in
    ``load_model_params``; an optax state with another b1, or another
    layout, raises."""
    name, spec, path, state, params, opt = _jax_native("conv", tmp_path)
    partial = str(tmp_path / "partial")
    jckpt.save_checkpoint(partial, params, meta={"epoch": 2})
    os.remove(os.path.join(partial, "stage2.msgpack"))
    got, adam, meta = load_native_checkpoint(partial, spec)
    assert sorted(got) == ["stage1"] and adam is None and meta == {"epoch": 2}
    cfg = _cfg(tmp_path, STAGE1_LOADPREV="TRUE", STAGE1_WEIGHTS=partial, STAGE2_LOADPREV="TRUE",
               STAGE2_WEIGHTS=partial, SEED_VALUE=9)
    loaded, seeded = load_model_params(cfg), weights.seeded_state(spec, seed=9)
    assert all(torch.equal(loaded["stage1"][k], v) for k, v in state["stage1"].items())
    assert all(torch.equal(loaded["stage2"][k], v) for k, v in seeded["stage2"].items())
    tr = Trainer(cfg, device="cpu")  # weights only: a fresh optimizer
    assert (tr.epoch, tr.step) == (1, 0) and not tr.optimizer.state

    wrong = opt._replace(hyperparams={**opt.hyperparams, "b1": jnp.asarray(0.8, jnp.float32)})
    jckpt.save_checkpoint(partial, params, opt_state=wrong)
    with pytest.raises(ValueError, match="b1"):
        load_native_checkpoint(partial, spec)
    with open(os.path.join(partial, "opt.msgpack"), "wb") as f:
        f.write(serialization.to_bytes({"count": np.int32(1), "inner_state": {}}))
    with pytest.raises(KeyError, match="inject_hyperparams"):
        load_native_checkpoint(partial, spec)


@pytest.mark.parametrize("frozen", [None, "STAGE2"])
def test_jax_reads_port_native_checkpoint(tmp_path, frozen):
    """``Trainer.save_native`` after one step, read by JAX's
    ``load_checkpoint`` with its templates: the weights, optax's moments
    (zeros for a frozen stage), counts and hyperparameters, and the meta."""
    over = {f"{frozen}_FREEZE": "TRUE"} if frozen else {}
    tr = Trainer(_cfg(tmp_path, **over), device="cpu")
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((1, 2, 32, 32, 3)).astype(np.float32)
    targets = rng.standard_normal((1, 1, 32, 32, 3)).astype(np.float32)
    tr.train_step(frames, targets, np.array([[0.5]], np.float32))
    tr.step = 1
    path = tr.save_native(str(tmp_path / "native"))

    state = {s: getattr(tr.model, s).state_dict() for s in STAGES}
    want = _jax_params({s: {k: v.detach() for k, v in sd.items()} for s, sd in state.items()})
    template = jax.tree.map(np.zeros_like, want)
    opt_template = make_optimizer(None, 1.0).init(template)
    got, opt, meta = jckpt.load_checkpoint(path, template, opt_template)
    _assert_tree_equal(jax.tree.map(np.asarray, got), jax.tree.map(np.asarray, want), "params")
    assert meta["epoch"] == 1 and meta["step"] == 1 and meta["spec"]["stage2_freeze"] == bool(frozen)
    adam = opt.inner_state[0]
    assert int(adam.count) == int(opt.count) == 1
    hyper = {k: float(np.asarray(v)) for k, v in opt.hyperparams.items()}
    assert hyper == {k: float(np.float32(v)) for k, v in (("learning_rate", 1e-4), ("b1", 0.9), ("b2", 0.999),
                                                          ("eps", 1e-8), ("eps_root", 0.0))}
    for stage in STAGES:
        named = dict(getattr(tr.model, stage).named_parameters())
        for key, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            tree = jax.tree.map(np.asarray, getattr(adam, key)["params"][stage])
            back = weights.stage_state_from_jax(tree, stage, tr.spec)
            for k, p in named.items():
                st = tr.optimizer.state.get(p)
                expect = torch.zeros_like(p) if st is None else st[name]
                assert torch.equal(back[k], expect), (stage, key, k)
        if stage == "stage2" and frozen:
            assert all(not np.any(x) for x in jax.tree.leaves(jax.tree.map(np.asarray, adam.mu["params"][stage])))

    # and the port reads its own directory back to the same state
    tr2 = Trainer(_cfg(tmp_path, STAGE1_LOADPREV="TRUE", STAGE1_WEIGHTS=path, STAGE2_LOADPREV="TRUE",
                       STAGE2_WEIGHTS=path, **over), device="cpu")
    assert (tr2.epoch, tr2.step) == (1, 1)
    for (_, _, p), (_, _, q) in zip(tr.trainable, tr2.trainable):
        assert torch.equal(p, q)
        assert all(torch.equal(tr.optimizer.state[p][k], tr2.optimizer.state[q][k])
                   for k in ("step", "exp_avg", "exp_avg_sq"))


def test_save_native_checkpoint_bytes_equal_flax(tmp_path):
    """The stage files are flax's ``to_bytes`` of the same tree, byte for
    byte."""
    state = weights.seeded_state(ModelSpec(), seed=5)
    save_native_checkpoint(str(tmp_path), state, meta={"k": 1})
    tree = weights.jax_tree_from_torch_state(state)["params"]
    for stage in STAGES:
        with open(tmp_path / f"{stage}.msgpack", "rb") as f:
            assert f.read() == serialization.to_bytes(tree[stage])
    assert json.load(open(tmp_path / "meta.json")) == {"k": 1}
    assert weights.torch_state_from_jax({"params": tree}).keys() == state.keys()


# --------------------------------------------------------------------------- #
def _run_jax_cli(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.main()


def _read_dir(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            data = f.read()
        out[name] = json.loads(data) if name.endswith(".json") else serialization.msgpack_restore(data)
    return out


@pytest.mark.parametrize("layout", ["both_stages", "raw_stage1"])
def test_convert_cli_matches_jax_cli(tmp_path, monkeypatch, layout):
    state = weights.seeded_state(ModelSpec(), seed=8)
    src = str(tmp_path / "ref.pt")
    if layout == "both_stages":
        weights.save_checkpoint(src, state["stage1"], state["stage2"], {}, 4, 0)
    else:
        torch.save(state["stage1"], src)
    convert_cli.main([src, str(tmp_path / "ours")])
    _run_jax_cli(monkeypatch, jax_convert_cli, [src, str(tmp_path / "theirs")])
    ours, theirs = _read_dir(tmp_path / "ours"), _read_dir(tmp_path / "theirs")
    assert sorted(ours) == sorted(theirs) == ["meta.json", "stage1.msgpack", "stage2.msgpack"]
    assert ours["meta.json"] == theirs["meta.json"] == {"source": src}
    for stage in STAGES:
        _assert_tree_equal(weights._sorted_tree(ours[f"{stage}.msgpack"]),
                           weights._sorted_tree(theirs[f"{stage}.msgpack"]), stage)
    cfg = _cfg(tmp_path, STAGE1_LOADPREV="TRUE", STAGE1_WEIGHTS=str(tmp_path / "ours"), STAGE2_LOADPREV="TRUE",
               STAGE2_WEIGHTS=str(tmp_path / "ours"))
    loaded, pt = load_model_params(cfg), weights.load_checkpoint(src)
    for stage in STAGES:
        sd = weights.stage_state_from_checkpoint(pt, stage)
        if sd is not None:
            assert all(torch.equal(loaded[stage][k], v) for k, v in sd.items())


def test_convert_cli_vgg16_matches_jax_cli(tmp_path, monkeypatch):
    """A torchvision-shaped VGG-16 state dict (features 0-28 and the
    classifier) → the same .npz: features below 23 only."""
    rng = np.random.default_rng(9)
    sd = {}
    for i in (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28):
        sd[f"features.{i}.weight"] = torch.from_numpy(rng.standard_normal((4, 3, 3, 3)).astype(np.float32))
        sd[f"features.{i}.bias"] = torch.from_numpy(rng.standard_normal(4).astype(np.float32))
    sd["classifier.0.weight"] = torch.zeros(2, 2)
    src = str(tmp_path / "vgg16.pth")
    torch.save(sd, src)
    convert_cli.main(["--vgg16", src, str(tmp_path / "ours.npz")])
    _run_jax_cli(monkeypatch, jax_convert_cli, ["--vgg16", src, str(tmp_path / "theirs.npz")])
    ours, theirs = np.load(tmp_path / "ours.npz"), np.load(tmp_path / "theirs.npz")
    assert sorted(ours.files) == sorted(theirs.files) and len(ours.files) == 20
    assert all(np.array_equal(ours[k], theirs[k]) for k in ours.files)


@pytest.mark.parametrize("clip_length,step", [(5, 2), (4, 3), (7, 7), (20, 5)])
def test_make_clips_matches_jax(tmp_path, monkeypatch, clip_length, step):
    """Sequences of 3, 8 and 11 frames (PNG and JPEG, interleaved names) and
    a stray file: the same list, byte for byte."""
    root = tmp_path / "seqs"
    for seq, n in (("b", 8), ("a", 11), ("c", 3)):
        (root / seq).mkdir(parents=True)
        for i in range(n):
            (root / seq / f"f{i:03d}.{'jpg' if i % 3 == 0 else 'png'}").write_bytes(b"")
    (root / "notes.txt").write_text("not a sequence")
    make_clips.main([str(root), str(tmp_path / "ours.txt"), "--clip-length", str(clip_length), "--step", str(step)])
    _run_jax_cli(monkeypatch, jax_make_clips, [str(root), str(tmp_path / "theirs.txt"), "--clip-length",
                                              str(clip_length), "--step", str(step)])
    ours, theirs = (tmp_path / "ours.txt").read_bytes(), (tmp_path / "theirs.txt").read_bytes()
    assert ours == theirs
    if clip_length <= 11:
        assert ours
