"""INI-compatible configuration, a copy of superslomo_tpu/config.py's schema.

The existing ``configs/*.ini`` load unchanged: same sections, keys, defaults
and validation. Of the ``[TPU]`` section the port honours ``COMPUTE_DTYPE``
(float32 | bfloat16) and ``REMAT`` (recompute each U-Net stage's activations
in the training step's backward). ``USE_PALLAS_WARP``, ``LAYOUT_V2`` and
``LV2_*`` select TPU layout devices that the port does not have (the warp
always runs the CUDA kernel on the card; the U-Net runs the plain topology):
they are parsed, so a malformed value still fails, and otherwise ignored.
``DATA_AXIS``/``SPATIAL_AXIS`` name mesh axes and are ignored as well.
``CLSTM_MERGE`` (CONCAT | SUM) and ``CLSTM_GATE_ORDER`` (a permutation of
IFOG for a CLSTM stage, of ZR, or the default IFOG, for a CGRU stage) set the
recurrent bottleneck's layout (models/bottleneck.py).
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import Tuple

_DEFAULTS = {
    ("DATA", "DATASET"): "ADOBE",
    ("DATA", "WINDOW_LENGTH"): "57",
    ("MODEL", "PIXEL_MEAN"): "0.485,0.456,0.406",
    ("MODEL", "PIXEL_STD"): "0.229,0.224,0.225",
    ("TRAIN", "BATCH_SIZE"): "32",
    ("TRAIN", "N_EPOCHS"): "200",
    ("TRAIN", "LEARNING_RATE"): "0.0001",
    ("TRAIN", "LR_PERIOD"): "50",
    ("TRAIN", "LR_DECAY"): "0.1",
    ("TRAIN", "SAVE_EVERY"): "25",
    ("TRAIN", "CROP_IMH"): "224",
    ("TRAIN", "CROP_IMW"): "224",
    ("TRAIN", "LAMBDA_R"): "60",
    ("TRAIN", "LAMBDA_W"): "10",
    ("TRAIN", "LAMBDA_P"): "20",
    ("TRAIN", "ALLOW_RANDOM_VGG"): "FALSE",
    ("TRAIN", "N_FRAMES"): "2",
    ("TRAIN", "CKPT_DIR"): "checkpoints",
    ("VAL", "BATCH_SIZE"): "8",
    ("VAL", "CROP_IMH"): "256",
    ("VAL", "CROP_IMW"): "256",
    ("STAGE1", "ENCODER"): "UNET",
    ("STAGE1", "WEIGHTS"): "",
    ("STAGE1", "LOADPREV"): "FALSE",
    ("STAGE1", "FREEZE"): "FALSE",
    ("STAGE1", "BOTTLENECK"): "CONV",
    ("STAGE2", "ENCODER"): "UNET",
    ("STAGE2", "WEIGHTS"): "",
    ("STAGE2", "LOADPREV"): "FALSE",
    ("STAGE2", "FREEZE"): "FALSE",
    ("STAGE2", "BOTTLENECK"): "CONV",
    ("STAGE2", "CROSS_SKIP"): "TRUE",
    ("DATALOADER", "N_WORKERS"): "4",
    ("DATALOADER", "T_SAMPLE"): "RANDOM",
    ("EVAL", "EVAL_MODE"): "FALSE",
    ("SEED", "VALUE"): "42",
    ("PROJECT", "DIR"): ".",
    ("PROJECT", "LOGDIR"): "logs",
    ("TPU", "COMPUTE_DTYPE"): "float32",  # float32 | bfloat16
    ("TPU", "DATA_AXIS"): "data",
    ("TPU", "SPATIAL_AXIS"): "spatial",
    ("TPU", "USE_PALLAS_WARP"): "AUTO",  # parsed, ignored
    ("TPU", "CLSTM_MERGE"): "CONCAT",
    ("TPU", "CLSTM_GATE_ORDER"): "IFOG",
    ("TPU", "REMAT"): "FALSE",
    ("TPU", "LAYOUT_V2"): "FALSE",  # parsed, ignored
    ("TPU", "LV2_ASSEMBLY"): "AUTO",  # parsed, ignored
    ("TPU", "LV2_SPLIT_DECODER"): "AUTO",  # parsed, ignored
    ("TPU", "LV2_FENCE"): "AUTO",  # parsed, ignored
}

VALID_BOTTLENECKS = ("CONV", "CLSTM", "CGRU")
VALID_T_SAMPLE = ("RANDOM", "MIDDLE", "NIL")
VALID_DATASETS = ("ALL", "ADOBE", "NFS", "VIMEO", "SLOWFLOW", "SINTEL_HFR")
VALID_COMPUTE_DTYPES = ("float32", "bfloat16")
VALID_CLSTM_MERGES = ("CONCAT", "SUM")
REQD_IMAGES = {2: 9, 4: 25, 6: 41, 8: 57}


class Config:
    """Typed view over a configparser with a defaults layer, exposing the
    get/getint/getfloat/getboolean(SECTION, KEY) surface of the reference."""

    def __init__(self, parser: configparser.RawConfigParser | None = None):
        self._p = parser if parser is not None else configparser.RawConfigParser()

    def get(self, section: str, key: str) -> str:
        try:
            return self._p.get(section, key)
        except (configparser.NoSectionError, configparser.NoOptionError):
            dk = (section.upper(), key.upper())
            if dk in _DEFAULTS:
                return _DEFAULTS[dk]
            raise

    def getint(self, section: str, key: str) -> int:
        return int(self.get(section, key))

    def getfloat(self, section: str, key: str) -> float:
        return float(self.get(section, key))

    def getboolean(self, section: str, key: str) -> bool:
        v = self.get(section, key).strip().lower()
        if v in ("true", "1", "yes", "on"):
            return True
        if v in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"Not a boolean: [{section}] {key} = {v!r}")

    def has(self, section: str, key: str) -> bool:
        try:
            self.get(section, key)
            return True
        except (configparser.NoSectionError, configparser.NoOptionError):
            return False

    def set(self, section: str, key: str, value) -> None:
        if not self._p.has_section(section):
            self._p.add_section(section)
        self._p.set(section, key, str(value))

    def pixel_mean(self) -> Tuple[float, ...]:
        return tuple(float(p) for p in self.get("MODEL", "PIXEL_MEAN").split(","))

    def pixel_std(self) -> Tuple[float, ...]:
        return tuple(float(p) for p in self.get("MODEL", "PIXEL_STD").split(","))

    def n_frames(self) -> int:
        return self.getint("TRAIN", "N_FRAMES")

    def model_spec(self) -> "ModelSpec":
        return ModelSpec(
            stage1_bottleneck=self.get("STAGE1", "BOTTLENECK").upper(),
            stage2_bottleneck=self.get("STAGE2", "BOTTLENECK").upper(),
            cross_skip=self.getboolean("STAGE2", "CROSS_SKIP"),
            n_frames=self.n_frames(),
            stage1_freeze=self.getboolean("STAGE1", "FREEZE"),
            stage2_freeze=self.getboolean("STAGE2", "FREEZE"),
            compute_dtype=self.get("TPU", "COMPUTE_DTYPE").strip().lower(),
            clstm_merge=self.get("TPU", "CLSTM_MERGE").upper(),
            clstm_gate_order=self.get("TPU", "CLSTM_GATE_ORDER").upper(),
            remat=self.getboolean("TPU", "REMAT"),
        )

    def validate(self) -> None:
        """Fail-fast schema validation."""
        spec = self.model_spec()
        if spec.stage1_bottleneck not in VALID_BOTTLENECKS:
            raise ValueError(f"STAGE1 BOTTLENECK must be one of {VALID_BOTTLENECKS}")
        if spec.stage2_bottleneck not in VALID_BOTTLENECKS:
            raise ValueError(f"STAGE2 BOTTLENECK must be one of {VALID_BOTTLENECKS}")
        if spec.n_frames not in REQD_IMAGES:
            raise ValueError(f"N_FRAMES must be one of {sorted(REQD_IMAGES)}")
        if spec.compute_dtype not in VALID_COMPUTE_DTYPES:
            raise ValueError(f"[TPU] COMPUTE_DTYPE must be one of {VALID_COMPUTE_DTYPES}")
        if spec.clstm_merge not in VALID_CLSTM_MERGES:
            raise ValueError(f"[TPU] CLSTM_MERGE must be one of {VALID_CLSTM_MERGES}")
        for bottleneck in {spec.stage1_bottleneck, spec.stage2_bottleneck} - {"CONV"}:
            cell_gate_order(bottleneck, spec.clstm_gate_order)
        if self.get("DATA", "DATASET").upper() not in VALID_DATASETS:
            raise ValueError(f"DATASET must be one of {VALID_DATASETS}")
        t_sample = self.get("DATALOADER", "T_SAMPLE").upper()
        if t_sample not in VALID_T_SAMPLE:
            raise ValueError(f"T_SAMPLE must be one of {VALID_T_SAMPLE}")
        if self.getboolean("EVAL", "EVAL_MODE") != (t_sample == "NIL"):
            raise ValueError("EVAL_MODE requires T_SAMPLE=NIL (and vice versa)")
        if self.get("STAGE1", "ENCODER").upper() != "UNET":
            raise NotImplementedError("Only the UNET encoder is implemented")
        # TPU layout keys: parsed so a malformed value fails, then ignored
        if self.get("TPU", "USE_PALLAS_WARP").strip().upper() not in ("AUTO", "TRUE", "FALSE"):
            raise ValueError("[TPU] USE_PALLAS_WARP must be AUTO/TRUE/FALSE")
        self.getboolean("TPU", "LAYOUT_V2")
        for key in ("LV2_ASSEMBLY", "LV2_SPLIT_DECODER", "LV2_FENCE"):
            if self.get("TPU", key).strip().upper() != "AUTO":
                self.getboolean("TPU", key)


def cell_gate_order(bottleneck: str, gate_order: str) -> str:
    """The gate blocks of a ``bottleneck`` cell's gate conv, in lower case,
    from ``[TPU] CLSTM_GATE_ORDER`` in any case: a permutation of ifog for
    CLSTM; for CGRU a permutation of zr, where ifog, the CLSTM default, means
    zr. Raises ValueError, naming the key, for anything else."""
    order = gate_order.lower()
    if bottleneck == "CGRU" and order == "ifog":
        order = "zr"
    if sorted(order) != sorted("ifog" if bottleneck == "CLSTM" else "zr"):
        raise ValueError(
            f"[TPU] CLSTM_GATE_ORDER={gate_order} is no gate order of a {bottleneck} cell: "
            "a permutation of IFOG (CLSTM), or of ZR or the default IFOG (CGRU)")
    return order


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Model hyperparameters: each stage's bottleneck (CONV, or the recurrent
    CLSTM / CGRU of SuperSloMo-R with its ``clstm_merge`` and
    ``clstm_gate_order`` layout), the cross-stage skip, the window length,
    the frozen stages, the compute dtype and whether the training step
    recomputes each U-Net stage's activations in its backward (``remat``)."""

    stage1_bottleneck: str = "CONV"
    stage2_bottleneck: str = "CONV"
    cross_skip: bool = True
    n_frames: int = 2
    stage1_freeze: bool = False
    stage2_freeze: bool = False
    compute_dtype: str = "float32"
    clstm_merge: str = "CONCAT"  # CONCAT (hidden/2 a direction, concatenated) | SUM (hidden a direction, summed)
    clstm_gate_order: str = "IFOG"  # gate blocks of the fused gate conv (models/bottleneck.py)
    remat: bool = False  # torch.utils.checkpoint on each U-Net stage under autograd ([TPU] REMAT)


def load_config(path: str) -> Config:
    parser = configparser.RawConfigParser()
    if not parser.read(path):
        raise FileNotFoundError(f"Config file not found: {path}")
    return Config(parser)


def default_config(**overrides) -> Config:
    """In-memory config with all defaults; overrides as SECTION_KEY=value,
    e.g. TRAIN_N_FRAMES=4 → [TRAIN] N_FRAMES = 4."""
    cfg = Config()
    for (section, key), value in _DEFAULTS.items():
        cfg.set(section, key, value)
    for skey, value in overrides.items():
        section, _, key = skey.partition("_")
        cfg.set(section, key, value)
    return cfg
