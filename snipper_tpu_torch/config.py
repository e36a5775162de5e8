"""Single dataclass configuration consumed by every entry point.

The port's own copy of the JAX package's ``Config``: the same fields, the
same defaults, the same presets and the same ``validate``, so that one
command line means the same model in both packages.

Four fields steer the TPU sampling formulations and are accepted here but
ignored: ``deform_impl``, ``sampling_margin``, ``sampling_block_h/w`` and
``remat_policy``. The port's deformable sampling is one exact gather
kernel (``ops/csrc/msda_forward.cu``), with no window that could overflow,
no alternative formulation to choose, and no rematerialization to tune.
The one exception is ``deform_impl="skip"``, JAX's profiling stand-in: the
model then takes the mean of the value over its tokens in place of the
sampling, as the JAX model does (not exact; the probe's ``split`` times
the forward without the sampling with it). They stay so that presets,
command lines and ``validate`` match the JAX package's.

``deform_dtype`` is honoured as JAX honours it
(``models/transformer.py::TemporalDeformAttn``): ``"float32"`` casts the
value, the sampling locations and the attention logits to f32 before the
sampling, so that under bf16 the neighbour-frame sum, the softmax, the
division by the frame count and the sampling run in f32 (the f32-value
kernels on the card), and casts the output back to the activations'
dtype; ``"auto"`` samples in the activations' dtype.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Config:
    # --- snippet geometry -------------------------------------------------
    num_frames: int = 4            # T observed frames
    num_future_frames: int = 2     # T_f forecast frames
    seq_max_gap: int = 4
    seq_min_gap: int = 4
    input_height: int = 600
    input_width: int = 800
    max_depth: float = 15.0        # metres; -1 disables depth losses

    # --- backbone ---------------------------------------------------------
    backbone: str = "resnet50"
    dilation: bool = False
    num_feature_levels: int = 3    # 3 backbone taps; >3 adds stride-2 extras

    # --- transformer ------------------------------------------------------
    hidden_dim: int = 192
    nheads: int = 8
    enc_layers: int = 1
    dec_layers: int = 2
    dim_feedforward: int = 1024
    dropout: float = 0.1
    num_queries: int = 60
    num_kpts: int = 15
    enc_n_points: int = 4
    dec_n_points: int = 4
    aux_loss: bool = True

    # --- deformable attention (TPU formulations, ignored by the port but
    # deform_impl="skip"; deform_dtype is honoured) -------------------------
    deform_impl: str = "xla"
    deform_dtype: str = "auto"
    sampling_margin: int = 5
    sampling_block_h: int = 8
    sampling_block_w: int = 20
    remat_policy: str = "save_sampling"

    # --- matcher costs (reference main.py:110-121) -------------------------
    set_cost_is_human: float = 1.0
    set_cost_root: float = 1.0
    set_cost_root_depth: float = 1.0
    set_cost_root_vis: float = 0.1
    set_cost_joint: float = 1.0
    set_cost_joint_depth: float = 1.0
    set_cost_joint_vis: float = 0.1

    # --- loss coefficients (reference main.py:129-148) ---------------------
    is_human_loss_coef: float = 1.0
    root_loss_coef: float = 1.0
    root_depth_loss_coef: float = 1.0
    root_vis_loss_coef: float = 0.1
    joint_loss_coef: float = 1.0
    joint_depth_loss_coef: float = 1.0
    joint_vis_loss_coef: float = 1.0
    joint_disp_loss_coef: float = 1.0
    joint_disp_depth_loss_coef: float = 1.0
    cont_loss_coef: float = 0.1
    heatmap_loss_coef: float = 0.01
    eos_coef: float = 0.5

    # --- optimization (reference main.py:22-32, 201-222) -------------------
    lr: float = 1e-4
    lr_backbone: float = 1e-5
    lr_linear_proj_mult: float = 0.1
    batch_size: int = 2            # per device
    grad_accum_steps: int = 1
    weight_decay: float = 1e-4
    epochs: int = 40
    lr_drop: int = 30
    clip_max_norm: float = 0.1
    seed: int = 42

    # --- padded target shapes ----------------------------------------------
    max_persons: int = 32

    # --- parallelism -------------------------------------------------------
    dp_size: int = -1              # -1: all remaining devices
    tp_size: int = 1               # model/tensor axis (heads + ffn sharding)

    # --- misc --------------------------------------------------------------
    dtype: str = "float32"         # activation dtype: float32 | bfloat16

    # ------------------------------------------------------------------ api
    @property
    def total_frames(self) -> int:
        return self.num_frames + self.num_future_frames

    @property
    def input_shape(self) -> Tuple[int, int]:
        return (self.input_height, self.input_width)

    @property
    def depth_enabled(self) -> bool:
        return self.max_depth > 0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "Config":
        """Fail fast with readable messages instead of mid-forward shape
        errors."""
        problems = []
        if self.nheads < 1:
            problems.append(f"nheads must be >= 1 (got {self.nheads})")
        elif self.hidden_dim % self.nheads:
            problems.append(f"hidden_dim {self.hidden_dim} must be divisible"
                            f" by nheads {self.nheads}")
        if self.hidden_dim < self.nheads * self.num_kpts:
            problems.append(
                f"hidden_dim {self.hidden_dim} < nheads*num_kpts "
                f"{self.nheads * self.num_kpts}: the encoder heatmap taps "
                f"need num_kpts channels per head "
                f"(models/transformer.py heatmap extraction)")
        if self.num_frames < 1:
            problems.append(f"num_frames must be >= 1 (got {self.num_frames})")
        if self.max_persons > self.num_queries:
            problems.append(
                f"max_persons {self.max_persons} > num_queries "
                f"{self.num_queries}: the Hungarian assignment needs one "
                f"query per padded target slot")
        if self.num_future_frames < 0:
            problems.append("num_future_frames must be >= 0")
        if self.num_feature_levels < 3:
            problems.append("num_feature_levels must be >= 3 (3 backbone "
                            "taps; >3 adds stride-2 extras)")
        if not 0 < self.seq_min_gap <= self.seq_max_gap:
            problems.append(f"need 0 < seq_min_gap <= seq_max_gap "
                            f"(got {self.seq_min_gap}, {self.seq_max_gap})")
        if self.deform_impl not in ("xla", "pmerged", "windowed",
                                    "windowed2d", "windowed_hybrid",
                                    "windowed_vjp", "pallas", "skip"):
            problems.append(f"unknown deform_impl {self.deform_impl!r}")
        if self.deform_dtype not in ("auto", "float32"):
            problems.append(f"unknown deform_dtype {self.deform_dtype!r}")
        if self.dtype not in ("float32", "bfloat16"):
            problems.append(f"unknown dtype {self.dtype!r}")
        if self.sampling_margin < 1:
            problems.append("sampling_margin must be >= 1 (must cover "
                            "max |learned offset| + 1)")
        if self.tp_size < 1:
            problems.append(f"tp_size must be >= 1 (got {self.tp_size}; "
                            f"only dp_size supports -1 = all remaining "
                            f"devices)")
        elif self.nheads >= 1 and self.nheads % self.tp_size:
            problems.append(f"nheads {self.nheads} must be divisible by "
                            f"tp_size {self.tp_size}")
        if self.grad_accum_steps < 1:
            problems.append(f"grad_accum_steps must be >= 1 "
                            f"(got {self.grad_accum_steps})")
        if self.dp_size != -1 and self.dp_size < 1:
            problems.append(f"dp_size must be >= 1 or -1 = all remaining "
                            f"devices (got {self.dp_size})")
        if problems:
            raise ValueError("invalid config:\n  - " + "\n  - ".join(problems))
        return self

    # ------------------------------------------------------------- presets
    @staticmethod
    def canonical_t4() -> "Config":
        """T=4 tracking config of the shipped checkpoints
        (reference README.md:43-57: enc=6/dec=6, hidden=384)."""
        return Config(num_frames=4, num_future_frames=0, hidden_dim=384,
                      enc_layers=6, dec_layers=6)

    @staticmethod
    def canonical_t4_f2() -> "Config":
        """T=4+2 forecasting config (reference README.md:30-37)."""
        return Config(num_frames=4, num_future_frames=2, hidden_dim=384,
                      enc_layers=6, dec_layers=6)

    @staticmethod
    def canonical_t1() -> "Config":
        """T=1 single-frame config."""
        return Config(num_frames=1, num_future_frames=0, hidden_dim=384,
                      enc_layers=6, dec_layers=6, seq_min_gap=1)

    @staticmethod
    def light_t4_f2() -> "Config":
        """enc=2/dec=4 light variant of the shipped checkpoints."""
        return Config(num_frames=4, num_future_frames=2, hidden_dim=384,
                      enc_layers=2, dec_layers=4)

    @staticmethod
    def light_t4() -> "Config":
        """enc=2/dec=4, T=4 tracking."""
        return Config(num_frames=4, num_future_frames=0, hidden_dim=384,
                      enc_layers=2, dec_layers=4)

    @staticmethod
    def light_t1() -> "Config":
        """enc=2/dec=4, T=1 single-frame."""
        return Config(num_frames=1, num_future_frames=0, hidden_dim=384,
                      enc_layers=2, dec_layers=4, seq_min_gap=1)

    @staticmethod
    def jta_forecast() -> "Config":
        """JTA forecasting recipe (reference README.md:129-187)."""
        return Config(num_frames=4, num_future_frames=2, hidden_dim=384,
                      enc_layers=6, dec_layers=6, input_height=540,
                      input_width=960, max_depth=60.0, epochs=100, lr_drop=90)

    @staticmethod
    def panoptic() -> "Config":
        """CMU-Panoptic recipe (reference README.md:192-250)."""
        return Config(num_frames=4, num_future_frames=2, hidden_dim=384,
                      enc_layers=6, dec_layers=6, input_height=540,
                      input_width=960, max_depth=5.0, num_queries=20,
                      max_persons=20,
                      epochs=10, lr_drop=8, seq_min_gap=10, seq_max_gap=10)

    @staticmethod
    def tiny() -> "Config":
        """Small config for unit tests / CPU runs."""
        return Config(num_frames=2, num_future_frames=1, hidden_dim=96,
                      enc_layers=1, dec_layers=2, dim_feedforward=128,
                      num_queries=8, input_height=64, input_width=96,
                      max_persons=4, nheads=4, batch_size=1,
                      backbone="resnet_test")


# preset registry for CLI lookup/error messages; the presets are Config's
# only staticmethods
PRESETS = tuple(name for name, member in vars(Config).items()
                if isinstance(member, staticmethod)
                and not name.startswith("_"))
