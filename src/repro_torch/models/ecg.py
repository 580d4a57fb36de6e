"""The paper's ECG A-fib classifier (Fig. 6) on the analog backend (port
of ``repro.models.ecg``).

- conv layer: 64 taps x 2 channels = 128 signed rows, replicated 32 times
  across columns -> 32 positions x 8 output channels; implemented as
  im2col + one analog matmul (weight replicas = tile columns).
- fc1: 256 -> 123, two 128-row chunks evaluated side by side.
- fc2: 123 -> 10, followed by average pooling of 5 neurons per class.
- ReLUs happen at the ADC followed by the 5-bit right-shift
  requantization (the ``relu_shift`` chain).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.analog import analog_linear_init
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.energy import LayerWork
from repro_torch.core.noise import NoiseConfig


@dataclasses.dataclass(frozen=True)
class ECGConfig:
    in_channels: int = 2
    in_len: int = 126          # preprocessed samples (4033 raw / 32-pool)
    conv_taps: int = 64
    conv_stride: int = 2
    conv_channels: int = 8
    hidden: int = 123
    classes: int = 2
    class_copies: int = 5      # 10 output neurons -> 2 classes
    # the FULL per-synapse fixed-pattern map, requested explicitly
    noise: NoiseConfig = dataclasses.field(
        default_factory=lambda: NoiseConfig(mode="full")
    )

    @property
    def conv_positions(self) -> int:
        return (self.in_len - self.conv_taps) // self.conv_stride + 1

    @property
    def conv_cols(self) -> int:
        return self.conv_positions * self.conv_channels

    def layer_works(self) -> list[LayerWork]:
        """The three layers' (K, N) for the energy model."""
        return [
            LayerWork(k=self.conv_taps * self.in_channels, n=self.conv_cols),
            LayerWork(k=self.conv_cols, n=self.hidden),
            LayerWork(k=self.hidden, n=self.classes * self.class_copies),
        ]


def ecg_init(generator: torch.Generator, cfg: ECGConfig = ECGConfig(), *,
             device: DeviceLike = None) -> dict:
    """Random master weights and fixed pattern of the three layers, drawn
    from ``generator`` and placed on ``device`` (``None`` = CUDA)."""
    dev = resolve_device(device)
    nz = cfg.noise
    return {
        "conv": analog_linear_init(
            generator, cfg.conv_taps * cfg.in_channels, cfg.conv_channels,
            noise=nz, device=dev,
        ),
        "fc1": analog_linear_init(generator, cfg.conv_cols, cfg.hidden,
                                  noise=nz, device=dev),
        "fc2": analog_linear_init(
            generator, cfg.hidden, cfg.classes * cfg.class_copies,
            noise=nz, device=dev,
        ),
    }


def _im2col(x: torch.Tensor, taps: int, stride: int) -> torch.Tensor:
    """x: [B, C, T] -> [B, positions, taps * C], feature index
    ``tap * C + c`` (the reference's layout; ``F.unfold`` would give
    ``c * taps + tap``)."""
    b, c, _ = x.shape
    cols = x.unfold(2, taps, stride)         # [B, C, npos, taps] view
    return cols.permute(0, 2, 3, 1).reshape(b, cols.shape[2], taps * c)


def _pool_class_copies(out: torch.Tensor, cfg: ECGConfig,
                       train: bool) -> torch.Tensor:
    """§III-B: max pooling over the class-copy neurons during training;
    average pooling at inference (noise averaging).  The average is a
    left-to-right sum times the reciprocal of the copy count: the
    reference's mean as XLA compiles it, to the last bit."""
    out = out.reshape(out.shape[0], cfg.classes, cfg.class_copies)
    if train:
        return out.amax(dim=-1)
    total = out[..., 0]
    for i in range(1, cfg.class_copies):
        total = total + out[..., i]
    return total * (1.0 / cfg.class_copies)


def ecg_module_spec(cfg: ECGConfig = ECGConfig(), *,
                    epilogue: str = "none"):
    """Declare the Fig.-6 CDNN for the front door: a stack spec whose
    compiled form runs conv->fc1->fc2 as one analog program.

    ``epilogue="relu_shift"`` is the hardware chain of paper §II-A (ReLU
    at the ADC + right-shift requantization to 5-bit codes, input domain
    "codes"): the whole stack runs in the code domain and is
    megakernel-eligible.  ``"none"`` is the float-glue chain (dequantize,
    ReLU, re-quantize at the next layer), input domain "float".
    """
    from repro_torch import api

    def _apply(model, x, *, train: bool = False, noise=None,
               megakernel="auto"):
        cols = _im2col(x, cfg.conv_taps, cfg.conv_stride)
        out = model.run_stack(cols, noise=noise, megakernel=megakernel)
        return _pool_class_copies(out, cfg, train)

    return api.ModuleSpec(
        name="ecg_cdnn",
        kind="stack",
        apply_fn=_apply,
        input_domain="codes" if epilogue == "relu_shift" else "float",
        layers=(
            api.LayerSpec("conv", cfg.conv_taps * cfg.in_channels,
                          cfg.conv_channels, signed_input="none",
                          epilogue=epilogue, flatten_out=True),
            api.LayerSpec("fc1", cfg.conv_cols, cfg.hidden,
                          signed_input="none", epilogue=epilogue),
            api.LayerSpec("fc2", cfg.hidden,
                          cfg.classes * cfg.class_copies,
                          signed_input="none"),
        ),
    )


def ecg_apply_plan(plan, x: torch.Tensor,
                   cfg: ECGConfig = ECGConfig()) -> torch.Tensor:
    """Run a lowered ECG plan: x [B, C, T] codes -> inference logits [B,
    classes] (average pooling).  Lower once per weight update, replay for
    every batch - the eval hot path."""
    from repro_torch.exec.run import run as run_plan

    cols = _im2col(x, cfg.conv_taps, cfg.conv_stride)
    return _pool_class_copies(run_plan(plan, cols), cfg, False)


def ecg_apply(params: dict, x: torch.Tensor, acfg,
              cfg: ECGConfig = ECGConfig(), *, train: bool = False,
              noise=None, epilogue: str = "none") -> torch.Tensor:
    """x: [B, C, T] preprocessed 5-bit activations (integer-valued float)
    -> logits [B, classes], on ``x``'s device.

    Compiles through the front door on every call: hardware-in-the-loop
    training re-lowers inside every differentiated step, so the gradient
    reaches the float masters (inference call sites compile once and
    replay ``CompiledModel.apply``).  ``noise`` is the readout noise
    (:func:`repro_torch.exec.run.run`); ``epilogue`` selects the chain
    (:func:`ecg_module_spec`)."""
    from repro_torch import api

    model = api.compile(ecg_module_spec(cfg, epilogue=epilogue), params,
                        acfg, device=x.device)
    return model.apply(x, train=train, noise=noise)


def ecg_loss(params: dict, x: torch.Tensor, labels: torch.Tensor, acfg,
             cfg: ECGConfig = ECGConfig(), noise=None, *,
             epilogue: str = "none"):
    """Mean negative log-likelihood of the training-mode logits (max
    pooling over the class copies) and the batch accuracy:
    ``(nll, {"acc": acc})``."""
    logits = ecg_apply(params, x, acfg, cfg, train=True, noise=noise,
                       epilogue=epilogue)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return nll, {"acc": acc}
