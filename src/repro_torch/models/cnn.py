"""The paper's four CNNs - AlexNet, VGG-19, ResNet-18, YOLOv2 (Darknet-19
backbone) - on the protected convolution (twin of repro.models.cnn).

Params are nested dicts of tensors in the JAX package's layouts: conv
weights OIHW, activations NCHW, the fc weight (K, M). Configs scale by
width so tests run reduced models with every layer's shape ratio kept.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, fp32_ieee, resolve_device
from ..core import (DEFAULT_CONFIG, ModelReport, ProtectConfig,
                    ProtectedModel, ProtectionPlan, conv_entry, protect_site,
                    resolve_entry)
from ..core.checksums import conv2d
from ..core.plan import ambient_plan

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    out_ch: int
    kernel: int
    stride: int = 1
    pad: int = 0
    pool: int = 0          # maxpool after conv (kernel=stride=pool)
    residual_from: int = -1  # resnet shortcut source (layer idx)


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    convs: Tuple[ConvSpec, ...]
    in_ch: int = 3
    img: int = 224
    num_classes: int = 1000
    width_scale: float = 1.0
    abft: bool = True

    def scaled(self, c: int) -> int:
        return max(int(round(c * self.width_scale)), 4)


def alexnet(scale: float = 1.0) -> CNNConfig:
    return CNNConfig("alexnet", (
        ConvSpec(96, 11, 4, 2, pool=2), ConvSpec(256, 5, 1, 2, pool=2),
        ConvSpec(384, 3, 1, 1), ConvSpec(384, 3, 1, 1),
        ConvSpec(256, 3, 1, 1, pool=2)), width_scale=scale)


def vgg19(scale: float = 1.0) -> CNNConfig:
    spec: List[ConvSpec] = []
    for ch, reps in ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4)):
        for i in range(reps):
            spec.append(ConvSpec(ch, 3, 1, 1, pool=2 if i == reps - 1 else 0))
    return CNNConfig("vgg19", tuple(spec), width_scale=scale)


def resnet18(scale: float = 1.0) -> CNNConfig:
    spec: List[ConvSpec] = [ConvSpec(64, 7, 2, 3, pool=2)]
    for stage_i, ch in enumerate((64, 128, 256, 512)):
        for block in range(2):
            stride = 2 if (stage_i > 0 and block == 0) else 1
            spec.append(ConvSpec(ch, 3, stride, 1))
            # identity shortcut only where it is shape-valid (this plain
            # conv stack models no projection shortcut)
            spec.append(ConvSpec(ch, 3, 1, 1,
                                 residual_from=len(spec) - 2
                                 if stride == 1 else -1))
    return CNNConfig("resnet18", tuple(spec), width_scale=scale)


def yolov2(scale: float = 1.0) -> CNNConfig:
    """Darknet-19 backbone (YOLOv2's conv layers)."""
    spec = [ConvSpec(32, 3, 1, 1, pool=2), ConvSpec(64, 3, 1, 1, pool=2),
            ConvSpec(128, 3, 1, 1), ConvSpec(64, 1), ConvSpec(128, 3, 1, 1, pool=2),
            ConvSpec(256, 3, 1, 1), ConvSpec(128, 1), ConvSpec(256, 3, 1, 1, pool=2),
            ConvSpec(512, 3, 1, 1), ConvSpec(256, 1), ConvSpec(512, 3, 1, 1),
            ConvSpec(256, 1), ConvSpec(512, 3, 1, 1, pool=2),
            ConvSpec(1024, 3, 1, 1), ConvSpec(512, 1), ConvSpec(1024, 3, 1, 1),
            ConvSpec(512, 1), ConvSpec(1024, 3, 1, 1)]
    return CNNConfig("yolov2", tuple(spec), img=416, width_scale=scale)


CNN_REGISTRY = {"alexnet": alexnet, "vgg19": vgg19, "resnet18": resnet18,
                "yolov2": yolov2}


# --------------------------------------------------------------------------

def init_cnn(cfg: CNNConfig, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None, dtype=F32) -> Dict:
    """He-initialised params. The values are drawn on the CPU from
    `generator` (a CPU torch.Generator; seed 0 when None) and then moved,
    so one seed gives the same params on every device."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params: Dict[str, Any] = {}
    ch = cfg.in_ch
    for i, spec in enumerate(cfg.convs):
        out = cfg.scaled(spec.out_ch)
        fan_in = ch * spec.kernel ** 2
        w = torch.randn((out, ch, spec.kernel, spec.kernel),
                        generator=generator, dtype=F32) * (2.0 / fan_in) ** 0.5
        params[f"conv{i}"] = {"w": w.to(dev, dtype),
                              "b": torch.zeros((out,), dtype=dtype,
                                               device=dev)}
        ch = out
    w = torch.randn((ch, cfg.num_classes), generator=generator,
                    dtype=F32) * ch ** -0.5
    params["fc"] = {"w": w.to(dev, dtype),
                    "b": torch.zeros((cfg.num_classes,), dtype=dtype,
                                     device=dev)}
    return params


def params_from_numpy(np_params, device: DeviceLike = None) -> Dict:
    """Carry a nested dict of arrays (e.g. the JAX package's params,
    converted with np.asarray) across as tensors on `device`."""
    dev = resolve_device(device)
    if isinstance(np_params, dict):
        return {k: params_from_numpy(v, dev) for k, v in np_params.items()}
    return torch.as_tensor(np.array(np_params), device=dev)


def _maxpool(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=k, stride=k)


def _forward_pass(params: Dict, x: torch.Tensor, cfg: CNNConfig,
                  policies: Optional[Sequence[ProtectConfig]],
                  inject_layer: int, inject_o):
    """The layer walk behind both correction regimes: (logits, names,
    per-layer carries). Entries resolve from the ambient plan context."""
    names: List[str] = []
    carries: List[Any] = []
    feats = []
    for i, spec in enumerate(cfg.convs):
        name = f"conv{i}"
        entry = resolve_entry(name)
        if entry is None:
            if ambient_plan() is not None:
                raise KeyError(
                    f"forward_cnn: the active ProtectionPlan has no "
                    f"entry for {name!r}; rebuild the plan with "
                    "build_plan() or run without one")
            entry = conv_entry(
                name, cfg=(policies[i] if policies is not None else
                           (DEFAULT_CONFIG if cfg.abft else
                            DEFAULT_CONFIG.replace(enabled=False))),
                stride=spec.stride, pad=spec.pad)
        o = inject_o if i == inject_layer else None
        y, r = protect_site(name,
                            (x, params[name]["w"], params[name]["b"]),
                            entry=entry, o=o)
        names.append(name)
        carries.append(r)
        if spec.residual_from >= 0:
            short = feats[spec.residual_from]
            if short.shape != y.shape:
                raise ValueError(
                    f"forward_cnn: conv layer {i} declares a residual "
                    f"shortcut from layer {spec.residual_from}, but the "
                    f"shortcut shape {tuple(short.shape)} does not match "
                    f"the conv output shape {tuple(y.shape)}")
            y = y + short
        y = F.relu(y)
        if spec.pool:
            y = _maxpool(y, spec.pool)
        feats.append(y)
        x = y
    x = torch.mean(x, dim=(2, 3))                     # global average pool
    fc_entry = resolve_entry("fc")
    if fc_entry is not None:
        logits, r = protect_site("fc",
                                 (x, params["fc"]["w"], params["fc"]["b"]),
                                 entry=fc_entry)
        names.append("fc")
        carries.append(r)
    else:
        logits = x @ params["fc"]["w"] + params["fc"]["b"]
    return logits, names, carries


def _check_device(params: Dict, x: torch.Tensor, dev: torch.device) -> None:
    w = params["conv0"]["w"]
    for t, what in ((w, "params"), (x, "x")):
        if t.device.type != dev.type:
            raise ValueError(f"forward_cnn runs on {dev} but {what} lie on "
                             f"{t.device}")


def forward_cnn(params: Dict, x: torch.Tensor, cfg: CNNConfig,
                policies: Optional[Sequence[ProtectConfig]] = None,
                inject_layer: int = -1, inject_o=None, *,
                plan: Optional[ProtectionPlan] = None,
                correction: str = "per_layer",
                device: DeviceLike = None) -> Tuple[torch.Tensor, ModelReport]:
    """x: (N, C, H, W) -> (logits, per-layer ModelReport).

    `plan` is the offline ProtectionPlan (build_plan). Without one each
    conv derives its weight checksums per call under `policies[i]` or the
    default config. inject_layer/inject_o replace layer i's conv output
    with a corrupted tensor before protection (the paper's per-layer
    injection). `correction`: "per_layer" gates every op's ladder on its
    own flag (one host read per protected op); "deferred" runs the
    forward detect-only, reads every flag in one transfer, and reruns
    with correction only when one is set. The forward runs in IEEE fp32
    (TF32 off) on `device`: the card unless the caller asks for the CPU.
    """
    dev = resolve_device(device)
    _check_device(params, x, dev)

    def apply_fn(p, xx):
        logits, names, carries = _forward_pass(p, xx, cfg, policies,
                                               inject_layer, inject_o)
        return logits, ModelReport(dict(zip(names, carries)))

    with torch.no_grad(), fp32_ieee():
        return ProtectedModel(apply_fn, plan)(params, x,
                                              correction=correction)


def conv_output_at(params: Dict, x: torch.Tensor, cfg: CNNConfig,
                   layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(input_to_layer, clean_conv_output_of_layer) for injection tests:
    the conv output the clean forward computes at `layer`. Residual
    shortcuts are applied as forward_cnn applies them (the JAX package's
    conv_output_at skips them, so past a ResNet shortcut it returns an
    output the forward never computes)."""
    feats = []
    with torch.no_grad(), fp32_ieee():
        for i, spec in enumerate(cfg.convs):
            o = conv2d(x, params[f"conv{i}"]["w"], stride=spec.stride,
                       padding=[(spec.pad, spec.pad)] * 2)
            o = (o.to(F32) + params[f"conv{i}"]["b"][None, :, None, None]
                 ).to(o.dtype)
            if i == layer:
                return x, o
            if spec.residual_from >= 0:
                o = o + feats[spec.residual_from]
            y = F.relu(o)
            if spec.pool:
                y = _maxpool(y, spec.pool)
            feats.append(y)
            x = y
    raise ValueError(layer)
