"""Typed configuration tree + CLI binding for the port's entry points.

A copy of the parts of ``video_r2_tpu/config.py`` that the port's entry
points read (that module imports the JAX package's trainers): `RunConfig`'s
run, mesh, training-loop and weight_quant fields, `EvalConfig`, `AppConfig`
over the run / eval / data / optim / sft / grpo / lora sections,
`parse_config` (``--config file.json`` plus ``--section.field value``) and
`resolve_attn_impl`, whose "auto" picks the flash kernels on a CUDA device as
the JAX one picks them on the TPU. tests/test_torch_host.py and
tests/test_torch_eval.py hold the copied fields equal to the originals.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, get_args, get_origin

import torch

from .data.config import DataConfig
from .models.config import (
    ModelConfig,
    qwen3_moe_30b_a3b,
    qwen25vl_3b,
    qwen25vl_7b,
    qwen25vl_72b,
    tiny_test_config,
)
from .models.qwen3_next import Qwen3NextConfig, qwen3_next_80b_a3b
from .train.grpo import GRPOConfig
from .train.lora import LoRAConfig
from .train.optim import OptimConfig
from .train.sft import SFTConfig

MODEL_PRESETS = {
    "qwen25vl-7b": qwen25vl_7b,
    "qwen25vl-3b": qwen25vl_3b,
    "qwen25vl-72b": qwen25vl_72b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,   # judge-class MoE (text only)
    # the reference's own judge (serve_qwen3.sh:11): the hybrid DeltaNet
    # family, models/qwen3_next.py
    "qwen3-next-80b-a3b": qwen3_next_80b_a3b,
    "tiny-test": tiny_test_config,
}


@dataclass(frozen=True)
class RunConfig:
    """Run options of the training entry point."""

    model_preset: str = "qwen25vl-7b"
    checkpoint: str = ""              # HF checkpoint dir to load weights from
    tokenizer: str = ""               # tokenizer path/name ('' = byte fallback)
    output_dir: str = "output"
    seed: int = 0
    dtype: str = "bfloat16"
    # mesh: CLI-parity fields only (the JAX --run.dp .. --run.tp flags); their
    # one reader, apps/common.py::build_mesh, raises past one device until
    # the parallelism port gives them a real one (ROADMAP Queue 1 #8)
    dp: int = 1
    pp: int = 1
    fsdp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1
    # training loop
    max_steps: int = 1000
    save_steps: int = 500
    save_total_limit: int = 2
    log_steps: int = 10
    resume: bool = True
    use_lora: bool = False
    attn_impl: str = "auto"           # auto -> flash on a CUDA device, xla elsewhere
    weight_quant: str = ""            # "int8" / "int4": weight-only quantized
                                      # params (apps/common.py::build_model)


@dataclass(frozen=True)
class EvalConfig:
    """Eval-harness backend options (the reference's --model_args string,
    run_all.sh:31, as first-class flags)."""

    max_num_frames: int = 128         # FPS_MAX_FRAMES
    max_pixels: int = 151200
    min_pixels: int = 100352
    fps: float = 0.0                  # 0 = qwen_vl_utils default sampling
    batch_size: int = 8
    system_prompt: str = "You are a helpful assistant."
    engine_mode: str = "batch"        # "batch" | "paged" (continuous)
    engine_max_len: int = 0           # 0 = size from the longest prompt
    act_quant: str = ""               # "int8": W8A8 prefill
    kv_quant: str = ""                # "int8": int8 KV cache
    vit_act_quant: str = ""           # "int8": W8A8 ViT (activation shift)
    window_divisible: bool = False    # ViT-window resize bucketing
    patch_dtype: str = "float32"      # "float16": half the patch transfer
    decode_steps: int = 8             # paged: tokens per decode dispatch
    spec_decode: int = 0              # K-draft speculative decoding (batch and
                                      # paged; greedy: plain greedy's answers)


@dataclass(frozen=True)
class AppConfig:
    run: RunConfig = field(default_factory=RunConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    sft: SFTConfig = field(default_factory=SFTConfig)
    grpo: GRPOConfig = field(default_factory=GRPOConfig)
    lora: LoRAConfig = field(default_factory=LoRAConfig)

    def model_config(self) -> ModelConfig | Qwen3NextConfig:
        """The preset's config (a ModelConfig, or a Qwen3NextConfig for the
        Next family) in run.dtype."""
        return dataclasses.replace(MODEL_PRESETS[self.run.model_preset](),
                                   dtype=self.run.dtype)


def _coerce(value: str, typ) -> Any:
    if get_origin(typ) is not None:
        args = [a for a in get_args(typ) if a is not type(None)]
        if args:
            typ = args[0]
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ in (int, float, str):
        return typ(value)
    if get_origin(typ) in (tuple, list) or typ in (tuple, list):
        items = [v for v in value.split(",") if v != ""]
        inner = get_args(typ)[0] if get_args(typ) else str
        if inner is Ellipsis:
            inner = str
        return tuple(_coerce(i, inner) for i in items)
    return value


def _apply_overrides(cfg, overrides: dict[str, str]):
    """{'section.field': 'value'} applied over the frozen dataclass tree."""
    by_section: dict[str, dict[str, Any]] = {}
    for key, val in overrides.items():
        if "." not in key:
            raise ValueError(f"override {key!r} must be section.field")
        section, fname = key.split(".", 1)
        by_section.setdefault(section, {})[fname] = val

    updates = {}
    for section, kv in by_section.items():
        sub = getattr(cfg, section)
        ftypes = {f.name: f.type for f in dataclasses.fields(sub)}
        coerced = {}
        for fname, val in kv.items():
            if fname not in ftypes:
                raise ValueError(f"unknown field {section}.{fname}")
            typ = ftypes[fname]
            if isinstance(typ, str):
                import typing

                typ = eval(typ, {**vars(typing), "int": int, "float": float,
                                 "str": str, "bool": bool, "tuple": tuple})
            coerced[fname] = _coerce(val, typ) if isinstance(val, str) else val
        updates[section] = dataclasses.replace(sub, **coerced)
    return dataclasses.replace(cfg, **updates)


def parse_config(argv: list[str] | None = None) -> AppConfig:
    """--config file.json plus --section.field value / --section.field=value."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = AppConfig()
    overrides: dict[str, str] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--config":
            with open(argv[i + 1]) as f:
                data = json.load(f)
            for section, kv in data.items():
                for k, v in kv.items():
                    overrides[f"{section}.{k}"] = v
            i += 2
        elif arg.startswith("--"):
            key = arg[2:]
            if "=" in key:
                key, val = key.split("=", 1)
                i += 1
            else:
                val = argv[i + 1]
                i += 2
            overrides[key] = val
        else:
            raise ValueError(f"unexpected argument {arg!r}")
    return _apply_overrides(cfg, overrides)


def resolve_attn_impl(run: RunConfig, device: torch.device) -> str:
    if run.attn_impl != "auto":
        return run.attn_impl
    return "flash" if torch.device(device).type == "cuda" else "xla"
