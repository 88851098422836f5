"""LoRA adapters on the port's Linear modules.

Port of ``video_r2_tpu/train/lora.py`` (the reference's shipped SFT recipe:
LoRA r=64, alpha=64 on every linear layer of the decoder, the base, the
tower, the merger, the embeddings and the LM head frozen). Adapters are fp32
parameters set on each targeted Linear in the JAX "attach" form
(models/layers.py): y = x @ W + (x @ A) @ (B * alpha / r), W never touched
and W + AB never formed. `merge_lora` folds them into a copy of the model
for serving. An adapter set is a dict {parameter name: tensor}, named as
``Module.named_parameters`` names the attached adapters
(``model.layers.0.attn.q.lora_a`` / ``.lora_b``). `init_lora_for_quantized`
shapes the adapters of an int8 base from its ``kernel_q`` (QLoRA), and
`make_lora_grpo_step` trains them under the GRPO loss, the reference policy
being the same module with its adapters removed (`adapters_disabled`).
"""

from __future__ import annotations

import copy
from contextlib import contextmanager
from dataclasses import dataclass

import torch
from torch import nn

from ..models.layers import Linear

# kernels eligible for adaptation: path suffixes, as in the JAX package
DEFAULT_TARGETS = (
    ("attn", "q", "kernel"), ("attn", "k", "kernel"), ("attn", "v", "kernel"),
    ("attn", "o", "kernel"),
    ("mlp", "gate", "kernel"), ("mlp", "up", "kernel"), ("mlp", "down", "kernel"),
    ("attn", "qkv", "kernel"), ("attn", "proj", "kernel"),
)


@dataclass(frozen=True)
class LoRAConfig:
    r: int = 64
    alpha: int = 64
    targets: tuple = DEFAULT_TARGETS
    include_vision: bool = False   # freeze_vision default in train_sft.sh
    include_merger: bool = False

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def _is_target(path: tuple[str, ...], cfg: LoRAConfig) -> bool:
    if path[0] == "visual":
        if "merger" in path and not cfg.include_merger:
            return False
        if "merger" not in path and not cfg.include_vision:
            return False
    return any(path[-len(t):] == t for t in cfg.targets)


def target_modules(model: nn.Module, cfg: LoRAConfig) -> dict[str, Linear]:
    """{module name: Linear} of every kernel the config adapts."""
    return {name: mod for name, mod in model.named_modules()
            if isinstance(mod, Linear)
            and _is_target(tuple(f"{name}.kernel".split(".")), cfg)}


def init_lora(model: nn.Module, cfg: LoRAConfig, seed: int = 0) -> dict[str, torch.Tensor]:
    """A ~ normal(0, 1/r) and B = 0 (the peft default) for each targeted
    kernel [in, out]: fp32 A [in, r], B [r, out] on the model's device."""
    return _init_adapters(model, {name: tuple(mod.kernel.shape) for name, mod
                                  in target_modules(model, cfg).items()}, cfg, seed)


def init_lora_for_quantized(model: nn.Module, cfg: LoRAConfig,
                            seed: int = 0) -> dict[str, torch.Tensor]:
    """init_lora over a quantized base (QLoRA): adapters for the targeted
    int8 linears only, shaped from their ``kernel_q`` [in, out]."""
    return _init_adapters(model, {name: tuple(mod.kernel_q.shape) for name, mod
                                  in target_modules(model, cfg).items()
                                  if mod.kernel_q is not None}, cfg, seed)


def _init_adapters(model: nn.Module, shapes: dict[str, tuple[int, int]], cfg: LoRAConfig,
                   seed: int) -> dict[str, torch.Tensor]:
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, (d_in, d_out) in shapes.items():
        out[f"{name}.lora_a"] = torch.empty(
            (d_in, cfg.r), dtype=torch.float32, device=device).normal_(
                0.0, 1.0 / cfg.r, generator=gen)
        out[f"{name}.lora_b"] = torch.zeros((cfg.r, d_out), dtype=torch.float32,
                                            device=device)
    return out


def attach_lora(model: nn.Module, lora: dict[str, torch.Tensor],
                cfg: LoRAConfig) -> dict[str, nn.Parameter]:
    """Set the adapters on their Linears (in place, replacing any attached
    before) as trainable parameters over the given tensors. Returns
    {name: parameter}, what an optimizer trains."""
    detach_lora(model)
    params = {}
    for name, value in lora.items():
        mod_name, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        if not isinstance(mod, Linear) or leaf not in ("lora_a", "lora_b"):
            raise KeyError(f"{name}: not an adapter of a Linear")
        setattr(mod, leaf, nn.Parameter(value, requires_grad=True))
        mod.lora_scale = cfg.scaling
        params[name] = getattr(mod, leaf)
    return params


def detach_lora(model: nn.Module) -> None:
    """Remove every attached adapter: the model computes its base again."""
    for mod in model.modules():
        if isinstance(mod, Linear):
            mod.lora_a = mod.lora_b = None
            mod.lora_scale = 1.0


@contextmanager
def adapters_disabled(model: nn.Module):
    """The base policy inside the `with`: every attached adapter is removed
    (detach_lora), and the same parameters are put back on exit. LoRA-GRPO's
    reference policy, as the JAX runner's ``ref_params = base``; no copy of
    the base is made."""
    saved = [(mod, mod.lora_a, mod.lora_b, mod.lora_scale) for mod in model.modules()
             if isinstance(mod, Linear) and mod.lora_a is not None]
    detach_lora(model)
    try:
        yield model
    finally:
        for mod, a, b, scale in saved:
            mod.lora_a, mod.lora_b, mod.lora_scale = a, b, scale


@torch.no_grad()
def merge_lora(model: nn.Module) -> nn.Module:
    """A frozen copy of `model` with every attached adapter folded in:
    W + (A @ B * scale) in W's dtype, adapters removed (servable by
    apps/demo.py::DemoRunner). The original keeps its adapters."""
    merged = copy.deepcopy(model)
    for mod in merged.modules():
        if isinstance(mod, Linear) and mod.lora_a is not None:
            delta = (mod.lora_a.float() @ mod.lora_b.float()) * mod.lora_scale
            mod.kernel.add_(delta.to(mod.kernel.dtype))
    detach_lora(merged)
    return merged.requires_grad_(False)


def lora_param_count(lora: dict[str, torch.Tensor]) -> int:
    return sum(x.numel() for x in lora.values())


def make_lora_grpo_step(model: nn.Module, grpo_cfg, video_layout=None,
                        attn_impl: str = "xla"):
    """The GRPO step where only the attached adapters train, over a dense or
    an int8 (QLoRA) base: step(state, batch) -> (state, metrics). The base's
    parameters never require gradients, so no base gradient is formed; an
    int8 linear under adapters takes convert + matmul while a gradient is
    needed (ops/int8_matmul.py::quantized_linear_auto). MoE blocks keep the
    config's path, as the reference's LoRA step does. The reference policy
    is `adapters_disabled(model)` (train/grpo_runner.py)."""
    from .grpo import _make_grpo_step

    if not any(n.endswith(".lora_a") for n, _ in model.named_parameters()):
        raise ValueError("no adapters attached (train/lora.py::attach_lora)")
    trains = [n for n, p in model.named_parameters()
              if p.requires_grad and not n.endswith((".lora_a", ".lora_b"))]
    if trains:
        raise ValueError(f"base parameters require grad: {trains[:3]}...")
    return _make_grpo_step(model, grpo_cfg, video_layout, attn_impl, moe_einsum=False)
