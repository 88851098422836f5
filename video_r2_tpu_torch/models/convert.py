"""Carry a JAX parameter tree into the port's modules.

The JAX package stacks every per-layer leaf on a leading [L, ...] axis under
``visual/blocks`` and ``model/layers``; the port holds one module per layer.
`load_jax_params` takes ``jax.tree.map(np.asarray, params)`` (nested dicts of
numpy arrays, bf16 included) and copies it into a Qwen25VL, splitting the
stacked leaves, so both packages compute on the same weights in the tests.
`load_jax_lora` does the same for a JAX adapter tree (``train/lora.py``:
``{"a": [L, in, r], "b": [L, r, out]}`` under each adapted kernel) onto the
adapters attached to the port's modules, so both train the same adapters
(``init_lora_for_quantized``'s tree too: its adapters sit under the
``kernel`` of each adapted int8 linear, as the JAX function renames them).
The MoE leaves ([L, E, ...]) split on L only, and the leaves of a
quantized tree (8-bit {kernel_q, scale}, 4-bit {kernel_q4, scale4}) load
into a model quantized alike (models/quant.py), int8 copied as int8 and the
scales as fp32. `load_jax_next_params` carries the Qwen3-Next tree
(``models/qwen3_next.py``: leaves under ``groups/lin`` stacked [G, 3, ...],
under ``groups/full`` [G, ...]) into the port's Qwen3Next the same way, and
`load_jax_next_lora` its adapter tree (``{"a": [G, 3, in, r], "b":
[G, 3, r, out]}`` under each adapted ``lin`` kernel, [G, ...] under ``full``)
onto the port's per-layer adapters; `next_lora_tree` stacks the port's
adapters, or their gradients, back into that tree, so the tests compare
like with like.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

STACKED = ("blocks", "layers")


def flatten_jax_tree(tree: dict, prefix: tuple[str, ...] = ()) -> dict[str, np.ndarray]:
    """Nested numpy dicts -> {module state_dict name: array}."""
    out: dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = prefix + (key,)
        if isinstance(val, dict):
            out.update(flatten_jax_tree(val, path))
            continue
        stacked = [i for i, p in enumerate(path) if p in STACKED]
        if not stacked:
            out[".".join(path)] = np.asarray(val)
            continue
        cut = stacked[0] + 1
        for layer in range(val.shape[0]):
            name = path[:cut] + (str(layer),) + path[cut:]
            out[".".join(name)] = np.asarray(val[layer])
    return out


def flatten_next_tree(tree: dict) -> dict[str, np.ndarray]:
    """A Qwen3-Next tree -> {module state_dict name: array}: the [G, 3]
    DeltaNet leaves split into groups.{g}.lin.{s}, the [G] attention
    leaves into groups.{g}.full."""
    out: dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, val in node.items():
                walk(val, path + (key,))
            return
        arr = np.asarray(node)
        if path[:2] == ("groups", "lin"):
            for g in range(arr.shape[0]):
                for s in range(arr.shape[1]):
                    out[".".join(("groups", str(g), "lin", str(s)) + path[2:])] = arr[g, s]
        elif path[:2] == ("groups", "full"):
            for g in range(arr.shape[0]):
                out[".".join(("groups", str(g), "full") + path[2:])] = arr[g]
        else:
            out[".".join(path)] = arr

    walk(tree, ())
    return out


@torch.no_grad()
def load_jax_next_params(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a JAX Qwen3-Next tree (``jax.tree.map(np.asarray, params)``,
    int8 / int4 leaves included) into a Qwen3Next quantized alike; the rules
    of load_jax_params. Returns `module`."""
    return _copy_flat(module, flatten_next_tree(tree))


@torch.no_grad()
def load_jax_params(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a JAX params tree into `module` (names and shapes must match
    exactly; float values cast to each parameter's dtype, int8 copied as
    is). Returns `module`."""
    return _copy_flat(module, flatten_jax_tree(tree))


def _copy_flat(module: nn.Module, flat: dict[str, np.ndarray]) -> nn.Module:
    params = dict(module.named_parameters())
    missing, extra = params.keys() - flat.keys(), flat.keys() - params.keys()
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    for name, arr in flat.items():
        p = params[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
        if arr.dtype == np.int8:
            if p.dtype != torch.int8:
                raise TypeError(f"{name}: int8 leaf for a {p.dtype} parameter")
            p.copy_(torch.tensor(arr))
        else:
            p.copy_(torch.from_numpy(arr.astype(np.float32)).to(p.dtype))
    return module


@torch.no_grad()
def load_jax_lora(module: nn.Module, lora_tree: dict) -> nn.Module:
    """Copy a JAX adapter tree (``jax.tree.map(np.asarray, lora)``) into the
    adapters attached to `module` (train/lora.py::attach_lora); the two sets
    of adapted kernels must be the same. Returns `module`."""
    return _copy_lora(module, flatten_jax_tree(lora_tree))


@torch.no_grad()
def load_jax_next_lora(module: nn.Module, lora_tree: dict) -> nn.Module:
    """load_jax_lora for a Qwen3-Next adapter tree (stacked as the
    parameters are: flatten_next_tree) onto a Qwen3Next's attached
    adapters. Returns `module`."""
    return _copy_lora(module, flatten_next_tree(lora_tree))


def next_lora_tree(named: dict) -> dict:
    """{port adapter name: tensor} (``groups.{g}.lin.{s}.qkvz.lora_a``, ...;
    the adapters or their gradients) -> the JAX package's Qwen3-Next
    adapter tree of fp32 numpy arrays: {"a", "b"} under each adapted
    kernel, stacked [G, 3, ...] under ``groups/lin`` and [G, ...] under
    ``groups/full`` (the inverse of load_jax_next_lora's split)."""
    stacks: dict[tuple, dict] = {}
    for name, t in named.items():
        mod, leaf = name.rsplit(".", 1)
        parts = mod.split(".")
        if parts[0] != "groups" or leaf not in ("lora_a", "lora_b"):
            raise KeyError(f"{name}: not an adapter of a Qwen3-Next layer")
        at = 4 if parts[2] == "lin" else 3          # groups.{g}.lin.{s}. / groups.{g}.full.
        path = ("groups", parts[2], *parts[at:], "kernel", leaf[len("lora_"):])
        index = tuple(int(i) for i in parts[1:at] if i.isdigit())
        stacks.setdefault(path, {})[index] = t.detach().float().cpu().numpy()
    tree: dict = {}
    for path, parts in stacks.items():
        shape = tuple(max(i[d] for i in parts) + 1 for d in range(len(next(iter(parts)))))
        arr = np.stack([parts[i] for i in np.ndindex(*shape)]).reshape(
            shape + next(iter(parts.values())).shape)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree


def _copy_lora(module: nn.Module, flat_tree: dict[str, np.ndarray]) -> nn.Module:
    flat = {}
    for name, arr in flat_tree.items():
        kernel, leaf = name.rsplit(".", 1)          # "<module>.kernel", "a" / "b"
        flat[f"{kernel.rsplit('.', 1)[0]}.lora_{leaf}"] = arr
    params = {n: p for n, p in module.named_parameters()
              if n.endswith((".lora_a", ".lora_b"))}
    missing, extra = params.keys() - flat.keys(), flat.keys() - params.keys()
    if missing or extra:
        raise KeyError(f"adapter sets differ: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    for name, arr in flat.items():
        p = params[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
        p.copy_(torch.from_numpy(arr.astype(np.float32)).to(p.dtype))
    return module
