"""Qwen2.5-VL vision tower: windowed ViT + 2x2 patch merger.

Port of ``video_r2_tpu/models/vision.py``. The host planner
(`plan_vision_layout`, numpy, a copy held equal to the original by
tests/test_torch_host.py) lays patches out in physically padded window order:
every 112x112 attention window owns exactly 64 patch slots, pad slots are
masked. On the device:

- windowed layers attend within fixed 64-slot windows (ops/vit_window_attention);
- full-attention layers gather per-frame-group runs into a [groups, Lmax]
  batch and attend with segment ids (ops/flash, non-causal);
- the 2x2 merger is a reshape (pad slots come in whole merge units), and one
  final gather restores the processor's token order.

attn_impl "kernel" runs both attention kinds through the kernel wrappers (the
CUDA kernels on the card, their plain versions on the CPU); "xla" names the
plain batched path, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash import flash_attention
from ..ops.vit_window_attention import window_attention, window_attention_plain
from .config import VisionConfig
from .layers import MLP, Linear, RMSNorm, apply_rotary, rotary_inv_freq

NEG_INF = -1e30


@dataclass(frozen=True)
class VisionLayout:
    """Static (host-planned) layout for one batch of images/videos."""

    patch_gather: np.ndarray      # [S_pad] int32: source row in the real patch
                                  #  array, or -1 for a pad slot
    pos_hw: np.ndarray            # [S_pad, 2] int32: (h, w) rotary positions
    valid: np.ndarray             # [S_pad] bool
    full_gather: np.ndarray       # [G, Lmax] int32 into S_pad rows, -1 = pad
    out_unit_gather: np.ndarray   # [U_real] int32: padded unit slot per
                                  #  original merge-unit (restores input order)
    seq_len_real: int             # number of real patches
    window_patches: int           # patches per attention window (64)

    @property
    def s_pad(self) -> int:
        return int(self.patch_gather.shape[0])


def plan_vision_layout(grid_thws: list[tuple[int, int, int]], cfg: VisionConfig) -> VisionLayout:
    """Host planner: padded-window patch layout + full-attention grouping
    (get_window_index / rot_pos_emb semantics of the HF ViT, with pad slots
    kept physical so every window is a fixed 64-row block)."""
    return _plan_vision_layout_cached(tuple(map(tuple, grid_thws)), cfg)


@lru_cache(maxsize=64)
def _plan_vision_layout_cached(grid_thws, cfg: VisionConfig) -> VisionLayout:
    m = cfg.spatial_merge_size
    ws_units = cfg.window_size // m // cfg.patch_size  # 4 for 112/2/14
    unit = cfg.spatial_merge_unit                       # 4 patches per unit
    wp = ws_units * ws_units * unit                     # 64 patches per window

    pg_parts, pos_parts, oug_parts = [], [], []
    full_groups: list[tuple[int, int]] = []  # (start, len) in padded patch rows
    pad_off = 0    # running offset in padded patch rows
    real_off = 0   # running offset in real patch rows

    for (t, h, w) in grid_thws:
        lh, lw = h // m, w // m                    # llm grid (merge units)
        nwh = -(-lh // ws_units)
        nww = -(-lw // ws_units)
        group_len = nwh * nww * wp                 # padded patches per t-group
        video_units = lh * lw                      # real units per t-group

        for ti in range(t):
            full_groups.append((pad_off + ti * group_len, group_len))

        wh = np.arange(nwh)[:, None, None, None]
        ww = np.arange(nww)[None, :, None, None]
        iuh = np.arange(ws_units)[None, None, :, None]
        iuw = np.arange(ws_units)[None, None, None, :]
        full = (nwh, nww, ws_units, ws_units)
        uh = np.broadcast_to(wh * ws_units + iuh, full)  # [nwh,nww,ws,ws]
        uw = np.broadcast_to(ww * ws_units + iuw, full)
        valid_u = (uh < lh) & (uw < lw)
        orig_unit = uh * lw + uw                         # per-t, sans ti*lh*lw
        j = np.arange(unit)
        dh, dw = j // m, j % m
        pos_t = np.stack([(uh[..., None] * m + dh),
                          (uw[..., None] * m + dw)], axis=-1)  # [...,unit,2]
        pos_t = np.where(valid_u[..., None, None], pos_t, 0)
        pos_t = pos_t.reshape(-1, 2).astype(np.int32)
        base_t = (orig_unit[..., None] * unit + j).reshape(-1)  # [group_len]
        valid_flat = np.repeat(valid_u.reshape(-1), unit)
        ti_idx = np.arange(t)[:, None]
        pg = np.where(valid_flat[None, :],
                      real_off + ti_idx * (video_units * unit) + base_t[None, :],
                      -1).astype(np.int32)               # [t, group_len]
        pg_parts.append(pg.reshape(-1))
        pos_parts.append(np.tile(pos_t, (t, 1)))

        slot_unit_t = (pad_off // unit) + (
            ((wh * nww + ww) * ws_units + iuh) * ws_units + iuw)  # per-t base
        flat_slot = slot_unit_t.reshape(-1)
        flat_orig = orig_unit.reshape(-1)
        sel = valid_u.reshape(-1)
        unit_slot = np.full((t, video_units), -1, dtype=np.int64)
        units_per_group = nwh * nww * ws_units * ws_units
        for ti in range(t):
            unit_slot[ti, flat_orig[sel]] = flat_slot[sel] + ti * units_per_group
        oug_parts.append(unit_slot.reshape(-1))

        pad_off += t * group_len
        real_off += t * video_units * unit

    patch_gather = np.concatenate(pg_parts) if pg_parts else np.zeros(0, np.int32)
    pos_hw = (np.concatenate(pos_parts) if pos_parts
              else np.zeros((0, 2), np.int32))
    # round up to whole 4-window slabs (the TPU kernel's tile); trailing slots
    # are whole invalid windows that no gather points at
    slab = 4 * wp
    short = (-len(patch_gather)) % slab
    if short:
        patch_gather = np.concatenate(
            [patch_gather, np.full(short, -1, np.int32)])
        pos_hw = np.concatenate([pos_hw, np.zeros((short, 2), np.int32)])

    patch_gather = patch_gather.astype(np.int32)
    pos_hw = pos_hw.astype(np.int32)
    valid = patch_gather >= 0
    lmax = max(l for _, l in full_groups)
    full_gather = np.full((len(full_groups), lmax), -1, dtype=np.int32)
    for gi, (start, length) in enumerate(full_groups):
        full_gather[gi, :length] = np.arange(start, start + length, dtype=np.int32)
    out_unit_gather = np.concatenate(oug_parts).astype(np.int32)
    assert (out_unit_gather >= 0).all()
    return VisionLayout(patch_gather, pos_hw, valid, full_gather,
                        out_unit_gather, real_off, wp)


def _vision_rotary(pos_hw: torch.Tensor, head_dim: int, theta: float):
    """cos/sin [S_pad, head_dim] from (h, w) positions: h and w freqs
    concatenated as [h_freqs | w_freqs], then duplicated."""
    inv = rotary_inv_freq(head_dim // 2, theta, pos_hw.device)  # [head_dim/4]
    fh = pos_hw[:, 0:1].float() * inv[None, :]
    fw = pos_hw[:, 1:2].float() * inv[None, :]
    half = torch.cat([fh, fw], dim=-1)
    emb = torch.cat([half, half], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _full_attention(q, k, v, valid, full_gather, scale: float,
                    impl: str = "xla"):
    """Gather contiguous frame-group runs into [G, Lmax] and attend densely.

    impl="kernel": one flash call over [G, Lmax] with segment ids (pad slots
    excluded). impl="xla": groups attend in chunks whose fp32 score blocks
    stay near 512 MB (the JAX path's chunked lax.map)."""
    s, nh, hd = q.shape
    safe = full_gather.clamp(min=0)
    gmask = (full_gather >= 0) & valid[safe]
    qg, kg, vg = (x[safe] for x in (q, k, v))        # [G, Lmax, nh, hd]
    if impl == "kernel":
        if abs(scale - hd ** -0.5) > 1e-12:
            raise ValueError("flash applies hd**-0.5 itself")
        seg = torch.where(gmask, 1, -2).to(torch.int32)
        out = flash_attention(qg, kg, vg, causal=False, segment_ids=seg)
    else:
        g_count, lmax = full_gather.shape
        chunk = max(1, min(g_count, (512 << 20) // max(nh * lmax * lmax * 4, 1)))
        parts = []
        for g0 in range(0, g_count, chunk):
            sl = slice(g0, g0 + chunk)
            scores = torch.einsum("gqnd,gknd->gnqk", qg[sl].float(),
                                  kg[sl].float()) * scale
            scores = torch.where(gmask[sl][:, None, None, :], scores, NEG_INF)
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            parts.append(torch.einsum("gnqk,gknd->gqnd", probs, vg[sl]))
        out = torch.cat(parts, dim=0)
    # scatter back to [S_pad] (pad rows -> trash slot s)
    flat_idx = torch.where(full_gather >= 0, full_gather, s).reshape(-1).long()
    buf = torch.zeros((s + 1, nh, hd), dtype=out.dtype, device=out.device)
    buf[flat_idx] = out.reshape(-1, nh, hd)
    return buf[:s]


class VisionAttention(nn.Module):
    def __init__(self, dim: int, *, dtype, device):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, True, dtype=dtype, device=device)
        self.proj = Linear(dim, dim, True, dtype=dtype, device=device)


class VisionBlock(nn.Module):
    def __init__(self, cfg: VisionConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        D = cfg.hidden_size
        self.cfg = cfg
        self.norm1 = RMSNorm(D, cfg.rms_norm_eps, **kw)
        self.norm2 = RMSNorm(D, cfg.rms_norm_eps, **kw)
        self.attn = VisionAttention(D, **kw)
        self.mlp = MLP(D, cfg.intermediate_size, True, **kw)

    def forward(self, x, cos, sin, valid, full_gather, use_full: bool, wp: int,
                attn_impl: str, act_quant: str | None = None):
        nh, hd = self.cfg.num_heads, self.cfg.head_dim
        s = x.shape[0]
        h = self.norm1(x)
        qkv = self.attn.qkv(h, act_quant).reshape(s, 3, nh, hd)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        q, k = apply_rotary(q, k, cos[:, None, :], sin[:, None, :])
        scale = hd ** -0.5
        if use_full:
            attn = _full_attention(q, k, v, valid, full_gather, scale,
                                   impl=attn_impl)
        elif attn_impl == "kernel":
            attn = window_attention(q, k, v, valid, wp=wp)
        else:
            attn = window_attention_plain(q, k, v, valid, wp)
        x = x + self.attn.proj(attn.reshape(s, nh * hd), act_quant)
        return x + self.mlp(self.norm2(x), act_quant)


class PatchMerger(nn.Module):
    """RMSNorm per patch, merge 2x2 units, 2-layer MLP with exact GELU."""

    def __init__(self, cfg: VisionConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        D4 = cfg.spatial_merge_unit * cfg.hidden_size
        self.cfg = cfg
        self.ln_q = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.fc1 = Linear(D4, D4, True, **kw)
        self.fc2 = Linear(D4, cfg.out_hidden_size, True, **kw)

    def forward(self, x, act_quant: str | None = None):
        u = self.ln_q(x).reshape(x.shape[0] // self.cfg.spatial_merge_unit, -1)
        return self.fc2(torch.nn.functional.gelu(self.fc1(u, act_quant)), act_quant)


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.patch_embed = Linear(cfg.patch_input_dim, cfg.hidden_size, False, **kw)
        self.blocks = nn.ModuleList(VisionBlock(cfg, **kw)
                                    for _ in range(cfg.depth))
        self.merger = PatchMerger(cfg, **kw)


def vit_forward(tower: VisionTower, patches: torch.Tensor, layout: VisionLayout,
                attn_impl: str = "auto", remat: bool = False,
                act_quant: str | None = None) -> torch.Tensor:
    """patches [S_real, C*tps*p*p] -> merged vision embeddings
    [S_real/4, out_hidden] in the order the processor emitted patches.

    attn_impl: "auto" runs the kernels when the tower is on a CUDA device
    (the JAX package picks its Pallas kernels on the TPU the same way) and
    the plain path elsewhere; "xla" / "kernel" force a path. Both run under
    autograd (the kernels through their backward kernels). remat: under
    autograd, recompute each block in the backward. act_quant="int8": W8A8
    in the blocks' and the merger's linears on int8 weights (as the JAX
    tower's act_quant; the patch embed stays a float matmul)."""
    cfg = tower.cfg
    w = tower.patch_embed.kernel
    device = w.device
    if attn_impl == "auto":
        attn_impl = "kernel" if device.type == "cuda" else "xla"
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    patch_gather, valid = as_t(layout.patch_gather).long(), as_t(layout.valid)
    full_gather = as_t(layout.full_gather).long()
    patches = patches.to(device)
    # patch embed: kernel == stride conv3d is one matmul over flattened patches,
    # in the promoted dtype (fp32 patches x bf16 weights -> fp32), then cast to
    # the weights' dtype, as the JAX tower does
    ct = torch.promote_types(patches.dtype, w.dtype)
    emb = patches.to(ct) @ w.to(ct)
    x = torch.where(valid[:, None], emb[patch_gather.clamp(min=0)], 0).to(w.dtype)
    cos, sin = _vision_rotary(as_t(layout.pos_hw), cfg.head_dim, cfg.rope_theta)
    full = set(cfg.fullatt_block_indexes)
    for i, block in enumerate(tower.blocks):
        args = (x, cos, sin, valid, full_gather, i in full,
                layout.window_patches, attn_impl, act_quant)
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, *args, use_reentrant=False)
        else:
            x = block(*args)
    u = tower.merger(x, act_quant)
    return u[as_t(layout.out_unit_gather).long()]
