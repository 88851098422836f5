"""Qwen3-Next (hybrid gated-DeltaNet / gated-attention MoE): the judge model.

Port of ``video_r2_tpu/models/qwen3_next.py``'s serving path, the model
scripts/serve_judge.sh serves by default (Qwen/Qwen3-Next-80B-A3B-Instruct):

- a 3:1 hybrid layer pattern: three gated-DeltaNet linear-attention layers,
  then one gated full-attention layer (partial RoPE, zero-centred q / k
  norms, a sigmoid output gate), `full_attention_interval` layers a group;
- gated DeltaNet: a depthwise causal conv over the fused q / k / v stream,
  q / k l2-normed, decay g = -exp(A_log) softplus(a + dt_bias), write
  strength beta = sigmoid(b), the delta-rule state S in fp32: a constant
  [B, nv, dk, dv] per layer plus a [B, K-1, conv_dim] conv tail, so three
  layers in four keep no KV cache;
- an MoE MLP in every layer: the port's models/moe.py routing (the ragged
  decode and GMM prefill kernels) plus a shared expert scaled by a sigmoid
  gate; zero-centred RMSNorm ((1 + w) x normed) everywhere.

The chunked delta rule, the conv and the decode attention over the per-slot
KV strips are torch ops, as the JAX package computes them outside Pallas: a
Python loop over 64-token chunks carries the fp32 state, and the per-chunk
(I - M)^-1 is Neumann doubling (six batched [64, 64] matmuls). The
full-attention prefill runs the flash kernel (ops/flash.py, bf16 at head dim
256) under attn_impl "flash", or "auto" on a CUDA device, as the JAX package
picks Pallas flash on the TPU. Right-padded batches are exact by "pause"
masking: pad positions get g = 0 and beta = 0, and the conv tail is gathered
at each row's true length.

The JAX package stacks layers on [G] / [G, 3] axes and scans them; here
`Qwen3Next` holds `groups`, a ModuleList of groups, each with `lin` (a
ModuleList of DeltaNet layers) and `full`, named as the JAX tree is, so
models/convert.py::load_jax_next_params splits the stacked leaves into it.
The caches keep the JAX layout ([G, 3, B, ...] states, [G, B, Smax, kh, hd]
KV strips) and are updated in place. Entry points: `forward`, `prefill`,
`decode_step`, `generate_packed` / `generate` (host-side EOS cut),
`prefill_continue` and `NextPrefixStore` (shared-prefix bursts), and
`generate_spec` (n-gram speculative decoding through `_extend_forward`,
which leaves the recurrent state as it was, and `_commit`, which replays the
saved streams through the accepted prefix). engine/next_continuous.py is the
slot engine over these. Training: `next_loss` (the layers under autograd:
the delta rule's backward is autograd through its torch ops, as the JAX
package's is autodiff through XLA ops; the full-attention layers through
the flash training kernels at head dim 256; the MoE through
models/moe.py::moe_mlp_train) and `make_next_lora_sft_step` over a bf16
or int8 base (QLoRA). Loading HF checkpoints is not ported (ROADMAP Queue 1
#9).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .decoder import Experts, quantize_kv
from .layers import MLP, Linear, quantize_act, rotate_half, rotary_inv_freq
from .moe import moe_mlp, moe_mlp_train


@dataclass(frozen=True)
class Qwen3NextConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 5632          # dense MLP (only if num_experts=0)
    num_hidden_layers: int = 48
    full_attention_interval: int = 4       # every 4th layer is full attention
    # full attention (gated, partial RoPE)
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: int = 256
    partial_rotary_factor: float = 0.25
    rope_theta: float = 10_000_000.0
    rms_norm_eps: float = 1e-6
    # gated DeltaNet
    linear_num_key_heads: int = 16
    linear_num_value_heads: int = 32
    linear_key_head_dim: int = 128
    linear_value_head_dim: int = 128
    linear_conv_kernel_dim: int = 4
    # MoE (every layer; shared expert on top of the routed experts)
    num_experts: int = 512
    num_experts_per_tok: int = 10
    moe_intermediate_size: int = 512
    shared_expert_intermediate_size: int = 512
    norm_topk_prob: bool = True
    moe_capacity_factor: float = 0.0       # judge default: exact, no drops
    moe_group_size: int = 256
    moe_ragged_decode: bool = True         # the ragged FFN kernel on decode steps
    moe_gmm_prefill: bool = True           # the GMM FFN kernel on prefill
    # decode steps of more than RAGGED_MAX_TOKENS tokens (big slot pools,
    # verify windows) through the GMM instead of the exact einsum; off by
    # default, as in the reference
    moe_gmm_decode: bool = False
    # full-attention prefill: "auto" = the flash kernel on a CUDA device,
    # dense attention elsewhere and at decode
    attn_impl: str = "auto"                # auto | flash | xla
    # serving quantization (ChatEngine sets them through replace):
    # kv_quant="int8" keeps the full-attention KV strips int8 with
    # per-(token, head) scales; act_quant="int8" runs the prefill linears
    # W8A8 on int8 weights
    kv_quant: str | None = None
    act_quant: str | None = None
    tie_word_embeddings: bool = False
    eos_token_id: int = 151645
    pad_token_id: int = 151643
    dtype: str = "bfloat16"

    def replace(self, **kw) -> "Qwen3NextConfig":
        return dataclasses.replace(self, **kw)

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @property
    def linear_key_dim(self) -> int:
        return self.linear_num_key_heads * self.linear_key_head_dim

    @property
    def linear_value_dim(self) -> int:
        return self.linear_num_value_heads * self.linear_value_head_dim

    @property
    def conv_dim(self) -> int:
        return 2 * self.linear_key_dim + self.linear_value_dim

    @property
    def num_groups(self) -> int:
        assert self.num_hidden_layers % self.full_attention_interval == 0
        return self.num_hidden_layers // self.full_attention_interval


def qwen3_next_80b_a3b() -> Qwen3NextConfig:
    """Qwen/Qwen3-Next-80B-A3B-Instruct, the reference judge: the defaults
    above are this checkpoint's shape."""
    return Qwen3NextConfig()


def is_qwen3_next_config(cfg) -> bool:
    """The model-family dispatch (apps/common.build_model, ChatEngine)."""
    return isinstance(cfg, Qwen3NextConfig)


# ------------------------------------------------------------------- modules


def _vec(n: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(n, dtype=dtype, device=device))


def _add_mlp(layer: nn.Module, cfg: Qwen3NextConfig, kw: dict) -> None:
    """The MoE half of a layer, named as the JAX tree: router, experts,
    shared, shared_gate (or a dense mlp when num_experts is 0)."""
    H = cfg.hidden_size
    if cfg.num_experts > 0:
        layer.router = Linear(H, cfg.num_experts, False, **kw)
        layer.experts = Experts(cfg, **kw)
        layer.shared = MLP(H, cfg.shared_expert_intermediate_size, False, **kw)
        layer.shared_gate = Linear(H, 1, False, **kw)
    else:
        layer.mlp = MLP(H, cfg.intermediate_size, False, **kw)
    layer.ffn_impl = "kernel"   # "plain": the grouped FFN's plain version on the card


class DeltaNetLayer(nn.Module):
    def __init__(self, cfg: Qwen3NextConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        H, nv = cfg.hidden_size, cfg.linear_num_value_heads
        self.in_norm = _vec(H, **kw)
        self.post_norm = _vec(H, **kw)
        self.qkvz = Linear(H, 2 * cfg.linear_key_dim + 2 * cfg.linear_value_dim, False, **kw)
        self.ba = Linear(H, 2 * nv, False, **kw)
        self.conv = nn.Parameter(torch.empty(cfg.conv_dim, cfg.linear_conv_kernel_dim, **kw))
        self.dt_bias = _vec(nv, torch.float32, device)
        self.A_log = _vec(nv, torch.float32, device)
        self.norm = _vec(cfg.linear_value_head_dim, **kw)
        self.out = Linear(cfg.linear_value_dim, H, False, **kw)
        _add_mlp(self, cfg, kw)


class GatedAttentionLayer(nn.Module):
    def __init__(self, cfg: Qwen3NextConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        H, nh, kh, hd = (cfg.hidden_size, cfg.num_attention_heads,
                         cfg.num_key_value_heads, cfg.head_dim)
        self.in_norm = _vec(H, **kw)
        self.post_norm = _vec(H, **kw)
        self.q = Linear(H, nh * hd * 2, False, **kw)    # queries and the output gate
        self.k = Linear(H, kh * hd, False, **kw)
        self.v = Linear(H, kh * hd, False, **kw)
        self.o = Linear(nh * hd, H, False, **kw)
        self.q_norm = _vec(hd, **kw)
        self.k_norm = _vec(hd, **kw)
        _add_mlp(self, cfg, kw)


class NextGroup(nn.Module):
    def __init__(self, cfg: Qwen3NextConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.lin = nn.ModuleList(DeltaNetLayer(cfg, **kw)
                                 for _ in range(cfg.full_attention_interval - 1))
        self.full = GatedAttentionLayer(cfg, **kw)


class _Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, *, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, dim, dtype=dtype, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids]


class Qwen3Next(nn.Module):
    """Parameter tree mirrors the JAX package's: embed, groups.{g}.lin.{s},
    groups.{g}.full, final_norm, lm_head."""

    def __init__(self, cfg: Qwen3NextConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.embed = _Embed(cfg.vocab_size, cfg.hidden_size, **kw)
        self.groups = nn.ModuleList(NextGroup(cfg, **kw) for _ in range(cfg.num_groups))
        self.final_norm = _vec(cfg.hidden_size, **kw)
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, False, **kw)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    @property
    def dtype(self) -> torch.dtype:
        return self.final_norm.dtype


# --------------------------------------------------------------------- norms


def rms_norm_zc(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Zero-centred RMSNorm (HF Qwen3NextRMSNorm): scale (1 + w), the product
    in fp32 until the final cast."""
    x32 = x.float()
    normed = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (normed * (1.0 + w.float())).to(x.dtype)


def rms_norm_gated(w: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Gated RMSNorm (HF Qwen3NextRMSNormGated): norm before the gate, a
    ones-centred weight, the gate silu(z) in fp32."""
    x32 = x.float()
    normed = (x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)).to(x.dtype)
    h = w.to(x.dtype) * normed
    return (h.float() * F.silu(z.float())).to(x.dtype)


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, -1, keepdim=True) + eps)


# ---------------------------------------------------------------- delta rule


def _tri_inverse(m: torch.Tensor) -> torch.Tensor:
    """(I - M)^-1 for strictly lower-triangular M [..., c, c] by Neumann
    doubling, prod_j (I + M^(2^j)): M is nilpotent, so ceil(log2 c) rounds
    are exact, each a batched matmul."""
    c = m.shape[-1]
    result = torch.eye(c, dtype=m.dtype, device=m.device) + m
    power = m
    for _ in range(max(int(np.ceil(np.log2(c))), 1) - 1):
        power = power @ power
        result = result + power @ result
    return result


def chunk_gated_delta_rule(q, k, v, g, beta, chunk_size: int = 64, initial_state=None):
    """Chunked gated delta rule (prefill). q, k [B, S, H, dk] (key heads
    already repeated to H), v [B, S, H, dv], g (log decay, <= 0) and beta
    [B, S, H]; pad / pause positions carry g = 0 and beta = 0. Returns
    (out [B, S, H, dv] in v's dtype, final state [B, H, dk, dv] fp32), HF
    torch_chunk_gated_delta_rule with the in-kernel q / k l2-norm and the
    dk^-0.5 query scale. A Python loop over the chunks carries the state."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    c = chunk_size
    pad = (-S) % c
    q32 = _l2norm(q.float()) * dk ** -0.5
    k32 = _l2norm(k.float())
    v32, g32, b32 = v.float(), g.float(), beta.float()
    if pad:   # zero g / beta on the tail: a pause
        q32, k32, v32 = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q32, k32, v32))
        g32, b32 = (F.pad(x, (0, 0, 0, pad)) for x in (g32, b32))
    nc = (S + pad) // c

    def chunked(x, d):
        return x.reshape(B, nc, c, H, d).permute(0, 3, 1, 2, 4)   # [B, H, nc, c, d]

    qc, kc, vc = chunked(q32, dk), chunked(k32, dk), chunked(v32, dv)
    gc = g32.reshape(B, nc, c, H).permute(0, 3, 1, 2)             # [B, H, nc, c]
    bc = b32.reshape(B, nc, c, H).permute(0, 3, 1, 2)
    gcs = torch.cumsum(gc, dim=-1)
    # decay[i, j] = exp(g_i - g_j) for j <= i; the exponent is masked, not
    # the exp (above the diagonal g_i - g_j >= 0 could overflow)
    tril = torch.tril(torch.ones(c, c, dtype=torch.bool, device=q.device))
    diff = torch.where(tril, gcs[..., :, None] - gcs[..., None, :], 0.0)
    decay = torch.where(tril, torch.exp(diff), 0.0)
    k_beta = kc * bc[..., None]
    v_beta = vc * bc[..., None]
    strict = torch.tril(torch.ones(c, c, dtype=torch.bool, device=q.device), -1)
    m = -torch.where(strict, (k_beta @ kc.transpose(-1, -2)) * decay, 0.0)
    t_inv = _tri_inverse(m)                                        # (I - M)^-1
    v_prime = t_inv @ v_beta
    k_cumdecay = t_inv @ (k_beta * torch.exp(gcs)[..., None])

    state = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
             if initial_state is None else initial_state.float())
    outs = []
    for n in range(nc):
        q_i, k_i, g_i = qc[:, :, n], kc[:, :, n], gcs[:, :, n]
        attn = torch.where(tril, (q_i @ k_i.transpose(-1, -2)) * decay[:, :, n], 0.0)
        v_new = v_prime[:, :, n] - k_cumdecay[:, :, n] @ state
        outs.append((q_i * torch.exp(g_i)[..., None]) @ state + attn @ v_new)
        g_last = g_i[..., -1]
        state = (state * torch.exp(g_last)[..., None, None]
                 + (k_i * torch.exp(g_last[..., None] - g_i)[..., None]).transpose(-1, -2)
                 @ v_new)
    out = torch.stack(outs, dim=2).reshape(B, H, nc * c, dv)
    return out[:, :, :S].transpose(1, 2).to(v.dtype), state


def recurrent_gated_delta_step(q, k, v, g, beta, state):
    """One-token gated delta rule (decode). q, k [B, H, dk], v [B, H, dv],
    g / beta [B, H], state [B, H, dk, dv] fp32 (HF
    torch_recurrent_gated_delta_rule)."""
    dk = q.shape[-1]
    q32 = _l2norm(q.float()) * dk ** -0.5
    k32 = _l2norm(k.float())
    state = state * torch.exp(g.float())[..., None, None]
    kv_mem = torch.einsum("bhk,bhkd->bhd", k32, state)
    delta = (v.float() - kv_mem) * beta.float()[..., None]
    state = state + k32[..., :, None] * delta[..., None, :]
    out = torch.einsum("bhk,bhkd->bhd", q32, state)
    return out.to(v.dtype), state


# ------------------------------------------------------------ DeltaNet layer


def _split_qkvz_ba(cfg: Qwen3NextConfig, qkvz, ba):
    """HF fix_query_key_value_ordering: the fused projections interleave
    per-key-head [q | k | v group | z group] blocks (and [b group | a
    group])."""
    *lead, _ = qkvz.shape
    nk, nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    hk, hv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    r = nv // nk
    qkvz = qkvz.reshape(*lead, nk, 2 * hk + 2 * r * hv)
    q = qkvz[..., :hk]
    k = qkvz[..., hk:2 * hk]
    v = qkvz[..., 2 * hk:2 * hk + r * hv].reshape(*lead, nv, hv)
    z = qkvz[..., 2 * hk + r * hv:].reshape(*lead, nv, hv)
    ba = ba.reshape(*lead, nk, 2 * r)
    b = ba[..., :r].reshape(*lead, nv)
    a = ba[..., r:].reshape(*lead, nv)
    return q, k, v, z, b, a


def _deltanet_gb(p: DeltaNetLayer, b, a):
    """beta = sigmoid(b); g = -exp(A_log) softplus(a + dt_bias), fp32."""
    beta = torch.sigmoid(b.float())
    g = -torch.exp(p.A_log.float()) * F.softplus(a.float() + p.dt_bias.float())
    return g, beta


def _conv_streams(cfg: Qwen3NextConfig, p: DeltaNetLayer, h, conv_tail, aq=None, pq=None):
    """The projections, the causal conv over [conv tail | the new tokens'
    q / k / v] and the post-conv heads of h [B, W, H]. Returns (q, k
    [B, W, nv, dk] with key heads repeated, v [B, W, nv, dv], z, g, beta
    [B, W, nv], window [B, K-1+W, conv_dim])."""
    B, W, _ = h.shape
    K = cfg.linear_conv_kernel_dim
    q, k, v, z, b, a = _split_qkvz_ba(cfg, p.qkvz(h, aq, pq), p.ba(h, aq, pq))
    mixed = torch.cat([q.reshape(B, W, -1), k.reshape(B, W, -1), v.reshape(B, W, -1)], -1)
    window = torch.cat([conv_tail, mixed], 1)                       # [B, K-1+W, D]
    w = p.conv.to(window.dtype)
    conv_out = F.silu(sum(window[:, j:j + W, :] * w[:, j] for j in range(K)))
    kd = cfg.linear_key_dim
    nk, nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    q = conv_out[..., :kd].reshape(B, W, nk, cfg.linear_key_head_dim)
    k = conv_out[..., kd:2 * kd].reshape(B, W, nk, cfg.linear_key_head_dim)
    v = conv_out[..., 2 * kd:].reshape(B, W, nv, cfg.linear_value_head_dim)
    g, beta = _deltanet_gb(p, b, a)
    r = nv // nk
    if r > 1:
        q = torch.repeat_interleave(q, r, dim=2)
        k = torch.repeat_interleave(k, r, dim=2)
    return q, k, v, z, g, beta, window


def _tail_at(window, n, K: int):
    """window [B, K-1+S, D] rows [n_b, n_b + K - 1): each row's conv tail
    after its first n_b tokens."""
    B = window.shape[0]
    idx = n.long()[:, None] + torch.arange(K - 1, device=window.device)
    return window[torch.arange(B, device=window.device)[:, None], idx]


def _deltanet_prefill(cfg: Qwen3NextConfig, p: DeltaNetLayer, h, valid, lengths,
                      chunk_size: int, want_state: bool, init=None):
    """Gated DeltaNet over a right-padded sequence h [B, S, H]. init =
    (conv tail, state) continues a cached prefix; None starts fresh (a zero
    conv tail is a fresh causal conv's left padding). Returns (out
    [B, S, H], (conv tail, state) or None)."""
    B, S, _ = h.shape
    K = cfg.linear_conv_kernel_dim
    aq = cfg.act_quant
    pq = quantize_act(h) if aq == "int8" and p.qkvz.kernel_q is not None else None
    tail0 = (init[0] if init is not None
             else torch.zeros((B, K - 1, cfg.conv_dim), dtype=h.dtype, device=h.device))
    q, k, v, z, g, beta, window = _conv_streams(cfg, p, h, tail0, aq, pq)
    if valid is not None:   # pause at pad positions: no decay, no write
        g = g * valid[..., None]
        beta = beta * valid[..., None]
    out, state = chunk_gated_delta_rule(q, k, v, g, beta, chunk_size=chunk_size,
                                        initial_state=init[1] if init is not None else None)
    out = rms_norm_gated(p.norm, out, z, cfg.rms_norm_eps)
    out = p.out(out.reshape(B, S, -1), aq)
    if not want_state:
        return out, None
    n = lengths if lengths is not None else torch.full((B,), S, device=h.device)
    return out, (_tail_at(window, n, K), state)


def _deltanet_decode(cfg: Qwen3NextConfig, p: DeltaNetLayer, h, conv_state, state):
    """One-token DeltaNet step: h [B, 1, H], conv_state [B, K-1, conv_dim],
    state [B, nv, dk, dv] fp32. Returns (out, (conv_state, state))."""
    B = h.shape[0]
    q, k, v, z, b, a = _split_qkvz_ba(cfg, p.qkvz(h), p.ba(h))
    mixed = torch.cat([q.reshape(B, 1, -1), k.reshape(B, 1, -1), v.reshape(B, 1, -1)], -1)
    window = torch.cat([conv_state, mixed], 1)                      # [B, K, conv_dim]
    conv_out = F.silu(torch.einsum("bkd,dk->bd", window, p.conv.to(window.dtype)))
    kd = cfg.linear_key_dim
    nk, nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    q = conv_out[:, :kd].reshape(B, nk, cfg.linear_key_head_dim)
    k = conv_out[:, kd:2 * kd].reshape(B, nk, cfg.linear_key_head_dim)
    v = conv_out[:, 2 * kd:].reshape(B, nv, cfg.linear_value_head_dim)
    g, beta = _deltanet_gb(p, b[:, 0], a[:, 0])
    r = nv // nk
    if r > 1:
        q = torch.repeat_interleave(q, r, dim=1)
        k = torch.repeat_interleave(k, r, dim=1)
    out, state = recurrent_gated_delta_step(q, k, v, g, beta, state)
    out = rms_norm_gated(p.norm, out[:, None], z, cfg.rms_norm_eps)
    return p.out(out.reshape(B, 1, -1)), (window[:, 1:], state)


# ------------------------------------------------------- full-attention layer


def _rope_cos_sin(cfg: Qwen3NextConfig, positions):
    """positions [B, S] -> cos, sin [B, S, rotary_dim] fp32."""
    inv = rotary_inv_freq(cfg.rotary_dim, cfg.rope_theta, device=positions.device)
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], -1)
    return torch.cos(emb), torch.sin(emb)


def _apply_partial_rope(x, cos, sin, rot: int):
    """Rotary on the first `rot` dims only, fp32."""
    x32 = x.float()
    x_rot, x_pass = x32[..., :rot], x32[..., rot:]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    x_rot = x_rot * c + rotate_half(x_rot) * s
    return torch.cat([x_rot, x_pass], -1).to(x.dtype)


def _gated_attn_qkv(cfg: Qwen3NextConfig, p: GatedAttentionLayer, h, rope, aq=None):
    """Projections, the zero-centred q / k norms, partial RoPE and the
    output gate's stream. aq="int8": W8A8 projections (q / k / v share one
    activation quantization). Returns q [B, S, nh, hd], k, v [B, S, kh, hd],
    gate [B, S, nh hd]."""
    B, S, _ = h.shape
    nh, kh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    pq = quantize_act(h) if aq == "int8" and p.q.kernel_q is not None else None
    qg = p.q(h, aq, pq).reshape(B, S, nh, 2 * hd)
    q, gate = qg[..., :hd], qg[..., hd:].reshape(B, S, nh * hd)
    k = p.k(h, aq, pq).reshape(B, S, kh, hd)
    v = p.v(h, aq, pq).reshape(B, S, kh, hd)
    q = rms_norm_zc(p.q_norm, q, cfg.rms_norm_eps)
    k = rms_norm_zc(p.k_norm, k, cfg.rms_norm_eps)
    cos, sin = rope
    q = _apply_partial_rope(q, cos, sin, cfg.rotary_dim)
    k = _apply_partial_rope(k, cos, sin, cfg.rotary_dim)
    return q, k, v, gate


def _attn_core(cfg: Qwen3NextConfig, q, k, v, mask):
    """Dense attention, GQA by grouping the query heads (no repeated K / V).
    q [B, Sq, nh, hd], k / v [B, Sk, kh, hd], mask [B | 1, Sq, Sk] bool
    (True: attend). Scores in q's dtype, the softmax in fp32."""
    B, Sq, nh, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(B, Sq, kh, nh // kh, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) * hd ** -0.5
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores.float(), -1).to(q.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", probs, v).reshape(B, Sq, nh * hd)


def _attn_core_q(cfg: Qwen3NextConfig, q, kq, vq, ks, vs, mask):
    """Dense attention over an int8 KV with the per-(token, head) scales
    factored out of both products (models/decoder.py's scheme). kq / vq
    [B, Sk, kh, hd] int8, ks / vs [B, Sk, kh] fp32."""
    B, Sq, nh, hd = q.shape
    kh = kq.shape[2]
    qg = q.reshape(B, Sq, kh, nh // kh, hd)
    ks_, vs_ = (s.permute(0, 2, 1)[:, :, None, None, :] for s in (ks, vs))
    scores = (torch.einsum("bqgrd,bkgd->bgrqk", qg, kq.to(q.dtype)).float()
              * ks_ * hd ** -0.5)
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    pv = (torch.softmax(scores, -1) * vs_).to(q.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", pv, vq.to(q.dtype)).reshape(B, Sq, nh * hd)


def _use_flash(cfg: Qwen3NextConfig, S: int, device) -> bool:
    if cfg.attn_impl == "xla" or S <= 8:
        return False
    if cfg.attn_impl == "flash":
        return True
    return torch.device(device).type == "cuda"   # "auto"


def _gate_out(p: GatedAttentionLayer, out, gate, aq=None):
    out = out * torch.sigmoid(gate.float()).to(out.dtype)
    return p.o(out, aq)


def _full_attn_prefill(cfg: Qwen3NextConfig, p: GatedAttentionLayer, h, rope,
                       want_state: bool, lengths=None):
    B, S, _ = h.shape
    q, k, v, gate = _gated_attn_qkv(cfg, p, h, rope, aq=cfg.act_quant)
    if _use_flash(cfg, S, h.device):
        from ..ops.flash import flash_attention

        kvl = lengths if lengths is not None else torch.full((B,), S, device=h.device)
        out = flash_attention(q, k, v, kv_lengths=kvl, causal=True).reshape(B, S, -1)
    else:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=h.device))[None]
        out = _attn_core(cfg, q, k, v, mask)
    return _gate_out(p, out, gate, cfg.act_quant), ((k, v) if want_state else None)


def _kv_write(kv: tuple, k, v, cur) -> None:
    """Write new K / V rows [B, W, kh, hd] at each row's frontier cur [B],
    in place: kv = bf16 (k, v) strips [B, Smax, kh, hd] or int8 (kq, vq,
    ks, vs), the rows quantized on the way in."""
    B, W = k.shape[:2]
    Smax = kv[0].shape[1]
    rows = torch.arange(B, device=k.device)[:, None]
    idx = cur.long().clamp(max=Smax - W)[:, None] + torch.arange(W, device=k.device)
    if len(kv) == 4:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        kv[0][rows, idx], kv[1][rows, idx] = kq, vq
        kv[2][rows, idx], kv[3][rows, idx] = ks, vs
    else:
        kv[0][rows, idx], kv[1][rows, idx] = k, v


def _kv_attn(cfg: Qwen3NextConfig, q, kv: tuple, mask):
    if len(kv) == 4:
        return _attn_core_q(cfg, q, *kv, mask)
    return _attn_core(cfg, q, kv[0], kv[1], mask)


def _full_attn_decode(cfg: Qwen3NextConfig, p: GatedAttentionLayer, h, kv: tuple,
                      cur_len, rope):
    """h [B, 1, H]; kv the group's strips (written in place); cur_len [B] the
    position this token writes."""
    q, k, v, gate = _gated_attn_qkv(cfg, p, h, rope)
    _kv_write(kv, k, v, cur_len)
    Smax = kv[0].shape[1]
    mask = (torch.arange(Smax, device=h.device)[None] <= cur_len[:, None])[:, None, :]
    return _gate_out(p, _kv_attn(cfg, q, kv, mask), gate)


# ------------------------------------------------------------------ MLP/MoE


def moe_params(p) -> dict:
    """The routed experts of a layer as models/moe.py's dict."""
    ex = p.experts
    return {"router": {"kernel": p.router.kernel},
            "experts": {"gate": ex.gate.leaf(), "up": ex.up.leaf(), "down": ex.down.leaf()}}


def _next_mlp(cfg: Qwen3NextConfig, p, x, is_decode: bool, train: bool = False):
    """Routed experts (models/moe.py: ragged decode at up to RAGGED_MAX_TOKENS
    tokens, the GMM on prefill, and on decode only with moe_gmm_decode;
    under next_loss, `train`, moe_mlp_train's route) plus the shared expert
    scaled by sigmoid(shared_gate(x)). As in the reference the routed
    experts take no act_quant; the shared expert takes it on prefill."""
    aq = None if is_decode else cfg.act_quant
    if cfg.num_experts == 0:
        return p.mlp(x, aq)
    if train:
        routed = moe_mlp_train(moe_params(p), x, cfg.num_experts_per_tok,
                               cfg.norm_topk_prob, cfg.moe_capacity_factor,
                               cfg.moe_group_size, ffn_impl=p.ffn_impl)
    else:
        routed = moe_mlp(moe_params(p), x, cfg.num_experts_per_tok, cfg.norm_topk_prob,
                         capacity_factor=cfg.moe_capacity_factor,
                         group_size=cfg.moe_group_size,
                         ragged_decode=cfg.moe_ragged_decode and is_decode,
                         gmm_prefill=cfg.moe_gmm_decode if is_decode else cfg.moe_gmm_prefill,
                         ffn_impl=p.ffn_impl)
    sgate = torch.sigmoid(p.shared_gate(x).float()).to(x.dtype)
    return routed + p.shared(x, aq) * sgate


# ------------------------------------------------------------------- caches


@dataclass
class Qwen3NextCache:
    """Hybrid cache: conv [G, P1, B, K-1, conv_dim]; rec [G, P1, B, nv, dk,
    dv] fp32; k / v [G, B, Smax, kh, hd]; length [B] the current positions."""
    conv: torch.Tensor
    rec: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    def kv(self, g: int) -> tuple:
        return (self.k[g], self.v[g])


@dataclass
class QuantNextCache:
    """kv_quant="int8": the full-attention strips int8 with per-(token, head)
    absmax scales; the DeltaNet states stay float."""
    conv: torch.Tensor
    rec: torch.Tensor
    k: torch.Tensor          # [G, B, Smax, kh, hd] int8
    v: torch.Tensor
    k_scale: torch.Tensor    # [G, B, Smax, kh] fp32
    v_scale: torch.Tensor
    length: torch.Tensor

    def kv(self, g: int) -> tuple:
        return (self.k[g], self.v[g], self.k_scale[g], self.v_scale[g])


def empty_cache(cfg: Qwen3NextConfig, B: int, max_len: int, dtype, device) -> Qwen3NextCache:
    """A zero bf16 (model-dtype) hybrid cache of B rows and max_len KV rows."""
    G, P1 = cfg.num_groups, cfg.full_attention_interval - 1
    kvs = (G, B, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return Qwen3NextCache(
        conv=torch.zeros((G, P1, B, cfg.linear_conv_kernel_dim - 1, cfg.conv_dim),
                         dtype=dtype, device=device),
        rec=torch.zeros((G, P1, B, cfg.linear_num_value_heads, cfg.linear_key_head_dim,
                         cfg.linear_value_head_dim), dtype=torch.float32, device=device),
        k=torch.zeros(kvs, dtype=dtype, device=device),
        v=torch.zeros(kvs, dtype=dtype, device=device),
        length=torch.zeros((B,), dtype=torch.long, device=device))


def _quantize_next_cache(cache: Qwen3NextCache) -> QuantNextCache:
    """bf16 hybrid cache -> int8 KV strips + scales (where the packed path
    quantizes, so prefix bursts match it token for token)."""
    (kq, ks), (vq, vs) = quantize_kv(cache.k), quantize_kv(cache.v)
    return QuantNextCache(cache.conv, cache.rec, kq, vq, ks, vs, cache.length)


# ------------------------------------------------------------------- forward


def _run_prefill(model: Qwen3Next, cfg: Qwen3NextConfig, h, lengths, chunk_size: int,
                 want_cache: bool, train: bool = False):
    """The layers over h [B, S, H] from position 0. Returns (final-normed h,
    a cache of KV width S or None). train: next_loss's MoE route
    (moe_mlp_train)."""
    B, S, _ = h.shape
    dev = h.device
    valid = None
    if lengths is not None:
        valid = (torch.arange(S, device=dev)[None] < lengths[:, None]).float()
    rope = _rope_cos_sin(cfg, torch.arange(S, device=dev)[None].expand(B, S))
    cache = empty_cache(cfg, B, S, h.dtype, dev) if want_cache else None
    for g, grp in enumerate(model.groups):
        for s, lp in enumerate(grp.lin):
            res = h
            out, st = _deltanet_prefill(cfg, lp, rms_norm_zc(lp.in_norm, h, cfg.rms_norm_eps),
                                        valid, lengths, chunk_size, want_cache)
            h = res + out
            h = h + _next_mlp(cfg, lp, rms_norm_zc(lp.post_norm, h, cfg.rms_norm_eps), False,
                              train)
            if want_cache:
                cache.conv[g, s], cache.rec[g, s] = st
        fp = grp.full
        out, st = _full_attn_prefill(cfg, fp, rms_norm_zc(fp.in_norm, h, cfg.rms_norm_eps),
                                     rope, want_cache, lengths)
        h = h + out
        h = h + _next_mlp(cfg, fp, rms_norm_zc(fp.post_norm, h, cfg.rms_norm_eps), False,
                          train)
        if want_cache:
            cache.k[g], cache.v[g] = st
    h = rms_norm_zc(model.final_norm, h, cfg.rms_norm_eps)
    if want_cache:
        cache.length = (lengths.long() if lengths is not None
                        else torch.full((B,), S, dtype=torch.long, device=dev))
    return h, cache


def _lm_head(model: Qwen3Next, cfg: Qwen3NextConfig, h):
    if cfg.tie_word_embeddings:
        return h @ model.embed.weight.T
    return model.lm_head(h)


def _ids(model: Qwen3Next, x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=model.device).long()


@torch.inference_mode()
def forward(model: Qwen3Next, cfg: Qwen3NextConfig, input_ids, lengths=None,
            chunk_size: int = 64):
    """Full-sequence logits [B, S, V] without a cache."""
    ids = _ids(model, input_ids)
    lens = _ids(model, lengths) if lengths is not None else None
    h, _ = _run_prefill(model, cfg, model.embed(ids), lens, chunk_size, want_cache=False)
    return _lm_head(model, cfg, h)


@torch.inference_mode()
def prefill(model: Qwen3Next, cfg: Qwen3NextConfig, input_ids, lengths, max_len: int,
            chunk_size: int = 64):
    """Right-padded prompt prefill: (last valid position's logits [B, V], a
    cache whose KV strips are max_len wide; int8 under cfg.kv_quant)."""
    ids = _ids(model, input_ids)
    lens = _ids(model, lengths)
    B, S = ids.shape
    h, cache = _run_prefill(model, cfg, model.embed(ids), lens, chunk_size, want_cache=True)
    logits = _lm_head(model, cfg, h[torch.arange(B, device=h.device), lens - 1])
    if cfg.kv_quant == "int8":
        cache = _quantize_next_cache(cache)
    if max_len > S:
        pad = (0, 0, 0, 0, 0, max_len - S)
        cache.k, cache.v = F.pad(cache.k, pad), F.pad(cache.v, pad)
        if isinstance(cache, QuantNextCache):
            # scales past the prompt pad with ones (strictly positive)
            cache.k_scale = F.pad(cache.k_scale, pad[2:], value=1.0)
            cache.v_scale = F.pad(cache.v_scale, pad[2:], value=1.0)
    return logits, cache


@torch.inference_mode()
def decode_step(model: Qwen3Next, cfg: Qwen3NextConfig, token, cache):
    """One decode step: token [B] -> (logits [B, V], the cache, updated in
    place and advanced by one)."""
    h = model.embed(token.long())[:, None]
    rope = _rope_cos_sin(cfg, cache.length[:, None])
    eps = cfg.rms_norm_eps
    for g, grp in enumerate(model.groups):
        for s, lp in enumerate(grp.lin):
            out, (conv, rec) = _deltanet_decode(cfg, lp, rms_norm_zc(lp.in_norm, h, eps),
                                                cache.conv[g, s], cache.rec[g, s])
            cache.conv[g, s], cache.rec[g, s] = conv, rec
            h = h + out
            h = h + _next_mlp(cfg, lp, rms_norm_zc(lp.post_norm, h, eps), True)
        fp = grp.full
        h = h + _full_attn_decode(cfg, fp, rms_norm_zc(fp.in_norm, h, eps), cache.kv(g),
                                  cache.length, rope)
        h = h + _next_mlp(cfg, fp, rms_norm_zc(fp.post_norm, h, eps), True)
    h = rms_norm_zc(model.final_norm, h, eps)
    cache.length = cache.length + 1
    return _lm_head(model, cfg, h[:, 0]), cache


@dataclass
class NextGenResult:
    sequences: np.ndarray    # [B, max_new_tokens]
    lengths: np.ndarray      # [B] tokens up to and including the first EOS


def _decode_tail(model, cfg, logits, cache, sp, seed: int) -> NextGenResult:
    """Sample the first token from the prefill logits, decode the rest of
    the budget (every row runs it all), cut at EOS on the host: each row's
    length runs up to its first EOS."""
    from ..engine.sampling import sample_token

    gen = torch.Generator(device=model.device).manual_seed(seed)
    tok = sample_token(logits, gen, sp)
    toks = [tok]
    for _ in range(sp.max_new_tokens - 1):
        logits, cache = decode_step(model, cfg, tok, cache)
        tok = sample_token(logits, gen, sp)
        toks.append(tok)
    seqs = torch.stack(toks, 1).cpu().numpy()
    out_len = np.full((seqs.shape[0],), seqs.shape[1], np.int64)
    for eos in sp.eos_token_ids:
        hit = seqs == eos
        out_len = np.where(hit.any(1), np.minimum(out_len, hit.argmax(1) + 1), out_len)
    return NextGenResult(sequences=seqs, lengths=out_len)


@torch.inference_mode()
def generate_packed(model: Qwen3Next, cfg: Qwen3NextConfig, input_ids, lengths, sp,
                    seed: int = 0, chunk_size: int = 64) -> NextGenResult:
    """Engine entry: right-padded prompts and engine SamplingParams; the
    whole budget decodes, rows are cut at their first EOS on the host, so
    greedy output equals per-row early-stopped decoding."""
    S = np.asarray(input_ids).shape[1]
    logits, cache = prefill(model, cfg, input_ids, lengths, S + sp.max_new_tokens, chunk_size)
    return _decode_tail(model, cfg, logits, cache, sp, seed)


def generate(model: Qwen3Next, cfg: Qwen3NextConfig, input_ids, lengths,
             max_new_tokens: int, temperature: float = 0.0, seed: int = 0,
             chunk_size: int = 64) -> np.ndarray:
    """[B, max_new_tokens] generated ids from right-padded prompts;
    temperature 0 is greedy."""
    from ..engine.sampling import SamplingParams

    sp = SamplingParams(do_sample=temperature > 0.0, temperature=max(temperature, 1e-6),
                        max_new_tokens=max_new_tokens)
    return generate_packed(model, cfg, input_ids, lengths, sp, seed=seed,
                           chunk_size=chunk_size).sequences


# ------------------------------------------------------------------ training


def next_loss(model: Qwen3Next, cfg: Qwen3NextConfig, input_ids, labels, lengths=None,
              chunk_size: int = 64) -> torch.Tensor:
    """Causal-LM loss under autograd: the mean CE over labels != -100 at the
    same position (the caller shifts), through ops/fused_ce.py (no [N, V]
    logits). The layers run as a prefill without a cache; the routed
    experts take moe_mlp_train's route (the reference forces the einsum);
    the full-attention layers take the flash training kernels where
    cfg.attn_impl picks flash (a CUDA device under "auto"). An int8
    lm_head is dequantized once a call for the CE, as the reference does.
    Returns the fp32 scalar loss."""
    from ..ops.fused_ce import fused_linear_cross_entropy
    from .quant import dequantize_kernel

    ids = _ids(model, input_ids)
    lab = _ids(model, labels)
    lens = _ids(model, lengths) if lengths is not None else None
    h, _ = _run_prefill(model, cfg, model.embed(ids), lens, chunk_size, want_cache=False,
                        train=True)
    if cfg.tie_word_embeddings:
        w = model.embed.weight.T
    elif model.lm_head.kernel is not None:
        w = model.lm_head.kernel
    elif model.lm_head.kernel_q is not None:
        w = dequantize_kernel({"kernel_q": model.lm_head.kernel_q,
                               "scale": model.lm_head.scale}, dtype=h.dtype)
    else:
        raise ValueError("next_loss: the lm_head must be float or int8")
    return fused_linear_cross_entropy(h.reshape(-1, h.shape[-1]), w, lab.reshape(-1))


# LoRA targets of this family (train/lora.py matches module-path suffixes):
# groups.{g}.lin.{s}.qkvz / .out, groups.{g}.full.q / k / v / o and every
# layer's shared expert; never the routed experts or the router
NEXT_LORA_TARGETS = (
    ("qkvz", "kernel"), ("out", "kernel"),
    ("q", "kernel"), ("k", "kernel"), ("v", "kernel"), ("o", "kernel"),
    ("shared", "gate", "kernel"), ("shared", "up", "kernel"),
    ("shared", "down", "kernel"),
)


def make_next_lora_sft_step(model: Qwen3Next, cfg: Qwen3NextConfig):
    """The SFT step where only the adapters attached to `model`
    (train/lora.py::attach_lora over NEXT_LORA_TARGETS; init_lora_for_quantized
    over an int8 base: QLoRA) train, the reference's make_next_lora_sft_step
    in the port's form (train/sft.py::make_lora_sft_step): step(state,
    batch) -> (state, {"loss", "grad_norm"}), state a train/sft.py TrainState
    over the adapters, batch {input_ids, labels[, lengths]} (tensors or
    arrays). The base's parameters must not require gradients (ValueError
    otherwise), so no base gradient is formed."""
    from ..train.optim import global_norm

    if not any(n.endswith(".lora_a") for n, _ in model.named_parameters()):
        raise ValueError("no adapters attached (train/lora.py::attach_lora)")
    trains = [n for n, p in model.named_parameters()
              if p.requires_grad and not n.endswith((".lora_a", ".lora_b"))]
    if trains:
        raise ValueError(f"base parameters require grad: {trains[:3]}...")

    def step(state, batch):
        state.optimizer.zero_grad()
        loss = next_loss(model, cfg, batch["input_ids"], batch["labels"], batch.get("lengths"))
        loss.backward()
        grad_norm = global_norm(p.grad for p in state.params.values() if p.grad is not None)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


# ----------------------------------------------- prefix reuse / continue


def _full_attn_continue(cfg: Qwen3NextConfig, p: GatedAttentionLayer, h, k_cache, v_cache,
                        P: int, suffix_lengths, rope):
    """Suffix prefill attention: the suffix's K / V written at P (in place),
    attending over the cached prefix and the causal suffix."""
    B, S, _ = h.shape
    q, k, v, gate = _gated_attn_qkv(cfg, p, h, rope)
    k_cache[:, P:P + S], v_cache[:, P:P + S] = k, v
    kv_len = P + S
    k_win, v_win = k_cache[:, :kv_len], v_cache[:, :kv_len]
    if _use_flash(cfg, S, h.device):
        from ..ops.flash import flash_attention

        out = flash_attention(q, k_win, v_win, kv_lengths=P + suffix_lengths, causal=True,
                              q_offset=P).reshape(B, S, -1)
    else:
        dev = h.device
        mask = (torch.arange(kv_len, device=dev)[None, None, :]
                <= (P + torch.arange(S, device=dev))[None, :, None])
        out = _attn_core(cfg, q, k_win, v_win, mask)
    return _gate_out(p, out, gate)


@torch.inference_mode()
def prefill_continue(model: Qwen3Next, cfg: Qwen3NextConfig, input_ids, suffix_lengths,
                     cache: Qwen3NextCache, prefix_len: int, chunk_size: int = 64):
    """Prefill a right-padded suffix batch on a cached prefix (every row the
    same prefix_len: one system + rubric prefix, many suffixes). cache's
    strips must be at least prefix_len + S wide; it is updated in place.
    Returns (last valid logits [B, V], cache with length prefix_len +
    suffix_lengths)."""
    ids = _ids(model, input_ids)
    sl = _ids(model, suffix_lengths)
    B, S = ids.shape
    P = prefix_len
    dev = ids.device
    eps = cfg.rms_norm_eps
    h = model.embed(ids)
    valid = (torch.arange(S, device=dev)[None] < sl[:, None]).float()
    rope = _rope_cos_sin(cfg, (P + torch.arange(S, device=dev))[None].expand(B, S))
    for g, grp in enumerate(model.groups):
        for s, lp in enumerate(grp.lin):
            out, st = _deltanet_prefill(cfg, lp, rms_norm_zc(lp.in_norm, h, eps), valid, sl,
                                        chunk_size, True, init=(cache.conv[g, s],
                                                                cache.rec[g, s]))
            cache.conv[g, s], cache.rec[g, s] = st
            h = h + out
            h = h + _next_mlp(cfg, lp, rms_norm_zc(lp.post_norm, h, eps), False)
        fp = grp.full
        h = h + _full_attn_continue(cfg, fp, rms_norm_zc(fp.in_norm, h, eps), cache.k[g],
                                    cache.v[g], P, sl, rope)
        h = h + _next_mlp(cfg, fp, rms_norm_zc(fp.post_norm, h, eps), False)
    h = rms_norm_zc(model.final_norm, h, eps)
    cache.length = P + sl
    return _lm_head(model, cfg, h[torch.arange(B, device=dev), sl - 1]), cache


def broadcast_prefix_cache(cache: Qwen3NextCache, B: int) -> Qwen3NextCache:
    """A B = 1 prefix cache tiled across a batch (copies: rows diverge)."""
    return Qwen3NextCache(conv=cache.conv.repeat_interleave(B, 2),
                          rec=cache.rec.repeat_interleave(B, 2),
                          k=cache.k.repeat_interleave(B, 1),
                          v=cache.v.repeat_interleave(B, 1),
                          length=cache.length.repeat_interleave(B, 0))


def _continue(model, cfg, ids, suffix_lengths, cache, prefix_len: int, max_len: int,
              chunk_size: int):
    S = np.asarray(ids).shape[1]
    pad = max_len - cache.k.shape[2]
    if pad > 0:
        cache.k = F.pad(cache.k, (0, 0, 0, 0, 0, pad))
        cache.v = F.pad(cache.v, (0, 0, 0, 0, 0, pad))
    assert cache.k.shape[2] >= prefix_len + S
    return prefill_continue(model, cfg, ids, suffix_lengths, cache, prefix_len, chunk_size)


class NextPrefixStore:
    """Cross-call shared-prefix cache for judge bursts (TAC / VAS bursts
    repeat one system + rubric prefix before per-sample suffixes). An entry
    is cheap: three layers in four keep an O(1) state, one in four the
    prefix's KV. The continued computation equals a full prefill."""

    def __init__(self, max_entries: int = 8, min_prefix: int = 64, bucket: int = 64):
        self.max_entries = max_entries
        self.min_prefix = min_prefix
        self.bucket = bucket
        self._store: dict = {}
        self.hits = 0
        self.misses = 0

    def split(self, token_lists: list) -> int:
        """Longest common prefix of the burst, bucketed down; 0: none usable."""
        if len(token_lists) < 1 or not all(token_lists):
            return 0
        first = token_lists[0]
        lcp = min(len(t) for t in token_lists)
        for t in token_lists[1:]:
            i = 0
            while i < lcp and t[i] == first[i]:
                i += 1
            lcp = i
        # at least one suffix token per row (the last-logit gather)
        lcp = min(lcp, min(len(t) for t in token_lists) - 1)
        P = (lcp // self.bucket) * self.bucket
        return P if P >= self.min_prefix else 0

    def prefix_cache(self, model, cfg, prefix: tuple, chunk_size: int = 64) -> Qwen3NextCache:
        key = (id(model), prefix)
        hit = self._store.pop(key, None)
        if hit is not None:
            self._store[key] = hit       # LRU refresh
            self.hits += 1
            return hit
        self.misses += 1
        P = len(prefix)
        _, cache = prefill(model, cfg, np.asarray(prefix, np.int64)[None],
                           np.array([P]), P, chunk_size)
        self._store[key] = cache
        while len(self._store) > self.max_entries:
            self._store.pop(next(iter(self._store)))
        return cache

    @torch.inference_mode()
    def generate(self, model, cfg, token_lists: list, sp, seed: int = 0,
                 chunk_size: int = 64, spec_k: int = 0) -> NextGenResult:
        """Burst generation with shared-prefix reuse, or the plain packed
        path when the burst has no usable common prefix. spec_k > 0
        speculates (the n-gram history holds the whole prompt)."""
        from ..engine.chat import pack_prompts

        P = self.split(token_lists)
        if not P:
            packed = pack_prompts(token_lists, pad_id=cfg.pad_token_id)
            if spec_k:
                return generate_spec(model, cfg, packed.input_ids, packed.lengths, sp,
                                     spec_k=spec_k, seed=seed, chunk_size=chunk_size)
            return generate_packed(model, cfg, packed.input_ids, packed.lengths, sp,
                                   seed=seed, chunk_size=chunk_size)
        prefix = tuple(token_lists[0][:P])
        packed = pack_prompts([t[P:] for t in token_lists], pad_id=cfg.pad_token_id)
        B, S = packed.input_ids.shape
        T = sp.max_new_tokens
        W = spec_k + 1 if spec_k else 0
        # the prefix / continue chain runs in the model's dtype; under
        # kv_quant the finished prompt cache quantizes where the packed path's
        # does, so int8 bursts match generate_packed(kv_quant)
        pre_cfg = cfg.replace(kv_quant=None) if cfg.kv_quant else cfg
        cache = broadcast_prefix_cache(self.prefix_cache(model, pre_cfg, prefix, chunk_size), B)
        logits, cache = _continue(model, pre_cfg, packed.input_ids, packed.lengths, cache,
                                  P, P + S + T + W, chunk_size)
        if cfg.kv_quant == "int8":
            cache = _quantize_next_cache(cache)
        if spec_k:
            hist = np.zeros((B, P + S), np.int64)
            hist[:, :P] = np.asarray(prefix)[None]
            hist[:, P:] = packed.input_ids
            return _spec_loop(model, cfg, cache, logits, hist,
                              P + np.asarray(packed.lengths), sp, spec_k, seed)
        return _decode_tail(model, cfg, logits, cache, sp, seed)


# ------------------------------------------------- speculative decoding


def _deltanet_window(cfg: Qwen3NextConfig, p: DeltaNetLayer, h, conv_state, state):
    """A W-token DeltaNet window from a frozen state (nothing committed).
    Returns (out [B, W, H], the streams the commit replays: the raw conv
    window, post-conv k / v, g and beta). The chunked rule runs the window
    as one chunk up to 64 tokens and in 64-token chunks past that (exact for
    any chunking)."""
    B, W, _ = h.shape
    q, k, v, z, g, beta, window = _conv_streams(cfg, p, h, conv_state)
    out, _ = chunk_gated_delta_rule(q, k, v, g, beta, chunk_size=W if W <= 64 else 64,
                                    initial_state=state)
    out = rms_norm_gated(p.norm, out, z, cfg.rms_norm_eps)
    saved = {"window": window, "k": k, "v": v, "g": g, "beta": beta}
    return p.out(out.reshape(B, W, -1)), saved


def _full_attn_window(cfg: Qwen3NextConfig, p: GatedAttentionLayer, h, kv: tuple, cur, rope):
    """A W-token attention window: the whole window's K / V written at each
    row's frontier (entries past the eventual acceptance stay masked until
    written again), causal within the window."""
    q, k, v, gate = _gated_attn_qkv(cfg, p, h, rope)
    _kv_write(kv, k, v, cur)
    Smax, W = kv[0].shape[1], h.shape[1]
    dev = h.device
    mask = (torch.arange(Smax, device=dev)[None, None, :]
            <= cur[:, None, None] + torch.arange(W, device=dev)[None, :, None])
    return _gate_out(p, _kv_attn(cfg, q, kv, mask), gate)


@torch.inference_mode()
def _extend_forward(model: Qwen3Next, cfg: Qwen3NextConfig, tokens, cache,
                    prefill_chunk: bool = False):
    """Forward a [B, W] window at each row's frontier without committing the
    recurrent state. The window's K / V go into the strips in place.
    Returns (logits [B, W, V], the saved DeltaNet streams {(g, s): dict}).
    A verify window's experts take the decode route (ragged, or the GMM only
    under moe_gmm_decode); a chunk of chunked prefill (prefill_chunk) takes
    the prefill route, the GMM: the reference's decode route there, the
    exact einsum, holds a [T k, E, C] dispatch that at a 2048-token chunk
    and 512 experts fits no card."""
    B, W = tokens.shape
    h = model.embed(tokens.long())
    dev = h.device
    eps = cfg.rms_norm_eps
    rope = _rope_cos_sin(cfg, cache.length[:, None] + torch.arange(W, device=dev)[None])
    is_decode = not prefill_chunk
    saved = {}
    for g, grp in enumerate(model.groups):
        for s, lp in enumerate(grp.lin):
            out, saved[g, s] = _deltanet_window(cfg, lp, rms_norm_zc(lp.in_norm, h, eps),
                                                cache.conv[g, s], cache.rec[g, s])
            h = h + out
            h = h + _next_mlp(cfg, lp, rms_norm_zc(lp.post_norm, h, eps), is_decode)
        fp = grp.full
        h = h + _full_attn_window(cfg, fp, rms_norm_zc(fp.in_norm, h, eps), cache.kv(g),
                                  cache.length, rope)
        h = h + _next_mlp(cfg, fp, rms_norm_zc(fp.post_norm, h, eps), is_decode)
    h = rms_norm_zc(model.final_norm, h, eps)
    return _lm_head(model, cfg, h), saved


def _commit_layer(conv_s, rec_s, window, k, v, g, beta, n_adv, K: int):
    """Advance DeltaNet states through the first n_adv[b] window tokens
    (pause masking: the rest neither decay nor write); state math over the
    saved streams only, no weight reads. The batch may hold several layers'
    rows. A window of up to 64 tokens steps the recurrence token by token
    (recurrent_gated_delta_step's state update, without its output), a
    longer one (a prefill chunk) takes the chunked rule's final state."""
    B, W = g.shape[:2]
    valid = (torch.arange(W, device=g.device)[None, :] < n_adv[:, None]).float()
    g = g.float() * valid[..., None]
    beta = beta.float() * valid[..., None]
    if W > 64:
        _, rec_s = chunk_gated_delta_rule(k, k, v, g, beta, 64, initial_state=rec_s)
    else:
        k32, decay, v32 = _l2norm(k.float()), torch.exp(g), v.float()
        for t in range(W):
            rec_s = rec_s * decay[:, t, :, None, None]
            kv_mem = torch.einsum("bhk,bhkd->bhd", k32[:, t], rec_s)
            delta = (v32[:, t] - kv_mem) * beta[:, t, :, None]
            rec_s = rec_s + k32[:, t, :, :, None] * delta[..., None, :]
    return _tail_at(window, n_adv, K), rec_s


def _commit(cfg: Qwen3NextConfig, cache, saved: dict, n_adv) -> None:
    """Commit a window through n_adv [B] tokens, in place: every DeltaNet
    layer's conv tail and state in one batch (the layers' rows stacked), and
    the frontier (the KV rows are already written)."""
    G, P1, B = cache.rec.shape[:3]
    st = {n: torch.cat([saved[g, s][n] for g in range(G) for s in range(P1)])
          for n in ("window", "k", "v", "g", "beta")}
    conv, rec = _commit_layer(cache.conv.reshape(G * P1 * B, *cache.conv.shape[3:]),
                              cache.rec.reshape(G * P1 * B, *cache.rec.shape[3:]),
                              st["window"], st["k"], st["v"], st["g"], st["beta"],
                              n_adv.long().repeat(G * P1), cfg.linear_conv_kernel_dim)
    cache.conv.copy_(conv.reshape(cache.conv.shape))
    cache.rec.copy_(rec.reshape(cache.rec.shape))
    cache.length = cache.length + n_adv.long()


@torch.inference_mode()
def _spec_loop(model, cfg, cache, first_logits, prompt_hist: np.ndarray, lengths, sp,
               spec_k: int, seed: int) -> NextGenResult:
    """n-gram speculative decoding for the hybrid model (engine/spec_decode.py's
    drafting and acceptance): greedy rows keep a draft where it equals the
    argmax, so their tokens are plain greedy decode's; sampled rows accept
    by rejection sampling under the filtered target distribution. The
    recurrent state advances exactly through the emitted prefix (_commit
    replays the saved streams with pause masks). prompt_hist [B, S_in] holds
    the whole right-padded prompts (the prefix included), lengths [B] their
    true lengths."""
    from ..engine.spec_decode import _spec_accept, _spec_tok0, draft_tokens

    B, V = first_logits.shape
    T, K = sp.max_new_tokens, spec_k
    W = K + 1
    dev = first_logits.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    S_in = prompt_hist.shape[1]
    Lh = S_in + T + W
    hist = torch.zeros((B, Lh), dtype=torch.long, device=dev)
    hist[:, :S_in] = torch.as_tensor(prompt_hist, device=dev).long()
    lengths = torch.as_tensor(np.asarray(lengths), device=dev).long()
    b_idx = torch.arange(B, device=dev)
    p = torch.arange(Lh - 1, device=dev)[None, :]
    emit_i = torch.arange(W, device=dev)[None, :]
    eos = torch.as_tensor(sp.eos_token_ids, dtype=torch.long, device=dev)
    samp = (torch.full((B,), sp.temperature, dtype=torch.float32, device=dev),
            torch.full((B,), sp.top_p, dtype=torch.float32, device=dev),
            torch.full((B,), sp.top_k, dtype=torch.long, device=dev),
            torch.full((B,), sp.do_sample, dtype=torch.bool, device=dev))
    greedy_only = not sp.do_sample
    logits = first_logits.float()
    gen_len = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.full((B, T + W), sp.pad_token_id, dtype=torch.long, device=dev)
    rej = torch.full((B,), -1, dtype=torch.long, device=dev)
    it = 0
    while it < T and bool((~done & (gen_len < T)).any()):
        active = ~done
        tok0 = _spec_tok0(logits, gen, samp, active, sp.pad_token_id, rej, greedy_only)
        prev = hist[b_idx, torch.where(gen_len > 0, S_in + gen_len - 1, lengths - 1)]
        in_prompt = p + 2 + K <= lengths[:, None]
        in_gen = (p >= S_in) & (p + 2 + K <= S_in + gen_len[:, None])
        drafts = draft_tokens(hist, tok0, prev, in_prompt | in_gen, K)
        chunk = torch.cat([tok0[:, None], drafts], dim=1)               # [B, W]
        logits_w, saved = _extend_forward(model, cfg, chunk, cache)
        n_commit, logits, rej = _spec_accept(logits_w.float(), drafts, logits, active, K,
                                             samp, gen, greedy_only)
        # EOS inside the committed prefix truncates it; the budget caps it
        n_emit = torch.minimum(n_commit, T - gen_len)
        hit = (chunk[..., None] == eos).any(-1) & (emit_i < n_emit[:, None]) & active[:, None]
        eos_emitted = hit.any(dim=1)
        n_emit = torch.where(eos_emitted, hit.int().argmax(dim=1) + 1, n_emit)
        n_emit = torch.where(done, 0, n_emit)
        emit_mask = emit_i < n_emit[:, None]
        _commit(cfg, cache, saved, n_emit)        # the frontier through the emitted prefix
        idxs = gen_len[:, None] + emit_i
        out.scatter_(1, idxs, torch.where(emit_mask, chunk, out.gather(1, idxs)))
        hidx = S_in + idxs
        hist.scatter_(1, hidx, torch.where(emit_mask, chunk, hist.gather(1, hidx)))
        gen_len = gen_len + n_emit
        done = done | eos_emitted | (gen_len >= T)
        it += 1
    return NextGenResult(sequences=out[:, :T].cpu().numpy(),
                         lengths=gen_len.cpu().numpy().astype(np.int64))


@torch.inference_mode()
def generate_spec(model: Qwen3Next, cfg: Qwen3NextConfig, input_ids, lengths, sp,
                  spec_k: int = 8, seed: int = 0, chunk_size: int = 64) -> NextGenResult:
    """Speculative generation: greedy rows give generate_packed's tokens;
    sampled rows sample its distribution (rejection-sampling verification)."""
    ids = np.asarray(input_ids)
    S = ids.shape[1]
    logits, cache = prefill(model, cfg, ids, lengths, S + sp.max_new_tokens + spec_k + 1,
                            chunk_size)
    return _spec_loop(model, cfg, cache, logits, ids, np.asarray(lengths), sp, spec_k, seed)


# ---------------------------------------------------------- params / quant

# module names quantized on top of models/quant.py's defaults: the gated
# attention's q / k / v / o, the DeltaNet projections and the shared expert
# (the experts ride MOE_SUFFIXES); routing, conv, dt_bias and A_log stay float
NEXT_QUANT_SUFFIXES = (
    ("qkvz", "kernel"), ("out", "kernel"),
    ("q", "kernel"), ("k", "kernel"), ("v", "kernel"), ("o", "kernel"),
    ("shared", "gate", "kernel"), ("shared", "up", "kernel"),
    ("shared", "down", "kernel"),
)


def quantize_qwen3_next_params(model: Qwen3Next, bits: int = 8) -> Qwen3Next:
    """Weight-only int8 / int4 of the judge in place (experts int8 at any
    bits): an 80B-A3B is 160 GB in bf16."""
    from .quant import quantize_params

    return quantize_params(model, bits=bits, extra_suffixes=NEXT_QUANT_SUFFIXES)


@torch.no_grad()
def init_qwen3_next_params(cfg: Qwen3NextConfig, seed: int = 0, dtype=None,
                           device: str | torch.device = "cuda") -> Qwen3Next:
    """A frozen Qwen3Next with seeded random weights built on `device` (the
    card unless the caller asks for the CPU), drawn from a torch.Generator
    there: matrices and the embedding normal(0, 0.02), the conv
    normal(0, 0.2), dt_bias 1 + normal(0, 1), A_log log U(0.5, 8), the
    norms 0 (zero-centred) and the gated norm 1, as the JAX initialiser's
    scales."""
    dtype = dtype or cfg.dtype
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    device = torch.device(device)
    model = Qwen3Next(cfg, dtype=dtype, device=device)
    model.requires_grad_(False)
    return init_weights_(model, torch.Generator(device=device).manual_seed(seed))


@torch.no_grad()
def init_weights_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill a Qwen3Next module (or one of its layers) in place with
    init_qwen3_next_params' draws from `gen`, on the module's device."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("in_norm", "post_norm", "q_norm", "k_norm", "final_norm"):
            p.zero_()
        elif leaf == "norm":
            p.fill_(1.0)
        elif leaf == "conv":
            p.normal_(0.0, 0.2, generator=gen)
        elif leaf == "dt_bias":
            p.normal_(1.0, 1.0, generator=gen)
        elif leaf == "A_log":
            p.uniform_(0.5, 8.0, generator=gen).log_()
        else:
            p.normal_(0.0, 0.02, generator=gen)
    return module
