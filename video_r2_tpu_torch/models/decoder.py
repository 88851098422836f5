"""Text decoder of Qwen2.5-VL and of the Qwen3-MoE judge.

Port of ``video_r2_tpu/models/decoder.py``: a ModuleList of DecoderLayers
over one of two contiguous KV caches, updated in place:

- `KVCache`, seq-major [L, B, Smax, kh, hd]: prefill writes the prompt's
  rows [0, S) and attends over the whole cache width (kv_lengths mask the
  rest, as the JAX fill mode does); decode writes each step's row at one
  fixed slot for the whole batch and attends through the plain path;
- `DecodeKVCache`, head-major [L, B, kh, Smax, hd], for the decode kernel
  (ops/decode_attention.py): prefill writes each layer's k / v transposed
  into its [B, kh, Smax, hd] slice and attends over the local prompt-width
  k / v (the head-major fill); `Decoder.decode_step` writes the new row at
  slot s_pad + t and reads the layer through the kernel;
- `QuantKVCache`, seq-major int8 [L, B, Smax, kh, hd] with fp32 absmax
  scales [L, B, Smax, kh] (`quantize_kv`): a causal call (prefill) stores
  the prompt's rows quantized and attends over the local bf16 k / v (the
  quantized fill), a decode step stores its row quantized and attends over
  the whole int8 cache through ops/attention.py::quant_dot_product_attention.

Without a cache the decoder is the training forward (``decoder_forward``
with ``remat``: each layer is recomputed in the backward).

Qwen3 layers (cfg.qk_norm, cfg.attention_bias False, cfg.head_dim_override)
RMS-normalise q and k per head before rotary; cfg.num_experts > 0 makes the
MLP a sparse MoE block (MoEMLP, models/moe.py). act_quant="int8" runs the
int8 linears W8A8, q/k/v sharing one activation quantization; int4 linears
take no act_quant, and neither does the kernel decode step, as in the
reference. Each layer's attention inputs (`DecoderLayer.qkv`) and what
follows its attention (`DecoderLayer.finish`) are the helpers the decode
step and the serving engines reuse. The reference's index-scan over
stacked int4 views (``_stacked_quant_view``) has no counterpart: each layer
holds its own int4 leaves, which the int4 kernel reads in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention, quant_dot_product_attention
from ..ops.decode_attention import decode_attention_stacked, decode_attention_stacked_plain
from .config import TextConfig
from .layers import MLP, ExpertLinear, Linear, RMSNorm, apply_rotary, quantize_act
from .moe import moe_mlp


@dataclass
class KVCache:
    k: torch.Tensor  # [L, B, Smax, kv_heads, head_dim]
    v: torch.Tensor

    @classmethod
    def init(cls, cfg: TextConfig, batch: int, max_len: int, dtype,
             device) -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, max_len,
                 cfg.num_key_value_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    def batch_slice(self, start: int, stop: int) -> "KVCache":
        """A view of rows [start, stop): writes through it land in self."""
        return KVCache(self.k[:, start:stop], self.v[:, start:stop])


@dataclass
class DecodeKVCache:
    """Head-major stacked cache for the decode kernel: one (layer, sequence,
    kv head) is a contiguous [Smax, hd] run the kernel reads block by block,
    the layer picked by index, so no per-layer slice is copied."""

    k: torch.Tensor  # [L, B, kv_heads, Smax, head_dim]
    v: torch.Tensor

    @classmethod
    def init(cls, cfg: TextConfig, batch: int, max_len: int, dtype,
             device) -> "DecodeKVCache":
        shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads,
                 max_len, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


@dataclass
class QuantKVCache:
    """int8 seq-major cache with per-(token, head) absmax scales: half the
    bytes of a bf16 cache. quant_dot_product_attention applies the scales to
    scores and probabilities, not to the values, but each decode step still
    forms, for each layer, an fp32 copy of k (twice a bf16 cache's bytes)
    and a bf16 copy of v, so its attention costs more than a bf16 cache's."""

    k: torch.Tensor        # [L, B, Smax, kv_heads, head_dim] int8
    v: torch.Tensor
    k_scale: torch.Tensor  # [L, B, Smax, kv_heads] float32
    v_scale: torch.Tensor

    @classmethod
    def init(cls, cfg: TextConfig, batch: int, max_len: int, device) -> "QuantKVCache":
        shape = (cfg.num_hidden_layers, batch, max_len,
                 cfg.num_key_value_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                   torch.zeros(shape[:-1], dtype=torch.float32, device=device))

    def batch_slice(self, start: int, stop: int) -> "QuantKVCache":
        """A view of rows [start, stop): writes through it land in self."""
        return QuantKVCache(*(x[:, start:stop] for x in
                              (self.k, self.v, self.k_scale, self.v_scale)))


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, *, dtype, device):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty((vocab, dim), dtype=dtype,
                                                  device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class DecoderAttention(nn.Module):
    def __init__(self, cfg: TextConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        H, hd = cfg.hidden_size, cfg.head_dim
        qd, kvd = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
        bias = cfg.attention_bias
        self.q = Linear(H, qd, bias, **kw)
        self.k = Linear(H, kvd, bias, **kw)
        self.v = Linear(H, kvd, bias, **kw)
        self.o = Linear(qd, H, False, **kw)
        if cfg.qk_norm:   # Qwen3: per-head RMS norm of q and k, before rotary
            self.q_norm = RMSNorm(hd, cfg.rms_norm_eps, **kw)
            self.k_norm = RMSNorm(hd, cfg.rms_norm_eps, **kw)


class Experts(nn.Module):
    def __init__(self, cfg: TextConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        E, H, I = cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size
        self.gate = ExpertLinear(E, H, I, **kw)
        self.up = ExpertLinear(E, H, I, **kw)
        self.down = ExpertLinear(E, I, H, **kw)


class MoEMLP(nn.Module):
    """Sparse MoE block: router [H, E] and experts {gate, up} [E, H, I],
    down [E, I, H], in the JAX package's leaf names. ffn_impl="plain" runs
    the grouped FFN's plain version on the card, forward and backward (the
    reference path). gmm_prefill starts as the config's flag; the
    full-parameter SFT step turns it off while it runs (train/sft.py), so
    that step trains through the einsum as the reference's does."""

    def __init__(self, cfg: TextConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.router = Linear(cfg.hidden_size, cfg.num_experts, False, **kw)
        self.experts = Experts(cfg, **kw)
        self.ffn_impl = "kernel"
        self.gmm_prefill = cfg.moe_gmm_prefill

    def params(self) -> dict:
        ex = self.experts
        return {"router": {"kernel": self.router.kernel},
                "experts": {"gate": ex.gate.leaf(), "up": ex.up.leaf(),
                            "down": ex.down.leaf()}}

    def forward(self, x: torch.Tensor, act_quant: str | None = None) -> torch.Tensor:
        cfg = self.cfg
        return moe_mlp(self.params(), x, cfg.num_experts_per_tok, cfg.norm_topk_prob,
                       capacity_factor=cfg.moe_capacity_factor,
                       group_size=cfg.moe_group_size, act_quant=act_quant,
                       ragged_decode=cfg.moe_ragged_decode,
                       gmm_prefill=self.gmm_prefill, ffn_impl=self.ffn_impl)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TextConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, **kw)
        self.attn = DecoderAttention(cfg, **kw)
        self.mlp = (MoEMLP(cfg, **kw) if cfg.num_experts
                    else MLP(cfg.hidden_size, cfg.intermediate_size, False, **kw))

    def qkv(self, x, cos, sin, act_quant: str | None = None):
        """Attention inputs of x [N, S, H]: the input norm, q / k / v (one
        shared activation quantization under W8A8), the Qwen3 qk-norm and
        rotary. Returns q [N, S, nh, hd], k, v [N, S, kh, hd]."""
        N, S, _ = x.shape
        cfg, attn = self.cfg, self.attn
        nh, kh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        h = self.input_layernorm(x)
        pq = (quantize_act(h) if act_quant == "int8" and attn.q.kernel_q is not None
              else None)
        q = attn.q(h, act_quant, pq).reshape(N, S, nh, hd)
        k = attn.k(h, act_quant, pq).reshape(N, S, kh, hd)
        v = attn.v(h, act_quant, pq).reshape(N, S, kh, hd)
        if cfg.qk_norm:
            q, k = attn.q_norm(q), attn.k_norm(k)
        q, k = apply_rotary(q, k, cos[:, :, None, :], sin[:, :, None, :])
        return q, k, v

    def finish(self, x, attn, act_quant: str | None = None):
        """The rest of the layer after attention [N, S, nh, hd]: output
        projection and residual, post-attention norm, MLP and residual."""
        N, S = x.shape[:2]
        x = x + self.attn.o(attn.reshape(N, S, -1), act_quant)
        return x + self.mlp(self.post_attention_layernorm(x), act_quant)

    def forward(self, x, cos, sin, bias, k_cache=None, v_cache=None,
                cache_position: int | torch.Tensor = 0, attn_impl: str = "xla",
                kv_lengths=None, causal: bool = False, act_quant: str | None = None,
                head_major: bool = False, kv_scales=None, segment_ids=None):
        """k_cache / v_cache: this layer's cache, written in place at
        [cache_position, cache_position + S) (a [B] tensor cache_position:
        row b's at [pos_b, pos_b + S); seq-major caches only): seq-major
        [B, Smax, kh, hd],
        attended over whole, or (head_major) [B, kh, Smax, hd], with the
        attention over the local k / v; None attends over the local k / v.
        kv_scales: this layer's (k_scale, v_scale) [B, Smax, kh] of an int8
        cache, written with it; a causal call (the fill) then attends over
        the local k / v, any other over the whole int8 cache with `bias`.
        segment_ids [B, S]: key j is admitted for query i only where
        segment_ids[b, i] == segment_ids[b, j] (the flash kernel's segment
        masking), without a cache (the training forward) and in a fill from
        position 0 (packed admission): a seq-major fill with segment ids
        attends over the local k / v, which the ids index."""
        S = x.shape[1]
        q, k, v = self.qkv(x, cos, sin, act_quant)
        if torch.is_tensor(cache_position):
            # per-row frontiers [B]: row b's S tokens land at [pos_b, pos_b + S)
            # (speculative decoding's verify chunks)
            span = (torch.arange(x.shape[0], device=x.device)[:, None],
                    cache_position.to(x.device).long()[:, None]
                    + torch.arange(S, device=x.device))
        else:
            span = (slice(None), slice(cache_position, cache_position + S))
        if kv_scales is not None:
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            k_cache[span], v_cache[span] = kq, vq
            kv_scales[0][span], kv_scales[1][span] = ks, vs
            if not causal:
                attn = quant_dot_product_attention(q, k_cache, kv_scales[0], v_cache,
                                                   kv_scales[1], bias)
                return self.finish(x, attn, act_quant)
        elif head_major:
            k_cache[:, :, cache_position:cache_position + S] = k.transpose(1, 2)
            v_cache[:, :, cache_position:cache_position + S] = v.transpose(1, 2)
        elif k_cache is not None:
            k_cache[span] = k
            v_cache[span] = v
            if segment_ids is None:
                k, v = k_cache, v_cache
            elif torch.is_tensor(cache_position) or cache_position != 0:
                raise ValueError("segment_ids need a fill from cache position 0")
        attn = dot_product_attention(q, k, v, bias=bias, kv_lengths=kv_lengths,
                                     causal=causal, impl=attn_impl,
                                     segment_ids=segment_ids)
        return self.finish(x, attn, act_quant)


class Decoder(nn.Module):
    def __init__(self, cfg: TextConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(DecoderLayer(cfg, **kw)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.decode_attn_impl = "kernel"   # "plain": decode_step's attention
                                           # through the kernel's plain version

    def forward(self, hidden, cos, sin, bias,
                cache: KVCache | DecodeKVCache | QuantKVCache | None = None,
                cache_position: int | torch.Tensor = 0, attn_impl: str = "xla",
                kv_lengths=None, causal: bool = False,
                remat: bool = False, act_quant: str | None = None,
                segment_ids: torch.Tensor | None = None) -> torch.Tensor:
        """hidden [B, S, H] input embeddings, cos/sin [B, S, head_dim],
        bias [B, 1, S, Skv] additive or None. cache_position: the first row
        the S tokens' k / v take, or per-row frontiers [B] (a KVCache or
        QuantKVCache: row b's tokens at [pos_b, pos_b + S), the verify
        chunks of speculative decoding). Returns the final-normed hidden
        [B, S, H]; `cache` (if given) is updated in place (a DecodeKVCache by
        the head-major fill, with bias None; a QuantKVCache by the quantized
        fill when causal, with bias None, else by a decode step). remat:
        under autograd, keep only each layer's input and recompute the layer
        in the backward (gradient checkpointing). act_quant="int8": W8A8 on
        int8 weights. segment_ids [B, S] (no cache, or a fill from position
        0 into any of the three caches): attention stays within a segment,
        as the JAX decoder_forward's segment_ids; under remat they travel as
        an argument of the checkpointed layer."""
        head_major = isinstance(cache, DecodeKVCache)
        quant = isinstance(cache, QuantKVCache)
        for i, layer in enumerate(self.layers):
            kc, vc = (cache.k[i], cache.v[i]) if cache is not None else (None, None)
            scales = (cache.k_scale[i], cache.v_scale[i]) if quant else None
            args = (hidden, cos, sin, bias, kc, vc, cache_position, attn_impl,
                    kv_lengths, causal, act_quant, head_major, scales, segment_ids)
            if remat and torch.is_grad_enabled():
                hidden = checkpoint(layer, *args, use_reentrant=False)
            else:
                hidden = layer(*args)
        return self.norm(hidden)

    def decode_step(self, hidden, cos, sin, cache: DecodeKVCache,
                    lengths: torch.Tensor, s_pad: int, t: int) -> torch.Tensor:
        """One decode token hidden [B, 1, H] through every layer with the
        decode kernel: each layer writes its new k / v row at slot s_pad + t
        of the head-major cache, in place, then attends over keys
        [0, lengths[b]) and [s_pad, s_pad + t] of that layer. No act_quant,
        as in the reference. Returns the final-normed hidden [B, 1, H]."""
        slot = s_pad + t
        attend = (decode_attention_stacked if self.decode_attn_impl == "kernel"
                  else decode_attention_stacked_plain)
        for i, layer in enumerate(self.layers):
            q, k, v = layer.qkv(hidden, cos, sin)
            cache.k[i, :, :, slot] = k[:, 0]
            cache.v[i, :, :, slot] = v[:, 0]
            attn = attend(q[:, 0], cache.k, cache.v, lengths, slot_end=slot, layer=i,
                          s_pad=s_pad)
            hidden = layer.finish(hidden, attn[:, None])
        return self.norm(hidden)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] -> (int8 values, float32 absmax scale over hd), the JAX
    package's scheme: scale = max(absmax, 1e-8) / 127, values rounded half
    to even (torch.round, like jnp.round)."""
    x32 = x.float()
    s = torch.clamp(x32.abs().amax(dim=-1), min=1e-8) / 127.0
    return torch.round(x32 / s[..., None]).to(torch.int8), s


def causal_mask_bias(seq_len: int, attention_mask: torch.Tensor | None,
                     device=None) -> torch.Tensor:
    """[B, 1, S, S] additive bias: causal + padding."""
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    allowed = (j <= i)[None]
    if attention_mask is not None:
        allowed = allowed & (attention_mask.to(device)[:, None, :] == 1)
    return torch.where(allowed[:, None], 0.0, -1e30)
