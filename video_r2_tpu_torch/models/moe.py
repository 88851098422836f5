"""Mixture-of-Experts MLP (the judge-model family, Qwen3-MoE).

Port of ``video_r2_tpu/models/moe.py``: top-k routing with a float32 router
(softmax over all experts, top-k, optional renormalisation: HF
Qwen3MoeSparseMoeBlock semantics), experts stacked on an [E] axis. `moe_mlp`
branches exactly as the reference does:

- small steps (T <= RAGGED_MAX_TOKENS, cfg.moe_ragged_decode) go through the
  ragged active-expert path (ops/moe_ragged.py);
- other steps with cfg.moe_gmm_prefill go through the sorted grouped matmul
  (ops/moe_gmm.py); both run the hand-written grouped FFN kernel on the card.
  Float expert weights take the GMM's differentiable wrapper, whose backward
  runs the GMM backward kernels; the ragged path and int8 / W8A8 weights
  have no backward, so their kernels refuse a call under autograd on the
  card (their plain versions on the CPU differentiate);
- everything else takes the grouped einsum: tokens in fixed-size groups,
  [G, n k, E, C] dispatch / combine one-hots, capacity C per expert and
  group, over-capacity slots dropped (capacity_factor 0: no drops).

W8A8 (act_quant="int8") rides the kernels only with int8 expert weights
(the `aq_ok` rule); int8 activations with float weights take the einsum.
A mesh raises NotImplementedError until the parallelism port. The params
are plain dicts of tensors in the JAX package's layout: {"router":
{"kernel" [H, E]}, "experts": {"gate" / "up" [E, H, I], "down" [E, I, H]}},
each expert leaf {"kernel"} or {"kernel_q" int8, "scale" [E, N]}.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# moe_mlp(ragged_decode=True) takes the active-experts-only path up to this
# many tokens per step
RAGGED_MAX_TOKENS = 32


def _capacity(group: int, num_experts: int, k: int, capacity_factor: float) -> int:
    if capacity_factor <= 0:
        return group * k                      # full: no token ever drops
    c = int(-(-group * k * capacity_factor // num_experts))
    return max(k, min(c, group * k))


def route(router_kernel: torch.Tensor, x: torch.Tensor, k: int,
          norm_topk_prob: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing. x [T, H] -> (weights [T, k] in x's dtype, ids [T, k]).
    Router logits and softmax in float32; ties go to the lower expert id,
    as in jax.lax.top_k (a stable descending sort: torch.topk breaks ties
    in no fixed order, and zero pad rows tie everywhere)."""
    logits = x.float() @ router_kernel.float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    if norm_topk_prob:
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return topv.to(x.dtype), topi


def _expert_matmul(x: torch.Tensor, leaf: dict, eq: str,
                   act_quant: str | None) -> torch.Tensor:
    """x [G, E, C, K] @ expert kernels [E, K, N] -> [G, E, C, N]. int8
    weights convert inside the product, their per-output-channel scale on
    the output; act_quant="int8" on int8 weights: int8 x int8 products,
    exact in float64, times the row and channel scales."""
    if act_quant == "int8" and "kernel_q" in leaf:
        from ..ops.moe_ragged import quantize_rows

        xq, a = quantize_rows(x, keepdims=True)
        y = torch.einsum(eq, xq.double(), leaf["kernel_q"].double()).float()
        y = y * a * leaf["scale"].float()[None, :, None, :]
        return y.to(x.dtype)
    if "kernel_q" in leaf:
        y = torch.einsum(eq, x, leaf["kernel_q"].to(x.dtype))
        return y * leaf["scale"].to(y.dtype)[None, :, None, :]
    return torch.einsum(eq, x, leaf["kernel"])


def _keep_mask(topi, G: int, n: int, E: int, C: int):
    """(ids [G, nk], pos [G, nk] position within expert, keep [G, nk]).
    Token-major flattening: all of token i's slots claim capacity before
    token i + 1's; slots whose position reaches C drop."""
    k = topi.shape[-1]
    ids = topi.reshape(G, n * k)
    oh_e = F.one_hot(ids, E)                           # [G, nk, E]
    pos = torch.cumsum(oh_e, dim=1) - 1
    pos = pos.gather(2, ids[..., None])[..., 0]
    return ids, pos, pos < C


def _dispatch_tensors(topi, topv, G: int, n: int, E: int, C: int, dtype):
    """Group-view dispatch / combine tensors [G, nk, E, C] + keep mask."""
    k = topi.shape[-1]
    ids, pos, keep = _keep_mask(topi, G, n, E, C)
    w = topv.reshape(G, n * k)
    oh_c = F.one_hot(torch.where(keep, pos, C), C + 1)[..., :C].to(dtype)
    disp = F.one_hot(ids, E).to(dtype)[..., None] * oh_c[..., None, :]
    comb = disp * w[..., None, None]
    return disp, comb, keep


def capacity_drop_stats(p: dict, x: torch.Tensor, num_experts_per_tok: int,
                        norm_topk_prob: bool = True, capacity_factor: float = 0.0,
                        group_size: int = 256) -> dict:
    """What fraction of routing slots, and of router weight mass, this
    (batch, capacity_factor) drops: {slot_drop_rate, weight_drop_rate,
    capacity, expert_max_fill}, from the same keep computation as moe_mlp."""
    B, S, H = x.shape if x.dim() == 3 else (1, *x.shape)
    xt = x.reshape(B * S, H)
    k = num_experts_per_tok
    E = p["router"]["kernel"].shape[-1]
    T = B * S
    n = min(group_size, T)
    G = -(-T // n)
    pad = G * n - T
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    topv, topi = route(p["router"]["kernel"], xt, k, norm_topk_prob)
    C = _capacity(n, E, k, capacity_factor)
    _, _, keep = _keep_mask(topi, G, n, E, C)
    keep = keep.reshape(-1)[:T * k]
    w = topv.reshape(-1)[:T * k].float()
    slot_drop = 1.0 - float(keep.float().mean())
    weight_drop = 1.0 - float(torch.where(keep, w, 0.0).sum()
                              / torch.clamp(w.sum(), min=1e-9))
    fill = F.one_hot(topi.reshape(G, n * k), E).sum(1)
    return {"slot_drop_rate": slot_drop, "weight_drop_rate": weight_drop,
            "capacity": C, "expert_max_fill": int(fill.max())}


def moe_mlp(p: dict, x: torch.Tensor, num_experts_per_tok: int,
            norm_topk_prob: bool = True, capacity_factor: float = 0.0,
            group_size: int = 256, act_quant: str | None = None,
            ragged_decode: bool = False, mesh=None, gmm_prefill: bool = False,
            ffn_impl: str = "kernel") -> torch.Tensor:
    """Sparse MoE feed-forward over x [B, S, H]. ffn_impl="plain" runs the
    grouped FFN's plain version on the fast paths instead of the kernel, and
    the GMM backward's plain versions (the reference path chip_smoke.py holds
    the kernel path against)."""
    if mesh is not None:
        raise NotImplementedError("sharded MoE (mesh) is not ported to the PyTorch "
                                  "package yet")
    B, S, H = x.shape
    k = num_experts_per_tok
    E = p["router"]["kernel"].shape[-1]
    T = B * S
    xt = x.reshape(T, H)

    # W8A8 rides the kernels only with int8 weights; int8 activations with
    # float weights have no kernel: einsum then
    quant_w = "kernel_q" in p["experts"]["gate"]
    aq_ok = act_quant != "int8" or quant_w
    kernel_aq = act_quant if quant_w else None

    if ragged_decode and T <= RAGGED_MAX_TOKENS and aq_ok:
        from ..ops.moe_ragged import moe_mlp_ragged

        return moe_mlp_ragged(p, xt, k, norm_topk_prob, act_quant=kernel_aq,
                              ffn_impl=ffn_impl).reshape(B, S, H)
    if gmm_prefill and aq_ok:
        from ..ops.moe_gmm import moe_mlp_gmm, moe_mlp_gmm_diff

        if quant_w:
            return moe_mlp_gmm(p, xt, k, norm_topk_prob, act_quant=kernel_aq,
                               ffn_impl=ffn_impl).reshape(B, S, H)
        # float weights: the differentiable wrapper, the same forward
        return moe_mlp_gmm_diff(p, xt, k, norm_topk_prob,
                                ffn_impl=ffn_impl).reshape(B, S, H)

    n = min(group_size, T)
    G = -(-T // n)
    Tp = G * n
    if Tp != T:   # pad the tail group; padded tokens route but combine to 0
        xt = F.pad(xt, (0, 0, 0, Tp - T))
    topv, topi = route(p["router"]["kernel"], xt, k, norm_topk_prob)
    C = _capacity(n, E, k, capacity_factor)
    disp, comb, _ = _dispatch_tensors(topi, topv, G, n, E, C, x.dtype)
    xg = xt.reshape(G, n, H)
    disp_t = disp.reshape(G, n, k, E, C).sum(2)
    expert_in = torch.einsum("gnec,gnh->gech", disp_t, xg)
    ex = p["experts"]
    hmid = (F.silu(_expert_matmul(expert_in, ex["gate"], "gech,ehi->geci", act_quant))
            * _expert_matmul(expert_in, ex["up"], "gech,ehi->geci", act_quant))
    expert_out = _expert_matmul(hmid, ex["down"], "geci,eih->gech", act_quant)
    comb_t = comb.reshape(G, n, k, E, C).sum(2)
    out = torch.einsum("gnec,gech->gnh", comb_t, expert_out)
    return out.reshape(Tp, H)[:T].reshape(B, S, H)


def moe_mlp_train(p: dict, x: torch.Tensor, num_experts_per_tok: int,
                  norm_topk_prob: bool = True, capacity_factor: float = 0.0,
                  group_size: int = 256, ffn_impl: str = "kernel") -> torch.Tensor:
    """The MoE route of a training loss (models/qwen3_next.py::next_loss),
    differentiable in x and the router over float or int8 experts.

    A known difference from the reference: its next_loss turns the ragged
    and GMM routes off, so every MoE layer takes the grouped einsum. At
    capacity_factor 0 the einsum drops no slot and computes the same
    function as the sorted grouped matmul, but its [G, n k, E, C] dispatch
    tensors do not fit one card at the Qwen3-Next judge's shapes (E 512,
    top 10, groups of 256: C 2560, 6.7 GB a group in bf16, 16 groups in a
    4096-token batch). So at capacity 0 this takes the GMM
    (ops/moe_gmm.py::moe_mlp_gmm_diff: its backward runs the dX kernel, over
    the experts dequantized for the call when they are int8, and forms no
    expert gradient for int8); with capacity_factor > 0 the einsum, which
    drops over-capacity slots as the reference does. ffn_impl="plain" runs
    the plain versions of the GMM's kernels."""
    if capacity_factor <= 0:
        from ..ops.moe_gmm import moe_mlp_gmm_diff

        B, S, H = x.shape
        return moe_mlp_gmm_diff(p, x.reshape(B * S, H), num_experts_per_tok, norm_topk_prob,
                                ffn_impl=ffn_impl).reshape(B, S, H)
    return moe_mlp(p, x, num_experts_per_tok, norm_topk_prob, capacity_factor, group_size,
                   ffn_impl=ffn_impl)


def moe_mlp_dense_oracle(p: dict, x: torch.Tensor, num_experts_per_tok: int,
                         norm_topk_prob: bool = True) -> torch.Tensor:
    """Reference semantics (the HF expert loop): every token's top-k experts
    computed densely. Test oracle only."""
    B, S, H = x.shape
    xt = x.reshape(-1, H)
    topv, topi = route(p["router"]["kernel"], xt, num_experts_per_tok, norm_topk_prob)
    ex = p["experts"]
    wg, wu, wd = ex["gate"]["kernel"], ex["up"]["kernel"], ex["down"]["kernel"]
    out = torch.zeros_like(xt)
    for e in range(wg.shape[0]):
        fe = (F.silu(xt @ wg[e]) * (xt @ wu[e])) @ wd[e]
        we = torch.where(topi == e, topv, 0.0).sum(-1)
        out = out + fe * we[:, None]
    return out.reshape(B, S, H)


def load_balancing_loss(router_kernel: torch.Tensor, x: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Switch-style auxiliary load-balance loss: E sum_e f_e P_e / k, f_e the
    fraction of tokens whose top-k holds expert e, P_e the mean router
    probability."""
    T = x.shape[0] * x.shape[1] if x.dim() == 3 else x.shape[0]
    xt = x.reshape(T, -1)
    probs = torch.softmax(xt.float() @ router_kernel.float(), dim=-1)
    E = probs.shape[-1]
    topi = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    f = F.one_hot(topi, E).float().sum(1).mean(0)
    return E * (f * probs.mean(0)).sum() / k
