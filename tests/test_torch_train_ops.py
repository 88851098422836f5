"""The port's training ops against the JAX package's, on the CPU.

On CPU tensors the attention wrappers run their plain PyTorch versions; each
is held against the JAX Pallas kernels run in interpret mode on the same
numpy inputs, in float32:

- the flash forward-with-LSE and backward against ``_flash_call(with_lse)``
  and ``jax.grad`` through ``flash_attention``: rtol = atol = 5e-4, the JAX
  package's own kernel-gradient tolerance (tests/test_ops.py);
- the window backward against ``jax.grad`` through ``window_attention``:
  2e-4, as in tests/test_ops.py;
- the fused CE against the JAX op: 1e-5 (float32 chunk sums in another
  order);
- the autograd wiring (the Functions the card runs, with their plain steps)
  against torch.autograd through the plain forward alone: 1e-5.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_r2_tpu.ops import flash as jflash
from video_r2_tpu.ops.fused_ce import fused_linear_cross_entropy as j_fused_ce
from video_r2_tpu.ops.vit_window_attention import window_attention as j_window
from video_r2_tpu_torch.ops.flash import (
    NO_KEY_LSE,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd_lse,
    flash_attention_plain,
)
from video_r2_tpu_torch.ops.fused_ce import IGNORE_INDEX, fused_linear_cross_entropy
from video_r2_tpu_torch.ops.vit_window_attention import (
    window_attention,
    window_attention_bwd,
    window_attention_plain,
)

GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
WINDOW_TOL = dict(rtol=2e-4, atol=2e-4)
T = torch.from_numpy


def _jax_flash_lse(q, k, v, lengths, causal, seg, block=64):
    """The JAX forward-with-LSE kernel (interpret mode) on padded head-major
    operands, as flash_attention lays them out: lse [B, nh, Sq]."""
    B, Sq, nh, hd = q.shape
    Sk, kh = k.shape[1], k.shape[2]
    pq, pk = (-Sq) % block, (-Sk) % block
    pad = lambda x, n: np.pad(x, ((0, 0), (0, n), (0, 0), (0, 0)))  # noqa: E731
    qt, kt, vt = (jnp.asarray(pad(x, n).transpose(0, 2, 1, 3))
                  for x, n in ((q, pq), (k, pk), (v, pk)))
    if seg is None:
        qseg, kseg = np.zeros((B, Sq + pq), np.int32), np.zeros((B, Sk + pk), np.int32)
    else:
        qseg = np.pad(seg, ((0, 0), (0, pq)), constant_values=-1)
        kseg = np.pad(seg, ((0, 0), (0, pk)), constant_values=-2)
    _, lse = jflash._flash_call(
        jnp.asarray(lengths), qt, kt, vt, jnp.asarray(qseg), jnp.asarray(kseg),
        causal=causal, q_offset=0, block_q=block, block_k=block, g=nh // kh,
        has_segments=seg is not None, interpret=True, with_lse=True)
    return np.asarray(lse)[:, :, :Sq, 0]


def _jax_flash_grads(q, k, v, cot, lengths, causal, seg):
    def loss(q, k, v):
        out = jflash.flash_attention(
            q, k, v, kv_lengths=jnp.asarray(lengths), causal=causal,
            segment_ids=None if seg is None else jnp.asarray(seg),
            block_q=64, block_k=64, interpret=True)
        return jnp.sum(out * cot), out
    grads, out = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", ["causal_gqa_ragged", "segments"])
def test_flash_fwd_lse_and_bwd_plain_match_jax(rng, case):
    """Decoder training shape (causal, GQA, ragged lengths, one row with no
    key) and the ViT's full attention (non-causal, valid slots 1, pad -2)."""
    B, S, nh, kh, hd = 3, 160, 4, 2, 16
    q, k, v, cot = (rng.normal(size=(B, S, n, hd)).astype(np.float32)
                    for n in (nh, kh, kh, nh))
    if case == "segments":
        causal, lengths = False, np.full(B, S, np.int32)
        seg = np.where(rng.random((B, S)) < 0.8, 1, -2).astype(np.int32)
    else:
        causal, lengths, seg = True, np.array([S, 97, 0], np.int32), None
    ref_out, ref_grads = _jax_flash_grads(q, k, v, cot, lengths, causal, seg)
    ref_lse = _jax_flash_lse(q, k, v, lengths, causal, seg)
    seg_t = None if seg is None else T(seg)
    out, lse = flash_attention_fwd_lse(T(q), T(k), T(v), T(lengths), causal, 0, seg_t)
    np.testing.assert_allclose(out.numpy(), ref_out, **GRAD_TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **GRAD_TOL)
    if case != "segments":
        assert (lse[2] == NO_KEY_LSE).all()     # the batch row with no key
    grads = flash_attention_bwd(T(q), T(k), T(v), out, T(cot), lse, T(lengths),
                                causal, 0, seg_t)
    for name, ours, ref in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(ours.numpy(), ref, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("q_offset", [60, 25])
def test_flash_bwd_plain_matches_jax_kernels_at_an_offset(rng, q_offset):
    """The context-parallel form (causal, Sq < Sk, query row 0 at global
    position q_offset): the plain backward against the JAX package's
    _flash_bwd_kernels (interpret mode) on the same out / lse, given to
    both; operands padded head-major as flash_attention lays them out (pad
    rows: zero dout and NO_KEY_LSE, so they add nothing)."""
    B, Sq, Sk, nh, kh, hd, blk = 2, 100, 160, 4, 2, 16, 64
    q, dout = (rng.normal(size=(B, Sq, nh, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, Sk, kh, hd)).astype(np.float32) for _ in range(2))
    lengths = np.array([Sk, 130], np.int32)
    out, lse = flash_attention_fwd_lse(T(q), T(k), T(v), T(lengths), True, q_offset)
    ours = flash_attention_bwd_plain(T(q), T(k), T(v), out, T(dout), lse, T(lengths), True,
                                     q_offset)
    pq, pk = (-Sq) % blk, (-Sk) % blk
    head_major = lambda x, n: jnp.asarray(  # noqa: E731
        np.pad(x, ((0, 0), (0, n), (0, 0), (0, 0))).transpose(0, 2, 1, 3))
    lse_p = np.pad(lse.numpy(), ((0, 0), (0, 0), (0, pq)), constant_values=NO_KEY_LSE)
    dq, dk, dv = jflash._flash_bwd_kernels(
        head_major(q, pq), head_major(k, pk), head_major(v, pk), head_major(dout, pq),
        head_major(out.numpy(), pq), jnp.asarray(lse_p[..., None]), jnp.asarray(lengths),
        jnp.zeros((B, Sq + pq), jnp.int32), jnp.zeros((B, Sk + pk), jnp.int32),
        causal=True, q_offset=q_offset, block_q=blk, block_k=blk, g=nh // kh,
        has_segments=False, interpret=True)
    refs = [np.asarray(x).transpose(0, 2, 1, 3)[:, :n] for x, n in ((dq, Sq), (dk, Sk), (dv, Sk))]
    for name, a, b in zip("qkv", ours, refs):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("hd", [16, 80])
def test_window_bwd_plain_matches_jax(rng, hd):
    """A ragged window, a window with one valid slot and a fully invalid
    one, at a small head dim and the ViT's (80); the loss reads valid rows
    only, as the ViT's does (pad rows never reach its output)."""
    wp, nh, S = 64, 4, 512
    q, k, v, cot = (rng.normal(size=(S, nh, hd)).astype(np.float32) for _ in range(4))
    valid = np.ones(S, bool)
    valid[40:wp] = False             # ragged window
    valid[3 * wp: 4 * wp - 1] = False  # one valid slot (the window's last)
    valid[-wp:] = False              # whole final window invalid
    cot = cot * valid[:, None, None]

    def loss(q, k, v):
        return jnp.sum(j_window(q, k, v, jnp.asarray(valid), wp=wp,
                                interpret=True) * cot)
    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ours = window_attention_bwd(T(q), T(k), T(v), T(valid), T(cot), wp)
    for name, a, b in zip("qkv", ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **WINDOW_TOL)
        assert not a[-wp:].any(), name   # the invalid window: zero gradients


@pytest.mark.parametrize("case", ["mixed", "all_ignored"])
def test_fused_ce_matches_jax(rng, case):
    N, H, V, chunk = 50, 16, 40, 16
    hidden = rng.normal(size=(N, H)).astype(np.float32)
    weight = (rng.normal(size=(H, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[rng.random(N) < 0.3] = IGNORE_INDEX
    if case == "all_ignored":
        labels[:] = IGNORE_INDEX
    ref_loss, (ref_dh, ref_dw) = jax.value_and_grad(
        lambda h, w: j_fused_ce(h, w, jnp.asarray(labels), chunk), argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(weight))
    h = T(hidden).requires_grad_()
    w = T(weight).requires_grad_()
    loss = fused_linear_cross_entropy(h, w, T(labels), chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(ref_dh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(ref_dw), rtol=1e-5, atol=1e-6)
    # a frozen head: no weight gradient is formed, the hidden one is the same
    h2 = T(hidden).requires_grad_()
    fused_linear_cross_entropy(h2, T(weight), T(labels), chunk).backward()
    torch.testing.assert_close(h2.grad, h.grad, rtol=0, atol=0)


def _autograd(fn, inputs, cot):
    xs = [x.clone().requires_grad_() for x in inputs]
    out = fn(*xs)
    return out, torch.autograd.grad((out * cot).sum(), xs)


@pytest.mark.parametrize("case", ["flash", "flash_segments", "window"])
def test_autograd_functions_match_plain_autograd(rng, case):
    """The Functions (plain steps on the CPU) against torch.autograd through
    the plain forward alone."""
    if case == "window":
        S, nh, hd = 192, 2, 8
        q, k, v, cot = (T(rng.normal(size=(S, nh, hd)).astype(np.float32))
                        for _ in range(4))
        valid = T(rng.random(S) < 0.8)
        valid[-64:] = False
        cot = cot * valid[:, None, None]
        fn = lambda *x: window_attention(*x, valid)  # noqa: E731
        plain = lambda *x: window_attention_plain(*x, valid)  # noqa: E731
    else:
        B, S, nh, kh, hd = 2, 70, 4, 2, 8
        q, k, v, cot = (T(rng.normal(size=(B, S, n, hd)).astype(np.float32))
                        for n in (nh, kh, kh, nh))
        lengths = torch.tensor([70, 33], dtype=torch.int32)
        seg, causal = None, True
        if case == "flash_segments":
            seg = T(np.where(rng.random((B, S)) < 0.7, 1, -2).astype(np.int32))
            causal = False
        fn = lambda *x: flash_attention(*x, lengths, causal, 0, seg)  # noqa: E731
        plain = lambda *x: flash_attention_plain(*x, lengths, causal, 0, seg)  # noqa: E731
    out, grads = _autograd(fn, (q, k, v), cot)
    ref_out, ref_grads = _autograd(plain, (q, k, v), cot)
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-5)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("what", ["flash", "window"])
def test_fp32_head_dim_12_backward_matches_jax(rng, what):
    """The tiny config's text head dim (12), which only the fp32 instances
    take on the card: the plain flash forward-with-LSE and backward (causal,
    GQA, a batch row with no key) and the window backward against the JAX
    kernels in interpret mode, at the tolerances above."""
    if what == "flash":
        B, S, nh, kh, hd = 2, 96, 4, 2, 12
        q, k, v, cot = (rng.normal(size=(B, S, n, hd)).astype(np.float32)
                        for n in (nh, kh, kh, nh))
        lengths = np.array([S, 0], np.int32)
        ref_out, ref_grads = _jax_flash_grads(q, k, v, cot, lengths, True, None)
        ref_lse = _jax_flash_lse(q, k, v, lengths, True, None)
        out, lse = flash_attention_fwd_lse(T(q), T(k), T(v), T(lengths), True, 0, None)
        np.testing.assert_allclose(out.numpy(), ref_out, **GRAD_TOL)
        np.testing.assert_allclose(lse.numpy(), ref_lse, **GRAD_TOL)
        grads = flash_attention_bwd(T(q), T(k), T(v), out, T(cot), lse, T(lengths), True, 0,
                                    None)
        for name, ours, ref in zip("qkv", grads, ref_grads):
            np.testing.assert_allclose(ours.numpy(), ref, err_msg=name, **GRAD_TOL)
        return
    wp, nh, hd, S = 64, 4, 12, 256
    q, k, v, cot = (rng.normal(size=(S, nh, hd)).astype(np.float32) for _ in range(4))
    valid = np.ones(S, bool)
    valid[40:wp] = False
    valid[-wp:] = False
    cot = cot * valid[:, None, None]
    ref = jax.grad(lambda q, k, v: jnp.sum(j_window(q, k, v, jnp.asarray(valid), wp=wp,
                                                    interpret=True) * cot),
                   argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ours = window_attention_bwd(T(q), T(k), T(v), T(valid), T(cot), wp)
    for name, a, b in zip("qkv", ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **WINDOW_TOL)
