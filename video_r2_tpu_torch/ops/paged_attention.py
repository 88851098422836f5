"""Paged decode attention through a page table, and the paged KV cache.

Port of ``video_r2_tpu/ops/paged_attention.py``. The KV cache lives in a
pool of fixed-size pages, [L, kh, N_pages, page_size, hd] (the whole layer
stack, kv heads leading); each sequence owns a row of a page table, so
ragged, continuously batched sequences share one pool with no per-sequence
max-length reservation.

- `paged_decode_attention_stacked` replaces ``_paged_decode_kernel_stacked``
  (bf16 pages) and `paged_decode_attention_stacked_quant` replaces
  ``_paged_decode_kernel_stacked_quant`` (int8 pages with fp32 per-(token,
  head) scale pools [L, kh, N_pages, page_size], the scales factored out of
  both products). q is one decode token [B, nh, hd] or a W-token verify
  chunk [B, W, nh, hd] whose token i sits at position lengths[b] - 1 + i
  and admits keys < lengths[b] + i.
- `paged_decode_attention` replaces the per-layer ``_paged_decode_kernel``:
  the same kernel over a one-layer pool [kh, N_pages, page_size, hd].

On CUDA tensors each wrapper launches the hand-written kernel
(``csrc/paged_attn.cu``: bf16 or fp32 q, as the JAX kernels take both,
over pages of q's type or int8 pages; bf16 at head dims 64 and 128, fp32 at
any head dim up to 128, the instance picked by
`split.decode_kernel_instance`; each sequence's keys split across
blocks by `split.decode_split_plan` where B kh blocks do not fill the card,
one launch a call; up to KERNEL_MAX_ROWS = 128 query rows W * (nh / kh) per
kv head, above KERNEL_BLOCK_ROWS in two blocks) and raises on anything it
does not take, a chunk of more query rows by name; on CPU tensors
it runs `paged_decode_attention_stacked_plain` (gather through the table,
fp32 scores, softmax and P @ V, the same mask). A row that admits no key
emits 0 (the engine always passes lengths >= 1).

`PagedKVCache` is the host-side block allocator: page tables, free list,
refcounts (prefix sharing with copy-on-write) and the automatic prefix
cache (content-hashed full pages, released into an LRU pool that `_alloc`
evicts from under pressure). The device pools are updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.decoder import quantize_kv
from .cuda_build import check, kernels
from .split import (
    SPLIT_TILE,
    decode_kernel_instance,
    decode_splits,
    split_width,
    split_workspace,
)

DEFAULT_PAGE_SIZE = 128
KERNEL_PAGE_SIZES = (64, 128)
KERNEL_MAX_ROWS = 128     # W * (nh / kh) query rows a (sequence, kv head)
KERNEL_BLOCK_ROWS = 64    # ... one block holds: more take two blocks (row groups)


def paged_decode_attention_stacked(
    q: torch.Tensor,            # [B, nh, hd] or [B, W, nh, hd]
    k_pages: torch.Tensor,      # [L, kh, N_pages, page_size, hd]
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,  # [B, max_pages] int, valid page ids
    lengths: torch.Tensor,      # [B] tokens in cache (query 0's included)
    layer: int,                 # layer of the pool to read
    page_size: int = DEFAULT_PAGE_SIZE,
    k_scales: torch.Tensor | None = None,   # [L, kh, N_pages, page_size] fp32
    v_scales: torch.Tensor | None = None,   # (int8 pages)
) -> torch.Tensor:
    """Attention of q over layer `layer` of the pool, read through the
    page table. Returns q's shape and dtype. With scales the pages are int8
    (`paged_decode_attention_stacked_quant`)."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("int8 pages need both k_scales and v_scales")
    if k_scales is not None:
        return paged_decode_attention_stacked_quant(
            q, k_pages, v_pages, k_scales, v_scales, page_tables, lengths,
            layer, page_size)
    if q.device.type == "cpu":
        return paged_decode_attention_stacked_plain(q, k_pages, v_pages, page_tables,
                                                    lengths, layer, page_size)
    out = _paged_cuda(q, k_pages, v_pages, None, None, page_tables, lengths, layer,
                      page_size)
    paged_decode_attention_stacked.launches += 1
    return out


paged_decode_attention_stacked.launches = 0   # bf16-page kernel launches (CUDA only)


def paged_decode_attention_stacked_quant(q, k_pages, v_pages, k_scales, v_scales,
                                         page_tables, lengths, layer: int,
                                         page_size: int = DEFAULT_PAGE_SIZE) -> torch.Tensor:
    """The same over int8 pages and their fp32 scale pools."""
    if q.device.type == "cpu":
        return paged_decode_attention_stacked_plain(q, k_pages, v_pages, page_tables,
                                                    lengths, layer, page_size,
                                                    k_scales, v_scales)
    out = _paged_cuda(q, k_pages, v_pages, k_scales, v_scales, page_tables, lengths,
                      layer, page_size)
    paged_decode_attention_stacked_quant.launches += 1
    return out


paged_decode_attention_stacked_quant.launches = 0   # int8-page kernel launches


def paged_decode_attention(q, k_pages, v_pages, page_tables, lengths,
                           page_size: int = DEFAULT_PAGE_SIZE) -> torch.Tensor:
    """Single-layer pool [kh, N_pages, page_size, hd], q [B, nh, hd]: the
    stacked kernel over a one-layer view."""
    if q.dim() != 3:
        raise ValueError(f"paged_decode_attention takes q [B, nh, hd], got "
                         f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        return paged_decode_attention_stacked_plain(q, k_pages[None], v_pages[None],
                                                    page_tables, lengths, 0, page_size)
    out = _paged_cuda(q, k_pages[None], v_pages[None], None, None, page_tables,
                      lengths, 0, page_size)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_stacked_plain(q, k_pages, v_pages, page_tables, lengths,
                                         layer: int, page_size: int = DEFAULT_PAGE_SIZE,
                                         k_scales=None, v_scales=None) -> torch.Tensor:
    """Dense PyTorch version of the kernel: every table page gathered, fp32
    scores (int8 pages: q . k_int8 times the k scale), the mask key <
    lengths[b] + i, fp32 softmax, P (times the v scale) @ V, divided by
    max(l, 1e-30); output in q's dtype."""
    multi = q.dim() == 4
    qw = q if multi else q[:, None]
    B, W, nh, hd = qw.shape
    kh = k_pages.shape[1]
    g = nh // kh
    tables = page_tables.to(q.device).long()
    n_keys = tables.shape[1] * page_size

    def gather(pool):            # -> [B, kh, n_keys, ...]
        x = pool[layer][:, tables]                      # [kh, B, P, ps, ...]
        x = x.transpose(0, 1)
        return x.reshape(B, kh, n_keys, *x.shape[4:])

    k, v = gather(k_pages).float(), gather(v_pages).float()
    qg = qw.float().reshape(B, W, kh, g, hd) * hd ** -0.5
    s = torch.einsum("bwhgd,bhkd->bhwgk", qg, k)
    if k_scales is not None:
        s = s * gather(k_scales).float()[:, :, None, None, :]
    limit = lengths.to(q.device).long()[:, None] + torch.arange(W, device=q.device)
    allowed = torch.arange(n_keys, device=q.device) < limit[:, :, None]   # [B, W, K]
    s = s.masked_fill(~allowed[:, None, :, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), 0.0, m)            # rows that admit no key
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scales is not None:
        p = p * gather(v_scales).float()[:, :, None, None, :]
    o = torch.einsum("bhwgk,bhkd->bwhgd", p, v)
    o = o / torch.clamp(l, min=1e-30).permute(0, 2, 1, 3, 4)
    o = o.reshape(B, W, nh, hd).to(q.dtype)
    return o if multi else o[:, 0]


def check_kernel_sizes(head_dim: int, page_size: int, dtype: torch.dtype) -> None:
    """Raise unless the CUDA kernel takes q of `dtype` at this head dim
    (decode_kernel_instance) and this page size."""
    decode_kernel_instance(dtype, head_dim)
    if page_size not in KERNEL_PAGE_SIZES:
        raise ValueError(f"paged kernel: page size {page_size} not in "
                         f"{KERNEL_PAGE_SIZES}")


def check_query_rows(W: int, nh: int, kh: int) -> None:
    """Raise unless the CUDA kernel takes a W-token chunk of nh query heads
    over kh kv heads: kv heads dividing query heads, and W * (nh / kh) query
    rows per kv head at most KERNEL_MAX_ROWS (a verify chunk of K + 1
    tokens: K <= 15 at the judge's g = 8, K <= 17 at the 7B's g = 7)."""
    if kh <= 0 or nh % kh:
        raise ValueError(f"paged kernel: {kh} kv heads do not divide {nh} query heads")
    if W * (nh // kh) > KERNEL_MAX_ROWS:
        raise ValueError(f"paged kernel: {W} tokens x {nh // kh} query heads per kv head "
                         f"= {W * (nh // kh)} query rows, above the kernel's limit of "
                         f"KERNEL_MAX_ROWS = {KERNEL_MAX_ROWS}")


def row_groups(rows: int) -> int:
    """Blocks a (sequence, kv head) takes for `rows` query rows: 1 up to
    KERNEL_BLOCK_ROWS, else 2 of even halves (the kernel's grid z)."""
    return -(-rows // KERNEL_BLOCK_ROWS)


def _paged_cuda(q, k_pages, v_pages, k_scales, v_scales, page_tables, lengths,
                layer, page_size):
    """Check the operands and launch csrc/paged_attn.cu."""
    multi = q.dim() == 4
    B, W, nh, hd = q.shape if multi else (q.shape[0], 1, *q.shape[1:])
    if k_pages.dim() != 5:
        raise ValueError(f"paged kernel: pool must be [L, kh, N, page_size, hd], got "
                         f"{tuple(k_pages.shape)}")
    L, kh, N, ps = k_pages.shape[:4]
    check_kernel_sizes(hd, page_size, q.dtype)
    quant = k_scales is not None
    dev = q.device
    if ps != page_size or k_pages.shape[4] != hd or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged kernel: pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit page size {page_size} "
                         f"and q {tuple(q.shape)}")
    check_query_rows(W, nh, kh)
    page_dtype = torch.int8 if quant else q.dtype
    operands = [("k_pages", k_pages, page_dtype), ("v_pages", v_pages, page_dtype)]
    if quant:
        operands += [("k_scales", k_scales, torch.float32),
                     ("v_scales", v_scales, torch.float32)]
        if k_scales.shape != k_pages.shape[:4] or v_scales.shape != k_pages.shape[:4]:
            raise ValueError(f"paged kernel: scale pools must be "
                             f"{tuple(k_pages.shape[:4])}")
    for name, x, dtype in operands:
        if x.device != dev:
            raise ValueError(f"paged kernel: {name} on {x.device}, q on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"paged kernel: {name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"paged kernel: {name} must be contiguous")
    if not 0 <= layer < L:
        raise ValueError(f"paged kernel: layer {layer} outside the pool's {L}")
    tables = page_tables.to(device=dev, dtype=torch.int32).contiguous()
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    if tables.dim() != 2 or tables.shape[0] != B or lens.shape != (B,):
        raise ValueError(f"paged kernel: tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lens.shape)} do not match batch {B}")
    q = q.contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    max_pages = tables.shape[1]
    groups = row_groups(W * (nh // kh))
    S = decode_splits(B * kh * groups, max_pages * page_size // SPLIT_TILE, dev.index)
    part = counters = None
    if S > 1:
        part, counters = split_workspace(
            dev, stream, B * kh * S * W * (nh // kh) * (split_width(hd) + 2),
            B * kh * groups)
    err = kernels().vr2_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
        out.data_ptr(), tables.data_ptr(), lens.data_ptr(),
        B, W, nh, kh, hd, page_size, N, max_pages, int(layer), q.element_size(), S,
        hd ** -0.5, None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), stream)
    check(err, "paged decode attention kernel")
    return out


# ---------------------------------------------------------------------------
# Host-side paged cache manager (the block allocator)
# ---------------------------------------------------------------------------

@dataclass
class PagedKVCache:
    """Paged cache pool for one decoder layer stack.

    k / v: [L, kh, N_pages, page_size, hd] on the device (int8 with fp32
    scale pools [L, kh, N_pages, page_size] when quantized). Page tables,
    lengths, free list, refcounts and the prefix-cache maps live on the
    host: allocation is control flow."""

    k: torch.Tensor
    v: torch.Tensor
    page_size: int
    page_tables: np.ndarray      # [B, max_pages] int32, -1 = unallocated
    lengths: np.ndarray          # [B]
    free_pages: list[int]
    refcount: np.ndarray = None  # [N_pages] int32: sharers per page
    hash_to_page: dict = None    # chain-hash bytes -> page id
    page_hash: dict = None       # page id -> chain-hash bytes
    evictable: dict = None       # page id -> None, insertion-ordered (LRU)
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def create(cls, num_layers: int, num_pages: int, page_size: int,
               kv_heads: int, head_dim: int, batch: int, max_pages: int,
               dtype=torch.bfloat16, quantized: bool = False,
               device="cuda") -> "PagedKVCache":
        shape = (num_layers, kv_heads, num_pages, page_size, head_dim)
        zeros = lambda s, t: torch.zeros(s, dtype=t, device=device)  # noqa: E731
        if quantized:
            extra = dict(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                         k_scale=zeros(shape[:-1], torch.float32),
                         v_scale=zeros(shape[:-1], torch.float32))
        else:
            extra = dict(k=zeros(shape, dtype), v=zeros(shape, dtype))
        return cls(
            page_size=page_size,
            page_tables=np.full((batch, max_pages), -1, np.int32),
            lengths=np.zeros((batch,), np.int32),
            free_pages=list(range(num_pages - 1, -1, -1)),
            refcount=np.zeros((num_pages,), np.int32),
            hash_to_page={}, page_hash={}, evictable={},
            **extra,
        )

    def available_pages(self) -> int:
        """Pages allocatable right now: truly free + evictable cached."""
        return len(self.free_pages) + len(self.evictable)

    def _uncache(self, p: int) -> None:
        h = self.page_hash.pop(p, None)
        if h is not None and self.hash_to_page.get(h) == p:
            del self.hash_to_page[h]

    def _alloc(self) -> int:
        if not self.free_pages:
            if self.evictable:
                # evict the least-recently-used cached page
                p = next(iter(self.evictable))
                del self.evictable[p]
                self._uncache(p)
                self.free_pages.append(p)
            else:
                raise RuntimeError("paged KV cache out of pages")
        p = self.free_pages.pop()
        self.refcount[p] = 1
        return p

    # -- automatic prefix cache (content-addressed full pages) --------------
    def cache_pages(self, hashes: list, pids: list) -> None:
        """Register pages under their chain hashes (first writer wins)."""
        for h, p in zip(hashes, pids):
            if h not in self.hash_to_page and p not in self.page_hash:
                self.hash_to_page[h] = int(p)
                self.page_hash[int(p)] = h

    def match_pages(self, hashes: list) -> list[int]:
        """Acquire the longest cached run of `hashes` (refcount++ per hit;
        evictable hits return to live). Stops at the first miss."""
        out = []
        for h in hashes:
            p = self.hash_to_page.get(h)
            if p is None:
                break
            if p in self.evictable:
                del self.evictable[p]
            self.refcount[p] += 1
            out.append(p)
        return out

    def release_pages(self, pids: list[int]) -> None:
        """Drop one reference per listed page (undo of match_pages)."""
        for p in pids:
            p = int(p)
            self.refcount[p] -= 1
            if self.refcount[p] <= 0:
                self.refcount[p] = 0
                if p in self.page_hash:
                    self.evictable[p] = None
                else:
                    self.free_pages.append(p)

    def ensure_capacity(self, seq: int, new_tokens: int) -> None:
        """Allocate pages so sequence `seq` can hold `lengths[seq]+new_tokens`."""
        need = -(-(int(self.lengths[seq]) + new_tokens) // self.page_size)
        have = int((self.page_tables[seq] >= 0).sum())
        for slot in range(have, need):
            self.page_tables[seq, slot] = self._alloc()

    def share_prefix(self, src: int, dst: int, cow_last: bool):
        """Point `dst` at `src`'s pages (refcount++). If cow_last, the last
        used page gets a private copy for dst (the next decode token writes
        into it): returns (old_pid, new_pid) for the caller's device copy,
        or None when no copy is needed."""
        used = int((self.page_tables[src] >= 0).sum())
        self.page_tables[dst] = self.page_tables[src]
        for p in self.page_tables[src][:used]:
            self.refcount[int(p)] += 1
        self.lengths[dst] = self.lengths[src]
        if not cow_last or used == 0:
            return None
        old = int(self.page_tables[dst, used - 1])
        new = self._alloc()
        self.refcount[old] -= 1
        self.page_tables[dst, used - 1] = new
        return (old, new)

    def release(self, seq: int) -> None:
        self.release_pages([int(p) for p in self.page_tables[seq] if p >= 0])
        self.page_tables[seq] = -1
        self.lengths[seq] = 0

    def append_token(self, seq_ids: np.ndarray, k_new: torch.Tensor,
                     v_new: torch.Tensor) -> None:
        """Append one token's KV for each listed sequence.
        k_new / v_new: [L, len(seq_ids), kh, hd]."""
        seq_ids = np.asarray(seq_ids)
        for s in seq_ids:
            self.ensure_capacity(int(s), 1)
        pos = self.lengths[seq_ids]
        dev = self.k.device
        pid = torch.as_tensor(self.page_tables[seq_ids, pos // self.page_size],
                              device=dev).long()
        off = torch.as_tensor(pos % self.page_size, device=dev).long()
        kn, vn = k_new.transpose(1, 2), v_new.transpose(1, 2)   # [L, kh, B_sel, hd]
        if self.quantized:
            kq, ks = quantize_kv(kn)
            vq, vs = quantize_kv(vn)
            self.k[:, :, pid, off] = kq
            self.v[:, :, pid, off] = vq
            self.k_scale[:, :, pid, off] = ks
            self.v_scale[:, :, pid, off] = vs
        else:
            self.k[:, :, pid, off] = kn.to(self.k.dtype)
            self.v[:, :, pid, off] = vn.to(self.v.dtype)
        self.lengths[seq_ids] += 1
