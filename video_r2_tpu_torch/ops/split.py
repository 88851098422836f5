"""Split plans and the fp32 split workspace of the port's split kernels.

Where a kernel's natural grid leaves most of the card idle, the work is
split across more blocks in the same launch: the int4 matmul's staged
kernel splits its K (``int4_matmul.int4_split_plan``; a tile's splits are
one thread-block cluster and add their sums through its shared memory, with
no workspace), its decode kernel cuts every tile's steps into stream-K
ranges, a block each (``int4_matmul.int4_decode_plan``), and the
decode-attention kernels (``csrc/decode_attn.cu``, ``csrc/paged_attn.cu``,
through ``csrc/split_decode.cuh``) the key range of each (sequence, kv
head). Each of these last two writes fp32 partials to a workspace and takes a ticket on its tile's
counter; the last one combines the partials in a fixed order and sets the
counter back to 0, so every launch leaves the counters 0 and kernels on one
stream can share one workspace.
"""

from __future__ import annotations

import functools

import torch

SPLIT_TILE = 64           # keys a tile of the decode-attention kernels
SPLIT_BLOCKS_PER_SM = 3   # a split plan aims the grid at this many blocks an SM
SPLIT_MIN_TILES = 3       # ... and keeps at least this many tiles a split
SPLIT_MAX = 64            # splits the decode-attention kernels combine at most
# SPLIT_MIN_TILES, measured by scripts/bench_decode_attn.py --splits on an
# NVIDIA H100 80GB HBM3 at 700 W: device ms at S = 2 / 4 / 6 / 8 / 12 / 16 /
# 24 splits, the paged bf16 case of chip_smoke.py phase 8 (32 blocks, 24
# tiles) 0.0247 / 0.0196 / 0.0210 / 0.0191 / 0.0215 / 0.0223 / 0.0256, the
# decode kernel at phase 12's step 63 (16 blocks, 24 tiles) 0.0223 / 0.0165 /
# 0.0160 / 0.0137 / 0.0162 / 0.0152 / 0.0176 (a second run within 0.0003):
# splits shorter than 3 tiles pay more in partials and their combine than
# the idle SMs of a smaller grid cost.


def decode_split_plan(blocks: int, tiles: int, sms: int) -> tuple[int, list[tuple[int, int]]]:
    """Split along the sequence for `blocks` (sequence, kv head) pairs whose
    key range is `tiles` tiles of SPLIT_TILE keys, on a card of `sms` SMs:
    (S, the tile range [begin, end) of each split). S = 1 where the blocks
    already fill the card; otherwise S brings the grid to at most
    SPLIT_BLOCKS_PER_SM blocks an SM (one wave), keeping SPLIT_MIN_TILES
    tiles a split and at most SPLIT_MAX splits. The ranges are the kernel's
    own (grid y): consecutive, their lengths differing by at most one tile.
    From shapes alone: the plan never reads the lengths, so choosing it
    needs no sync."""
    S = 1
    if blocks < sms:
        S = max(1, min(SPLIT_BLOCKS_PER_SM * sms // blocks, tiles // SPLIT_MIN_TILES,
                       SPLIT_MAX))
    base, rem = divmod(tiles, S)
    return S, [(z * base + min(z, rem), (z + 1) * base + min(z + 1, rem)) for z in range(S)]


@functools.lru_cache(maxsize=256)
def decode_splits(blocks: int, tiles: int, index: int) -> int:
    """S of `decode_split_plan` on card `index`. Cached: a decode step makes
    one call a layer at one shape."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return decode_split_plan(blocks, tiles, sms)[0]


# the fp32 workspace and the int32 counters, per (device, stream): zeroed
# once when allocated and grown on demand (each launch leaves the counters 0
# again); kernels on one stream run in order, so they share them. A CUDA
# graph captures their addresses: capture after a call at the largest shape,
# or a later growth leaves the graph on freed buffers.
_buffers: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def split_workspace(dev: torch.device, stream: int, floats: int,
                    counters: int) -> tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, stream)
    part, count = _buffers.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.zeros(floats, dtype=torch.float32, device=dev)
    if count is None or count.numel() < counters:
        count = torch.zeros(counters, dtype=torch.int32, device=dev)
    _buffers[key] = (part, count)
    return part, count
