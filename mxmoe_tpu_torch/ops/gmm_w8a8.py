"""int8 x int8 grouped GEMM (port of ``mxmoe_tpu/ops/pallas_gmm.py:gmm_w8a8``)
— kernel K2, ``csrc/gmm_w8a8.cu``.

Rows are expert-sorted: expert e owns the contiguous row range given by
``group_sizes`` (cumulative). Per row r of expert e:

  out[r] = ((float(lhs_q[r] @ rhs_q[e]) * lhs_scale[r]) * rhs_scale[e]) -> out dtype

The integer product is exact, so kernel and plain version agree bitwise.
Rows past ``sum(group_sizes)`` are left unwritten by the kernel
(``torch.empty``), as in the TPU kernel, and zero in the plain version;
``combine_tokens`` never reads them.

The layer-stacked weight metadata of the TPU kernel (``group_base``,
``num_total_groups``) is not ported: a layer's weights are the view
``w[layer]``. The TPU tile knobs (bm/bn/bk) have no counterpart: the card's
schedule is ``int8_gmm_schedule``'s, shared by K2, K4, K5 and K9; above the
decode rows K2, K5 and K4 (over its ragged storage) take the persistent
wgmma body (``csrc/gmm_ws_body.cuh``), which reads ``group_sizes`` on the
device, and K9 the grouped-scale body B (``gmm_w8a8_asym.asym_gmm_schedule``).
"""

from __future__ import annotations

import dataclasses

import torch

from . import kernels

SMS = 132          # streaming multiprocessors of the H100
SPLIT_BLOCKS = 2 * SMS    # K is split when a decode grid has fewer blocks
DECODE_M = 64      # rows up to which the decode schedule (m16 tiles) is taken
K_TILE = 64        # storage rows of one k-tile, both mma.sync schedules
# rows from which K2 / K5 / K4 take the wgmma body (the 64 x 128 mma.sync
# tile was the slower at every M measured above the decode rows, M 68-36736
# for K2 / K5, 68-65536 for K4: PERF.md), its tiles (rows and columns of a
# work item, codes of a k-tile) and its K bound: K x 127 x 128 stays below
# 2^31, so the int32 sum is exact
WGMMA_MIN_M = DECODE_M + 1
WGMMA_BM, WGMMA_BN, WGMMA_BK = 128, 256, 128
WGMMA_MAX_K = 1 << 16
_PART_INTS = 16 * 64 + 16    # int32 of one split's partial: m16 x 64 + row sums


@dataclasses.dataclass(frozen=True)
class Int8GemmSchedule:
    """How one launch of the int8 grouped GEMM body (K2 / K4 / K5 / K9)
    covers [M, N]: ``bm`` x ``bn`` block tiles over ``grid_n`` x ``grid_m``
    (logical m-tiles), K cut into ``splits`` ranges of ``k_tiles_per_split``
    k-tiles; a split-K launch needs ``ws_ints`` int32 of workspace and
    ``tickets`` zeroed counters."""
    bm: int
    bn: int
    grid_n: int
    grid_m: int
    splits: int
    k_tiles_per_split: int
    ws_ints: int
    tickets: int

    @property
    def blocks(self) -> int:
        return self.grid_n * self.grid_m * self.splits


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wgmma_domain(m: int, k: int, n: int, packed: bool, aligned: bool) -> bool:
    """Whether the wgmma body takes these shapes: M above the decode rows,
    N a multiple of 16 and 16-byte aligned operands (TMA), K within the int32
    bound, packed K a multiple of 64 (a quarter box of 32 byte rows never
    straddles K/2)."""
    return (m >= WGMMA_MIN_M and n % 16 == 0 and aligned and 0 < k <= WGMMA_MAX_K
            and k % (64 if packed else 16) == 0)


def int8_gmm_schedule(m: int, k: int, n: int, e: int, packed: bool = False,
                      aligned: bool = True, wgmma: bool = False,
                      ragged: bool = False) -> Int8GemmSchedule:
    """The one place the int8 grouped GEMM's schedule is chosen, from the
    shapes the host knows (no sync on the routing).

    Decode (``m <= DECODE_M``, N a multiple of 16, 16-byte aligned weights):
    one m16 row block x 64 columns a block; the m-tiles are bounded by M
    itself, since every live tile holds a row. When fewer than two blocks an
    SM would run (``SPLIT_BLOCKS``), K is split into whole k-tiles so the
    grid fills the card (at most 16 splits). ``wgmma`` (K2 and K5 over
    stacked storage; K4 over its ragged storage with ``ragged``, whose
    experts may be packed, so the domain is packed's) and ``wgmma_domain``:
    the persistent wgmma body, bm 128 (its
    grid is the SM count; ``grid_m`` bounds the m-tiles of its walk,
    cdiv(M, 128) + E, and ``k_tiles_per_split`` counts its 128-code
    k-tiles). Otherwise the prefill tile, 64 x 128, over cdiv(M, 64) + E - 1
    logical m-tiles. ``packed``: every expert's storage holds K/2 rows (a
    ragged buffer's int8 experts hold K, and the split is taken over K)."""
    kw = k // 2 if packed else k
    kt = max(_cdiv(kw, K_TILE), 1)
    if wgmma and wgmma_domain(m, k, n, packed or ragged, aligned):
        return Int8GemmSchedule(WGMMA_BM, WGMMA_BN, _cdiv(n, WGMMA_BN),
                                _cdiv(m, WGMMA_BM) + e, 1, _cdiv(k, WGMMA_BK), 0, 0)
    if m <= DECODE_M and n % 16 == 0 and aligned:
        grid_n, grid_m = _cdiv(n, 64), min(_cdiv(m, 16) + e - 1, m)
        base = grid_n * grid_m
        tps = kt
        if 0 < base < SPLIT_BLOCKS:
            tps = _cdiv(kt, min(_cdiv(SPLIT_BLOCKS, base), kt, 16))
        splits = _cdiv(kt, tps)
        if splits == 1:
            return Int8GemmSchedule(16, 64, grid_n, grid_m, 1, kt, 0, 0)
        return Int8GemmSchedule(16, 64, grid_n, grid_m, splits, tps,
                                base * splits * _PART_INTS, base)
    return Int8GemmSchedule(64, 128, _cdiv(n, 128), _cdiv(m, 64) + e - 1, 1, kt,
                            0, 0)


def schedule_args(sched: Int8GemmSchedule, device):
    """A schedule -> the C entry points' schedule arguments (bm, grid_m,
    splits, k_tiles_per_split, workspace, tickets) and the split-K workspace
    tensor (or None), which the caller keeps alive until the launch is
    queued."""
    if sched.splits == 1:
        return (sched.bm, sched.grid_m, 1, sched.k_tiles_per_split, None, None), None
    ws = torch.empty((sched.ws_ints,), dtype=torch.int32, device=device)
    tk = kernels.tickets(device, sched.tickets)
    return (sched.bm, sched.grid_m, sched.splits, sched.k_tiles_per_split,
            ws.data_ptr(), tk.data_ptr()), ws


def int8_launch_schedule(lhs_q, rhs, n: int, e: int, packed: bool = False,
                         wgmma: bool = False, ragged: bool = False):
    """``int8_gmm_schedule`` for these operands -> ``schedule_args``."""
    m, k = lhs_q.shape
    sched = int8_gmm_schedule(m, k, n, e, packed, aligned=rhs.data_ptr() % 16 == 0,
                              wgmma=wgmma, ragged=ragged)
    return schedule_args(sched, lhs_q.device)


# k-terms per float32 product in exact_int8_matmul: 1024 products of int8
# codes sum to at most 2^24 in magnitude, where every integer is an f32
_F32_EXACT_K = 1024


def exact_int8_matmul(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 codes ``a_q`` [..., r, K] @ ``w_q`` [..., K, N] -> int32, exact.
    On the CPU in float32 over k-chunks of 1024 (every partial sum is an
    integer below 2^24, exact in any order; ~10x torch's int32 matmul),
    summed in int32; on a card in float64 (torch has no CUDA int matmul;
    every partial sum is below 2^53)."""
    if a_q.device.type != "cpu":
        return (a_q.double() @ w_q.double()).to(torch.int32)
    k = a_q.shape[-1]
    acc = None
    for k0 in range(0, k, _F32_EXACT_K):
        part = (a_q[..., k0:k0 + _F32_EXACT_K].float()
                @ w_q[..., k0:k0 + _F32_EXACT_K, :].float()).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def grouped_int8_plain(lhs_q, lhs_scale, weight_of, rhs_scale, group_sizes,
                       out_dtype) -> torch.Tensor:
    """The plain grouped product shared by the int8 GEMMs' plain versions:
    ``weight_of(e)`` gives expert e's [K, N] int8 codes. Accumulates
    exactly (``exact_int8_matmul``). Reads ``group_sizes`` on the host: a
    reference, not the serving path."""
    m, n = lhs_q.shape[0], rhs_scale.shape[-1]
    out = torch.zeros((m, n), dtype=out_dtype, device=lhs_q.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, m)
        if end > start:
            acc = exact_int8_matmul(lhs_q[start:end], weight_of(e))
            res = acc.float() * lhs_scale[start:end] * rhs_scale[e]
            out[start:end] = res.to(out_dtype)
        start += size
    return out


def int8_split_k_plain(lhs_q, lhs_scale, weight_of, rhs_scale, group_sizes,
                       k_tiles_per_split: int, packed_of=lambda e: False,
                       rhs_zp=None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The decode schedule's split-K order, in plain PyTorch (for the tests):
    per expert, its storage rows (K, or K/2 when ``packed_of(e)``: row r
    holds codes r and K/2 + r) in ranges of ``k_tiles_per_split`` k-tiles,
    one exact int32 partial per range (and the activations' row sums with
    ``rhs_zp``), added in range order, then the epilogue of the plain
    versions: ``(acc * s_a) * s_b [+ (rsum * s_a) * zp]``."""
    m, k = lhs_q.shape
    n = rhs_scale.shape[-1]
    step = k_tiles_per_split * K_TILE
    out = torch.zeros((m, n), dtype=out_dtype, device=lhs_q.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, m)
        if end > start:
            a, w = lhs_q[start:end], weight_of(e)
            kw = k // 2 if packed_of(e) else k
            acc = torch.zeros((end - start, n), dtype=torch.int32, device=a.device)
            rsum = torch.zeros((end - start, 1), dtype=torch.int32, device=a.device)
            for s0 in range(0, kw, step):
                s1 = min(s0 + step, kw)
                spans = [(s0, s1)] + ([(k // 2 + s0, k // 2 + s1)] if kw < k else [])
                for r0, r1 in spans:
                    acc += exact_int8_matmul(a[:, r0:r1], w[r0:r1])
                    rsum += a[:, r0:r1].to(torch.int32).sum(-1, keepdim=True)
            sa = lhs_scale[start:end]
            res = acc.float() * sa * rhs_scale[e]
            if rhs_zp is not None:
                res = res + rsum.float() * sa * rhs_zp[e]
            out[start:end] = res.to(out_dtype)
        start += size
    return out


def logical_rows(block, packed: bool, k: int, k0: int, k1: int) -> torch.Tensor:
    """Code rows [k0, k1) of logical K from an expert's storage ``block``:
    [K, N] int8 codes, or with ``packed`` [K/2, N] nibble-packed bytes in the
    halves layout (code row k: byte row k, low nibble, below K/2; byte row
    k - K/2, high nibble, above), sign-extended to int8. The rows may
    straddle K/2."""
    if not packed:
        return block[k0:k1]
    k2 = k // 2
    b = block.to(torch.int32)
    rows = []
    if k0 < k2:
        rows.append(((b[k0:min(k1, k2)] & 0xF) ^ 8) - 8)
    if k1 > k2:
        rows.append((((b[max(k0, k2) - k2:k1 - k2] >> 4) & 0xF) ^ 8) - 8)
    return torch.cat(rows).to(torch.int8)


HOLD_GROUPS = 8    # high-half groups the grouped decode body's one-pass walk holds


def grouped_decode_plain(lhs_q, lhs_scale, storage_of, rhs_scale, group_sizes,
                         gsize: int, k_tiles_per_split: int, rhs_zp=None,
                         out_dtype=torch.bfloat16, one_pass: bool = True
                         ) -> torch.Tensor:
    """The grouped-scale decode body's order of work (K8 / K4f at decode M,
    ``csrc/gmm_grouped_tile.cuh``), in plain PyTorch (for the tests). Per
    expert, ``storage_of(e)`` -> (storage block, packed).

    Logical walk: K in k-tiles of 64 codes, each tile's code rows read from
    the storage by ``logical_rows`` (a packed expert's byte rows once for each
    half of K; a tile or a scale group may straddle K/2), cut into splits of
    ``k_tiles_per_split`` k-tiles; each split keeps one exact int32 sum (and
    the activations' row sums with ``rhs_zp``) per group it touches; a
    group's sums are added in split order.

    One-pass walk (``one_pass``; a packed expert of an unsplit walk with K/2
    % 64 == 0 and at most ``HOLD_GROUPS`` groups from K/2 on): byte tiles of
    64 rows, each giving a low-nibble sum for logical k = r and a high-nibble
    sum for k = K/2 + r; the high half's group sums are held, and the group
    that straddles K/2 adds its low part to its held high part.

    Either way the groups are folded in ascending order: ``acc += (isum *
    s_a) * s_b [+ (rsum * s_a) * zp]``, every f32 step rounded on its own."""
    m, k = lhs_q.shape
    n = rhs_scale.shape[-1]
    groups = k // gsize
    kt = -(-k // K_TILE)
    k2 = k // 2
    out = torch.zeros((m, n), dtype=out_dtype, device=lhs_q.device)

    def tile_sum(a, w, k0, k1):
        return (exact_int8_matmul(a[:, k0:k1], w),
                a[:, k0:k1].to(torch.int32).sum(-1, keepdim=True))

    def add(sums, g, part):
        sums[g] = part if g not in sums else (sums[g][0] + part[0], sums[g][1] + part[1])

    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, m)
        if end > start:
            a = lhs_q[start:end]
            block, packed = storage_of(e)
            # parts[z][g]: (int32 sums, row sums) of group g in split (or
            # half) z, added per group in order
            parts = []
            if (one_pass and packed and k_tiles_per_split >= kt and k2 % K_TILE == 0
                    and groups - k2 // gsize <= HOLD_GROUPS):
                low, high = {}, {}
                for r0 in range(0, k2, K_TILE):
                    # a byte tile read as a packed block of 2 x 64 codes: its
                    # low nibbles are codes r0.., its high ones K/2 + r0..
                    rows = block[r0:r0 + K_TILE]
                    lo = logical_rows(rows, True, 2 * K_TILE, 0, K_TILE)
                    hi = logical_rows(rows, True, 2 * K_TILE, K_TILE, 2 * K_TILE)
                    add(low, r0 // gsize, tile_sum(a, lo, r0, r0 + K_TILE))
                    add(high, (k2 + r0) // gsize,
                        tile_sum(a, hi, k2 + r0, k2 + r0 + K_TILE))
                parts = [low, high]
            else:
                for t0 in range(0, kt, k_tiles_per_split):
                    part = {}
                    for t in range(t0, min(t0 + k_tiles_per_split, kt)):
                        k0, k1 = t * K_TILE, min((t + 1) * K_TILE, k)
                        add(part, k0 // gsize,
                            tile_sum(a, logical_rows(block, packed, k, k0, k1), k0, k1))
                    parts.append(part)
            sa = lhs_scale[start:end]
            acc = torch.zeros((end - start, n), dtype=torch.float32, device=a.device)
            for g in range(groups):
                isum = sum(p[g][0] for p in parts if g in p)
                rs = sum(p[g][1] for p in parts if g in p)
                acc = acc + isum.float() * sa[:, g:g + 1] * rhs_scale[e, g]
                if rhs_zp is not None:
                    acc = acc + (rs.float() * sa[:, g:g + 1]) * rhs_zp[e, g]
            out[start:end] = acc.to(out_dtype)
        start += size
    return out


def gmm_w8a8_plain(lhs_q, lhs_scale, rhs_q, rhs_scale, group_sizes,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    return grouped_int8_plain(lhs_q, lhs_scale, lambda e: rhs_q[e], rhs_scale,
                              group_sizes, out_dtype)


def check_int8_gmm_operands(name: str, lhs_q, lhs_scale, rhs, rhs_scale,
                            group_sizes, out_dtype, extra=(), groups=1) -> None:
    """Argument checks shared by the int8 grouped GEMM wrappers (K2, K4, K5,
    K8, K9); ``rhs`` is the weight storage, whose shape each wrapper checks
    itself. ``groups``: k-groups of the scales (1 = per-token x per-channel)."""
    req = kernels.require
    m, k = lhs_q.shape
    e, n = rhs_scale.shape[0], rhs_scale.shape[-1]
    dev = lhs_q.device
    req(all(t.is_cuda and t.device == dev and t.is_contiguous()
            for t in (lhs_q, lhs_scale, rhs, rhs_scale, group_sizes, *extra)),
        f"{name}: operands must be contiguous tensors on one CUDA device")
    req(lhs_q.dtype == torch.int8 and rhs.dtype == torch.int8,
        f"{name}: codes must be int8")
    req(lhs_scale.dtype == torch.float32 and rhs_scale.dtype == torch.float32,
        f"{name}: scales must be float32")
    req(group_sizes.dtype == torch.int32 and group_sizes.shape == (e,),
        f"{name}: group_sizes must be int32 [E]")
    req(lhs_scale.shape == (m, groups) and rhs_scale.shape == (e, groups, n),
        f"{name}: scales {tuple(lhs_scale.shape)} {tuple(rhs_scale.shape)} for "
        f"lhs {tuple(lhs_q.shape)} and {groups} k-group(s)")
    req(k % 16 == 0 and n % 4 == 0, f"{name}: K={k} % 16, N={n} % 4")
    req(lhs_q.data_ptr() % 16 == 0 and rhs.data_ptr() % 4 == 0
        and rhs_scale.data_ptr() % 16 == 0
        and all(t.data_ptr() % 16 == 0 for t in extra),
        f"{name}: misaligned operand")
    req(e <= 1024, f"{name}: at most 1024 experts")
    req(out_dtype in (torch.bfloat16, torch.float32),
        f"{name}: out dtype {out_dtype}")


def gmm_w8a8(
    lhs_q: torch.Tensor,        # [M, K] int8 codes
    lhs_scale: torch.Tensor,    # [M, 1] f32 per-token scale
    rhs_q: torch.Tensor,        # [E, K, N] int8 codes
    rhs_scale: torch.Tensor,    # [E, 1, N] f32 per-channel scale
    group_sizes: torch.Tensor,  # [E] int32, on the tensors' device
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Symmetric per-token x per-channel int8 grouped matmul -> [M, N]."""
    if lhs_q.device.type == "cpu":
        return gmm_w8a8_plain(lhs_q, lhs_scale, rhs_q, rhs_scale, group_sizes,
                              out_dtype)
    m, k = lhs_q.shape
    e, _, n = rhs_q.shape
    dev = lhs_q.device
    check_int8_gmm_operands("gmm_w8a8", lhs_q, lhs_scale, rhs_q, rhs_scale,
                            group_sizes, out_dtype)
    kernels.require(rhs_q.shape == (e, k, n) and rhs_scale.shape[0] == e,
                    f"gmm_w8a8: rhs {tuple(rhs_q.shape)} for K={k}")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    sched, _ws = int8_launch_schedule(lhs_q, rhs_q, n, e, wgmma=True)
    err = kernels.lib().mxmoe_gmm_w8a8(
        lhs_q.data_ptr(), lhs_scale.data_ptr(), rhs_q.data_ptr(),
        rhs_scale.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), m, k, n, e, *sched,
        kernels.stream_ptr(dev))
    kernels.check(err, "gmm_w8a8")
    kernels.launches["gmm_w8a8"] += 1
    return out
