"""Batched device canonical refine — level 2 on the device (DESIGN.md §15),
port of ``repro.kernels.canonical_refine``.

Level 2 canonicalises each *distinct* quick pattern (paper §5.4). This
module replaces the host permutation search with a batched refine over the
O(Q) unique-code table that emits, bit-identical to
:func:`canon_math.canonicalize_one` / :func:`canon_math.automorphism_orbits`:

  * ``canon`` — the lexicographically minimal (w0, w1, w2) encoding over
    all vertex-position permutations, per row;
  * ``sigma`` — local→canonical position map of the FIRST minimal
    permutation (``itertools.permutations`` order), identity for pos ≥ nv;
  * ``rep``   — automorphism-orbit representative per position (min over
    the automorphism group — run it on *canonical* codes).

Permutations act on the encoded words directly: a per-nv table
(``canon_math.perm_tables``) maps each target adjacency bit to its source
bit under every permutation, so a permuted w0 is one shift/and/or per
adjacency bit.

Routes: :func:`refine_codes_ref`, the plain PyTorch version (one pass per
nv, permutation tiles merged with a strict-less running minimum, int64
arithmetic), and :func:`refine_cuda`, which launches
``csrc/canonical_refine.cu`` once for a batch of mixed nv (uint32
arithmetic). Same contract; dispatch follows
:mod:`repro_torch.kernels.dispatch`.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import canon_math
from repro_torch.kernels import build
from repro_torch.kernels.dispatch import on_cuda, resolve_device

#: permutation-axis tile of the plain route (its intermediates are
#: (rows, tile)); the result does not depend on it.
PERM_TILE = 1024
#: adjacency bits of an 8-vertex pattern — the padded bit-source width.
MAX_BITS = canon_math.n_pair_bits(canon_math.MAX_PATTERN_VERTICES)
MAX_NV = canon_math.MAX_PATTERN_VERTICES

_U32_MAX = 0xFFFFFFFF


def _padded_tables(nv: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-nv permutation tables with padded columns (the reference's
    ``_padded_tables`` without its row padding: every route walks exactly
    nv! permutations).

    ``perms`` (P, 8) int32: columns ≥ nv hold the identity position, so
    label bytes at positions ≥ nv stay in place and the sigma scatter gives
    identity there. ``src`` (P, 28) int32: target bits ≥ n_pair_bits(nv)
    read source bit 31 (never read: the routes stop at n_pair_bits(nv))."""
    perms, src = canon_math.perm_tables(nv)
    p = len(perms)
    nbits = canon_math.n_pair_bits(nv)
    perms_pad = np.tile(np.arange(MAX_NV, dtype=np.int32), (p, 1))
    perms_pad[:, :nv] = perms
    src_pad = np.full((p, MAX_BITS), 31, dtype=np.int32)
    src_pad[:, :nbits] = src
    return perms_pad, src_pad


def _split_codes(codes):
    """(Q, 3) int64 codes -> (bits (Q,), labels (Q, 8), own (Q, 3)), all
    int64 holding the uint32 words. Exact: every code word < 2^32."""
    cu = codes & _U32_MAX
    bits = cu[:, 0] >> 4
    labels = torch.stack(
        [(cu[:, 1] >> (8 * i)) & 0xFF for i in range(4)]
        + [(cu[:, 2] >> (8 * i)) & 0xFF for i in range(4)], dim=1)
    return bits, labels, cu


def _permuted_keys(bits, labels, pt, st, nv: int):
    """Keys of every (row, permutation-in-tile) pair: ``bits`` (R,),
    ``labels`` (R, 8), ``pt`` (T, 8) and ``st`` (T, 28) int64 ->
    (w0, w1, w2) each (R, T) int64."""
    new_bits = torch.zeros((bits.shape[0], pt.shape[0]), dtype=torch.int64,
                           device=bits.device)
    for tb in range(canon_math.n_pair_bits(nv)):
        new_bits |= ((bits[:, None] >> st[None, :, tb]) & 1) << tb
    w0 = (new_bits << 4) | nv
    w1 = torch.zeros_like(new_bits)
    w2 = torch.zeros_like(new_bits)
    for i in range(MAX_NV):
        li = labels[:, pt[:, i]]
        if i < 4:
            w1 |= li << (8 * i)
        else:
            w2 |= li << (8 * (i - 4))
    return w0, w1, w2


def _tile_first_min(w0, w1, w2):
    """Per-row lexicographic minimum over the tile axis + the FIRST column
    achieving it (three-stage masked min, then the first eligible
    column)."""
    m0 = w0.min(dim=1, keepdim=True).values
    e = w0 == m0
    m1 = torch.where(e, w1, _U32_MAX).min(dim=1, keepdim=True).values
    e = e & (w1 == m1)
    m2 = torch.where(e, w2, _U32_MAX).min(dim=1, keepdim=True).values
    e = e & (w2 == m2)
    loc = e.to(torch.int32).argmax(dim=1)
    return m0[:, 0], m1[:, 0], m2[:, 0], loc


def _lex_less3(a0, a1, a2, b0, b1, b2):
    return (a0 < b0) | ((a0 == b0) & ((a1 < b1) | ((a1 == b1) & (a2 < b2))))


def _identity_rows(q: int, dev):
    return torch.arange(MAX_NV, dtype=torch.int32, device=dev).repeat(q, 1)


def _sigma_from_pi(best_pi, perms_dev):
    """sigma[local] = canonical position, via one scatter of the winning
    permutation (padded columns are identity, so pos ≥ nv comes out
    identity exactly as the host contract requires)."""
    chosen = perms_dev[best_pi]                               # (Q, 8)
    q = chosen.shape[0]
    pos = torch.arange(MAX_NV, dtype=torch.int32, device=chosen.device)
    return torch.zeros((q, MAX_NV), dtype=torch.int32,
                       device=chosen.device).scatter_(
        1, chosen.to(torch.int64), pos.repeat(q, 1))


def _refine_nv_ref(codes, nv: int, with_orbits: bool, tile: int = PERM_TILE):
    """Single-nv refine over every row (plain version of one pass of the
    reference's ``_refine_nv_jnp``). Returns (canon (Q, 3) int64, sigma
    (Q, 8) int32, rep (Q, 8) int32); rows whose actual nv differs produce
    garbage the caller masks out."""
    q = codes.shape[0]
    dev = codes.device
    perms_np, src_np = _padded_tables(nv)
    perms_dev = torch.from_numpy(perms_np).to(dev)
    src_dev = torch.from_numpy(src_np).to(device=dev, dtype=torch.int64)
    bits, labels, own = _split_codes(codes)
    full = torch.full((q,), _U32_MAX, dtype=torch.int64, device=dev)
    b0, b1, b2 = full, full.clone(), full.clone()
    bpi = torch.zeros((q,), dtype=torch.int64, device=dev)
    rep = _identity_rows(q, dev)
    for lo in range(0, len(perms_np), tile):
        pt = perms_dev[lo: lo + tile].to(torch.int64)
        st = src_dev[lo: lo + tile]
        w0, w1, w2 = _permuted_keys(bits, labels, pt, st, nv)
        m0, m1, m2, loc = _tile_first_min(w0, w1, w2)
        better = _lex_less3(m0, m1, m2, b0, b1, b2)
        b0 = torch.where(better, m0, b0)
        b1 = torch.where(better, m1, b1)
        b2 = torch.where(better, m2, b2)
        bpi = torch.where(better, lo + loc, bpi)
        if with_orbits:
            auto = ((w0 == own[:, 0:1]) & (w1 == own[:, 1:2])
                    & (w2 == own[:, 2:3]))
            cand = torch.where(auto[:, :, None], pt[None, :, :],
                               MAX_NV).amin(dim=1).to(torch.int32)
            rep = torch.minimum(rep, cand)
    canon = torch.stack([b0, b1, b2], dim=1)
    return canon, _sigma_from_pi(bpi, perms_dev), rep


def refine_codes_ref(codes, valid, nvs: tuple, *, with_orbits: bool = False,
                     tile: int = PERM_TILE):
    """Plain version of :func:`refine_codes`: one refine pass per nv in
    ``nvs``, each row taking the pass that matches its encoded nv."""
    q = codes.shape[0]
    dev = codes.device
    canon = codes.to(torch.int64)
    sigma = _identity_rows(q, dev)
    rep = _identity_rows(q, dev)
    if q == 0:
        return canon, sigma, rep
    row_nv = codes[:, 0] & 0xF
    for nv in sorted(set(int(v) for v in nvs)):
        if nv <= 1 or nv > MAX_NV:
            continue
        if not on_cuda(codes):
            # on the host, refine only the valid rows of this nv (a CUDA
            # tensor takes the masked pass over every row: no host sync)
            rows = (valid & (row_nv == nv)).nonzero()[:, 0]
            c, s, r = _refine_nv_ref(codes[rows], nv, with_orbits, tile)
            canon = canon.index_put((rows,), c)
            sigma = sigma.index_put((rows,), s)
            rep = rep.index_put((rows,), r)
            continue
        c, s, r = _refine_nv_ref(codes, nv, with_orbits, tile)
        m = (valid & (row_nv == nv))[:, None]
        canon = torch.where(m, c, canon)
        sigma = torch.where(m, s, sigma)
        rep = torch.where(m, r, rep)
    return canon, sigma, rep


#: (device, nvs) -> (packed table, meta, lanes per row) of the kernel.
_KERNEL_TABLES: Dict[tuple, tuple] = {}
#: the kernel's block: threads, and the fewest and most rows of its tile
REFINE_THREADS = 256
MIN_TILE, MAX_TILE = 8, 1024
#: permutations a lane should walk in a tile whose rows are all live
LANE_BUDGET = 64
#: device -> streaming multiprocessors
_SMS: Dict[str, int] = {}


def _kernel_tables(nvs: tuple, dev):
    """The kernel's packed permutation table for the nvs of one launch:
    nv! rows of eight int32 words for each nv (the permutation as 8
    nibbles, then the 28 source-bit bytes), ``meta`` (18,) int32 (first
    row of each nv, then the row count of each nv, 0 when absent) and the
    lanes of the widest row group (a power of two ≤ 32, from the largest
    nv!). Built once per device and nv set."""
    live = tuple(sorted(set(int(v) for v in nvs if 2 <= int(v) <= MAX_NV)))
    key = (str(dev), live)
    got = _KERNEL_TABLES.get(key)
    if got is None:
        rows, offs, cnts = [], [0] * (MAX_NV + 1), [0] * (MAX_NV + 1)
        at = 0
        for nv in live:
            perms, src = _padded_tables(nv)
            pk = np.zeros(len(perms), dtype=np.uint32)
            for i in range(MAX_NV):
                pk |= perms[:, i].astype(np.uint32) << np.uint32(4 * i)
            sb = src.astype(np.uint8).view(np.uint32)          # (P, 7)
            rows.append(np.concatenate([pk[:, None], sb], axis=1))
            offs[nv], cnts[nv] = at, len(perms)
            at += len(perms)
        table = (np.concatenate(rows) if rows
                 else np.zeros((1, 8), np.uint32)).view(np.int32)
        biggest = max((cnts[nv] for nv in live), default=1)
        group = min(32, 1 << max(0, (biggest - 1).bit_length()))
        got = (torch.from_numpy(np.ascontiguousarray(table)).to(dev),
               torch.tensor(offs + cnts, dtype=torch.int32, device=dev),
               group)
        _KERNEL_TABLES[key] = got
    return got


def _pow2_floor(x: int) -> int:
    return 1 << max(0, int(x).bit_length() - 1)


def tile_rows(q: int, group: int, perms: int, sms: int) -> int:
    """Rows of one block's tile for a launch of ``q`` rows whose widest
    row takes ``group`` lanes and whose largest nv! is ``perms``, on a card
    of ``sms`` multiprocessors: at least one pass of the block's warps over
    rows of the widest group; at most ``MAX_TILE``, and fewer where a tile
    of live rows would give a lane more than ``LANE_BUDGET`` permutations
    or where the batch would fill fewer than eight blocks a
    multiprocessor, so that the search of a batch of large nv (whose rows
    are all live) spreads over the whole card."""
    least = REFINE_THREADS // group
    work = _pow2_floor(REFINE_THREADS * LANE_BUDGET // perms)
    fill = _pow2_floor(-(-q // (8 * sms)))
    return max(least, MIN_TILE, min(MAX_TILE, work, fill))


def _sms(dev) -> int:
    key = str(dev)
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[key]


def refine_cuda(codes, valid, nvs: tuple, *, with_orbits: bool = False):
    """Mixed-nv refine by ``csrc/canonical_refine.cu`` in one launch (same
    contract as :func:`refine_codes_ref`); a CPU tensor takes the plain
    version."""
    if not on_cuda(codes):
        return refine_codes_ref(codes, valid, nvs, with_orbits=with_orbits)
    dev = codes.device
    if codes.dtype != torch.int64 or codes.dim() != 2 or codes.shape[1] != 3:
        raise TypeError(f"codes: expected (Q, 3) int64, got "
                        f"{tuple(codes.shape)} {codes.dtype}")
    q = codes.shape[0]
    if valid.dtype != torch.bool or valid.shape != (q,) or valid.device != dev:
        raise TypeError(f"valid: expected ({q},) bool on {dev}")
    codes, valid = codes.contiguous(), valid.contiguous()
    canon = torch.empty((q, 3), dtype=torch.int64, device=dev)
    sigma = torch.empty((q, MAX_NV), dtype=torch.int32, device=dev)
    rep = torch.empty((q, MAX_NV), dtype=torch.int32, device=dev)
    if q == 0:
        return canon, sigma, rep
    table, meta, group = _kernel_tables(nvs, dev)
    perms = max((math.factorial(int(v)) for v in nvs
                 if 2 <= int(v) <= MAX_NV), default=1)
    lib = build.library()
    build.launch("canonical_refine", lib.repro_canonical_refine,
                 codes.get_device(), codes.data_ptr(), valid.data_ptr(), q,
                 tile_rows(q, group, perms, _sms(dev)), table.data_ptr(),
                 meta.data_ptr(), int(with_orbits), canon.data_ptr(),
                 sigma.data_ptr(), rep.data_ptr())
    return canon, sigma, rep


def refine_codes(codes, valid, nvs: tuple, *, with_orbits: bool = False,
                 use_kernel: bool = False):
    """Mixed-nv batched canonical refine.

    ``codes`` (Q, 3) int64, ``valid`` (Q,) bool, ``nvs`` the tuple of
    vertex counts that may occur -> ``(canon (Q, 3) int64, sigma (Q, 8)
    int32, rep (Q, 8) int32)``. Each valid row whose nv is in ``nvs``
    (2..8) is refined; every other row passes through unchanged with
    identity sigma/rep (exactly the host contract for nv ≤ 1). ``rep`` is
    the orbit table of the INPUT codes — meaningful on canonical codes."""
    if use_kernel:
        return refine_cuda(codes, valid, nvs, with_orbits=with_orbits)
    return refine_codes_ref(codes, valid, nvs, with_orbits=with_orbits)


def canonicalize_on_device(codes_np, *, with_orbits: bool = False,
                           use_kernel: bool = False, device=None):
    """Host convenience: numpy (M, 3) int64 mixed-nv codes -> numpy
    ``(canon (M, 3) int64, sigma (M, 8) int32, rep (M, 8) int32)`` through
    the refine on ``device`` (``None``: the current CUDA device, raising
    when there is none). This is the ``canon_fn`` hook of
    :func:`pattern.build_pattern_table`. (The reference pads the batch to
    a power of two to bound its compiled shapes; nothing is compiled per
    shape here.)"""
    device = resolve_device(device)
    codes_np = np.ascontiguousarray(codes_np, dtype=np.int64)
    m = len(codes_np)
    if m == 0:
        return (codes_np.copy(),
                np.zeros((0, 8), np.int32), np.zeros((0, 8), np.int32))
    nvs = tuple(sorted(set(int(w) & 0xF for w in codes_np[:, 0])))
    codes = torch.from_numpy(codes_np).to(device)
    valid = torch.ones((m,), dtype=torch.bool, device=codes.device)
    canon, sigma, rep = refine_codes(codes, valid, nvs,
                                     with_orbits=with_orbits,
                                     use_kernel=use_kernel)
    return canon.cpu().numpy(), sigma.cpu().numpy(), rep.cpu().numpy()


def make_canon_fn(*, use_kernel: bool = False, device=None):
    """A :func:`pattern.build_pattern_table` ``canon_fn`` bound to the
    device refine (placement "device" over a host-resident level 1)."""
    def canon_fn(miss_codes):
        canon, sigma, _ = canonicalize_on_device(
            miss_codes, use_kernel=use_kernel, device=device
        )
        return canon, sigma
    return canon_fn
