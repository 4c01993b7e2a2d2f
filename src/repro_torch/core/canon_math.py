"""Pure canonical-pattern math (level 2, paper §5.4) — no memo, no device.

A copy of the numpy module ``repro.core.canon_math``: importing anything of
the JAX package would load JAX, so the port keeps its own.

Split out of ``core/pattern.py`` so the batched device kernel
(``kernels/canonical_refine.py``), the host memo layer (``pattern.py``)
and the cost-model pilot probe all share one definition of the canonical
contract:

  * canonical code = lexicographic minimum of ``(w0, w1, w2)`` over all
    vertex-position permutations, enumerated in ``itertools.permutations``
    order; the FIRST minimal permutation wins ties;
  * ``sigma[local_pos] = canonical_pos`` for the winning permutation,
    identity for positions ≥ nv;
  * orbit representative ``rep[i]`` = the minimum position automorphic to
    ``i`` (union-find over all automorphisms ≡ min over the permutation
    group, which is fully enumerated here).

Encoding (3 × int64 per pattern, every word < 2^32):
  w0 = n_vertices | adj_bits << 4     (pair (a<b) -> bit b*(b-1)/2 + a)
  w1 = labels[0..3], 8 bits each      (labels must be < 256)
  w2 = labels[4..7], 8 bits each
"""
from __future__ import annotations

import itertools

import numpy as np

MAX_PATTERN_VERTICES = 8


def _pair_bit(a, b):
    """Bit index for unordered position pair (a < b)."""
    return (b * (b - 1)) // 2 + a


def n_pair_bits(nv: int) -> int:
    """Number of adjacency bits for an nv-vertex pattern."""
    return (nv * (nv - 1)) // 2


def decode(code) -> tuple[int, np.ndarray, np.ndarray]:
    """(n_vertices, dense adjacency (nv, nv) bool, labels (nv,))."""
    w0, w1, w2 = (int(x) for x in code)
    nv = w0 & 0xF
    bits = w0 >> 4
    adj = np.zeros((nv, nv), dtype=bool)
    for bb in range(1, nv):
        for aa in range(bb):
            if (bits >> _pair_bit(aa, bb)) & 1:
                adj[aa, bb] = adj[bb, aa] = True
    labels = np.array([(w1 >> (8 * i)) & 0xFF for i in range(4)]
                      + [(w2 >> (8 * i)) & 0xFF for i in range(4)])[:nv]
    return nv, adj, labels.astype(np.int32)


def encode(nv: int, adj: np.ndarray, labels: np.ndarray) -> tuple[int, int, int]:
    bits = 0
    for bb in range(1, nv):
        for aa in range(bb):
            if adj[aa, bb]:
                bits |= 1 << _pair_bit(aa, bb)
    w0 = nv | (bits << 4)
    w1 = w2 = 0
    for i in range(min(nv, 4)):
        w1 |= int(labels[i]) << (8 * i)
    for i in range(4, min(nv, 8)):
        w2 |= int(labels[i]) << (8 * (i - 4))
    return w0, w1, w2


_PERMS_CACHE: dict[int, np.ndarray] = {}


def _perms(nv: int) -> np.ndarray:
    if nv not in _PERMS_CACHE:
        _PERMS_CACHE[nv] = np.array(list(itertools.permutations(range(nv))), np.int32)
    return _PERMS_CACHE[nv]


_PERM_TABLES_CACHE: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def perm_tables(nv: int) -> tuple[np.ndarray, np.ndarray]:
    """Permutations + adjacency-bit source map for the device refine kernel.

    Returns ``(perms, bit_src)`` with ``perms`` (P, nv) int32 in
    ``itertools.permutations`` order (row 0 = identity) and ``bit_src``
    (P, nbits) int32 where target bit ``t = _pair_bit(a, b)`` of the
    permuted adjacency word is source bit
    ``_pair_bit(sorted(perm[a], perm[b]))`` of the unpermuted word —
    i.e. ``padj[a, b] = adj[perm[a], perm[b]]``, matching
    :func:`_canonicalize_batch` exactly.
    """
    got = _PERM_TABLES_CACHE.get(nv)
    if got is None:
        perms = _perms(nv)
        nbits = n_pair_bits(nv)
        src = np.zeros((len(perms), nbits), dtype=np.int32)
        for b in range(1, nv):
            for a in range(b):
                pa = perms[:, a]
                pb = perms[:, b]
                lo = np.minimum(pa, pb)
                hi = np.maximum(pa, pb)
                src[:, _pair_bit(a, b)] = (hi * (hi - 1)) // 2 + lo
        got = _PERM_TABLES_CACHE[nv] = (perms, src)
    return got


def _decode_batch(codes: np.ndarray, nv: int):
    """Vectorised :func:`decode` over (Q, 3) codes sharing ``n_verts``."""
    w0, w1, w2 = codes[:, 0], codes[:, 1], codes[:, 2]
    bits = w0 >> 4
    adj = np.zeros((len(codes), nv, nv), dtype=bool)
    for bb in range(1, nv):
        for aa in range(bb):
            on = ((bits >> _pair_bit(aa, bb)) & 1).astype(bool)
            adj[:, aa, bb] = adj[:, bb, aa] = on
    labels = np.zeros((len(codes), nv), dtype=np.int64)
    for i in range(min(nv, 4)):
        labels[:, i] = (w1 >> (8 * i)) & 0xFF
    for i in range(4, min(nv, 8)):
        labels[:, i] = (w2 >> (8 * (i - 4))) & 0xFF
    return adj, labels


def _encode_batch(adj: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Vectorised :func:`encode`: (Q, nv, nv) + (Q, nv) -> (Q, 3) int64."""
    q, nv = labels.shape
    bits = np.zeros(q, dtype=np.int64)
    for bb in range(1, nv):
        for aa in range(bb):
            bits |= adj[:, aa, bb].astype(np.int64) << _pair_bit(aa, bb)
    w0 = nv | (bits << 4)
    w1 = np.zeros(q, dtype=np.int64)
    w2 = np.zeros(q, dtype=np.int64)
    for i in range(min(nv, 4)):
        w1 |= labels[:, i] << (8 * i)
    for i in range(4, min(nv, 8)):
        w2 |= labels[:, i] << (8 * (i - 4))
    return np.stack([w0, w1, w2], axis=1)


def _lex_less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise lexicographic a < b over (Q, 3) code triples."""
    return (
        (a[:, 0] < b[:, 0])
        | ((a[:, 0] == b[:, 0]) & (a[:, 1] < b[:, 1]))
        | ((a[:, 0] == b[:, 0]) & (a[:, 1] == b[:, 1]) & (a[:, 2] < b[:, 2]))
    )


def _canonicalize_batch(codes: np.ndarray):
    """Batched :func:`canonicalize_one` over (Q, 3) codes sharing
    ``n_verts``: one vectorised pass per permutation instead of a Python
    loop per pattern. Identical tie-breaking (first minimal permutation
    wins), hence bit-identical canon codes and sigmas."""
    q = len(codes)
    nv = int(codes[0, 0]) & 0xF
    sigma = np.tile(np.arange(MAX_PATTERN_VERTICES, dtype=np.int32), (q, 1))
    if nv <= 1:
        return codes.astype(np.int64, copy=True), sigma
    adj, labels = _decode_batch(codes, nv)
    perms = _perms(nv)
    best = None
    best_pi = np.zeros(q, dtype=np.int64)
    for pi, perm in enumerate(perms):
        key = _encode_batch(adj[:, perm][:, :, perm], labels[:, perm])
        if best is None:
            best = key
        else:
            better = _lex_less(key, best)
            best = np.where(better[:, None], key, best)
            best_pi = np.where(better, pi, best_pi)
    chosen = perms[best_pi]                       # (Q, nv): canon pos -> local
    rows = np.arange(q)[:, None]
    sigma[rows, chosen] = np.arange(nv, dtype=np.int32)[None, :]
    return best, sigma


def canonicalize_one(code) -> tuple[tuple[int, int, int], np.ndarray]:
    """Canonical code of one quick pattern + the permutation sigma with
    sigma[local_pos] = canonical_pos achieving it (graph-isomorphism
    canonical form; exact, replaces bliss)."""
    nv, adj, labels = decode(code)
    if nv <= 1:
        return encode(nv, adj, labels), np.arange(MAX_PATTERN_VERTICES, dtype=np.int32)
    perms = _perms(nv)                        # (p!, nv): perm[i] = new position? see below
    best_key, best_sigma = None, None
    for perm in perms:
        # perm maps canonical position -> local position (a relabeling order)
        padj = adj[np.ix_(perm, perm)]
        plab = labels[perm]
        key = encode(nv, padj, plab)
        if best_key is None or key < best_key:
            best_key = key
            sigma = np.empty(nv, dtype=np.int32)
            sigma[perm] = np.arange(nv, dtype=np.int32)  # local -> canonical
            best_sigma = sigma
    full = np.arange(MAX_PATTERN_VERTICES, dtype=np.int32)
    full[:nv] = best_sigma
    return best_key, full


def automorphism_orbits(code) -> np.ndarray:
    """Orbit representative per vertex position of a (canonical) pattern.

    Min-image domains are defined over mappings from *any* automorphism of
    an embedding (paper §4.2); with a single fixed isomorphism per embedding
    (our sigma), the full domain of position p is the union of the
    single-isomorphism domains over p's orbit under Aut(pattern). Positions
    sharing a representative must have their domains OR-ed.
    """
    nv, adj, labels = decode(np.asarray(code))
    rep = np.arange(MAX_PATTERN_VERTICES, dtype=np.int32)
    if nv <= 1:
        return rep
    base = encode(nv, adj, labels)
    for perm in _perms(nv):
        padj = adj[np.ix_(perm, perm)]
        plab = labels[perm]
        if encode(nv, padj, plab) == base:
            # perm maps new position i -> old position perm[i]; i and
            # perm[i] are in the same orbit.
            for i in range(nv):
                a, b = rep[i], rep[perm[i]]
                if a != b:
                    lo, hi = (a, b) if a < b else (b, a)
                    rep[rep == hi] = lo
    return rep
