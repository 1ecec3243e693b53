"""Scan operands and the plain PyTorch versions of the kernels.

Counterpart of ``smafa_tpu.ops.distance`` and of the operand constructors in
``smafa_tpu.ops.pallas_scan``. For one-hot encodings the reference's
per-pair ``popcount(a ^ b) / 2`` (reference lib.rs:80-88) equals
``L - matches``; the matches come from a rank-4 embedding of the two
sides (see ``smafa_tpu.ops.distance``, "Rank-4 match embedding"):

    query side  q_l = onehot_{1..4}(code)            (code 0 -> zeros)
    db side     d_l = onehot_{1..4}(code), or (-1,-1,-1,-1) for code 0
    matches     = q . d + zc,  zc = number of code-0 positions of the db row

Operands, as the kernels take them:

- ``q_emb`` int8 [B, EP] and ``db_emb`` int8 [Wp, EP], EP = 4L rounded up
  to 32 bytes (one ``mma.sync`` k-step). The TPU's 128-lane padding and
  its zc column are gone, so any L whose keys pack into 31 bits works.
- ``zc`` int32 [Wp], added in the epilogue. Padding rows (>= the number
  of real windows) are poisoned: zero embedding and zc = -1, so their
  distance is exactly L + 1, above every real distance and threshold.

The plain versions run on CPU and CUDA tensors alike. The dot is taken
in float32 (``dots``): a position adds -1, 0 or 1, so every partial sum
of a row's dot is an integer of magnitude at most the positions summed,
exact in float32 up to 2^24. Windows of up to 2^24 bp take one float32
product; longer ones take it in column blocks of 2^24 positions
(``EXACT_COLS``), whose partials add in int32. int8 @ int8 is never
used, because on the CPU it returns int8 and wraps. TF32 would round
the products, so it is switched off before every float32 product on
the card.
"""

from __future__ import annotations

import torch

from smafa_tpu_torch.core.alphabet import N_CHANNELS
from smafa_tpu_torch.ops.keys import BIG_KEY, KSTATS_PROBES, kstats_steps

K_STEP = 32          # embed width granularity in bytes
WP_MULTIPLE = 64     # db rows per kernel tile: the runner pads Wp to this
CHUNK = 8192         # db rows per step of the plain versions
# Embedded columns of 2^24 window positions: a float32 product over at
# most this many is exact (see the module docstring).
EXACT_COLS = 4 << 24
# Bytes of one-hot temporaries an embedding step may make (16 a
# position: bool and int8 of four channels); below ~2 Mbp the
# CHUNK * 16-row cap binds first.
EMBED_TEMP_BYTES = 1 << 32
# Bytes of the [hits, L] code gathers of one ``hit_distances`` step.
GATHER_BYTES = 1 << 30


def embed_width(seq_len: int) -> int:
    return -(-4 * seq_len // K_STEP) * K_STEP


def _pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    if x.shape[-1] == width:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _channels(codes: torch.Tensor) -> torch.Tensor:
    return torch.arange(1, N_CHANNELS, dtype=codes.dtype, device=codes.device)


def expand_embed_query(codes: torch.Tensor, seq_len: int) -> torch.Tensor:
    """uint8 [..., L] channel codes -> int8 [..., EP] query embedding."""
    oh = (codes.unsqueeze(-1) == _channels(codes)).to(torch.int8)
    return _pad_cols(oh.reshape(*codes.shape[:-1], 4 * seq_len),
                     embed_width(seq_len))


def expand_embed_db(codes: torch.Tensor,
                    seq_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 [..., L] -> (int8 [..., EP] db embedding, int32 [...] zc)."""
    is0 = (codes.unsqueeze(-1) == 0).to(torch.int8)
    emb = (codes.unsqueeze(-1) == _channels(codes)).to(torch.int8) - is0
    zc = (codes == 0).sum(dim=-1, dtype=torch.int32)
    return (_pad_cols(emb.reshape(*codes.shape[:-1], 4 * seq_len),
                      embed_width(seq_len)), zc)


def embed_db(codes: torch.Tensor, seq_len: int,
             wp: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The db twin the kernels scan: [n, L] codes -> (int8 [wp, EP],
    int32 [wp]) with rows n..wp-1 poisoned to distance L + 1."""
    emb = torch.empty((wp, embed_width(seq_len)), dtype=torch.int8,
                      device=codes.device)
    zc = torch.empty((wp,), dtype=torch.int32, device=codes.device)
    embed_db_into(codes, seq_len, emb, zc)
    return emb, zc


def embed_db_into(codes: torch.Tensor, seq_len: int, emb: torch.Tensor,
                  zc: torch.Tensor) -> None:
    """``embed_db`` into a twin allocated before (int8 [wp, EP], int32
    [wp], on the codes' device): [n, L] codes, n <= wp, fill rows 0..n-1
    and poison rows n..wp-1 to distance L + 1."""
    n = codes.shape[0]
    # bound the one-hot temporaries, by rows and by bytes
    step = max(1, min(CHUNK * 16, EMBED_TEMP_BYTES // (16 * seq_len)))
    for off in range(0, n, step):
        e, z = expand_embed_db(codes[off:off + step], seq_len)
        emb[off:off + e.shape[0]] = e
        zc[off:off + e.shape[0]] = z
    emb[n:].zero_()
    zc[n:] = -1


def dots(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """int32 [B, w] exact dots of embedded rows q [B, C] and d [w, C]
    (int8 or float32 holding -1, 0 and 1, at most one nonzero of q in
    each position's four columns): one float32 product up to
    EXACT_COLS columns, else one a block of EXACT_COLS columns, the
    blocks' partials added in int32."""
    if q.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    cols = q.shape[1]
    if cols <= EXACT_COLS:
        return (q.to(torch.float32) @ d.to(torch.float32).T).to(torch.int32)
    out = torch.zeros((q.shape[0], d.shape[0]), dtype=torch.int32,
                      device=q.device)
    for c0 in range(0, cols, EXACT_COLS):
        c1 = c0 + EXACT_COLS
        out += (q[:, c0:c1].to(torch.float32)
                @ d[:, c0:c1].to(torch.float32).T).to(torch.int32)
    return out


def distances(q_f: torch.Tensor, d_emb: torch.Tensor, zc: torch.Tensor,
              seq_len: int) -> torch.Tensor:
    """int32 [B, w] distances of query rows (int8 or float32 embedding)
    vs db rows (exact Hamming distances for real rows: N against N is a
    match), at any window length (``dots``)."""
    return seq_len - dots(q_f, d_emb) - zc.unsqueeze(0)


def dist_block_reference(q_emb: torch.Tensor, db_emb: torch.Tensor,
                         zc: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Plain version of the dist_block kernel (the ``block_distances``
    of ``smafa_tpu``'s ``topm_scan`` and ``min_scan``): int32 [B, Wp],
    dist[b, w] = seq_len - (q_emb[b] . db_emb[w] + zc[w]); padding rows
    read seq_len + 1."""
    out = torch.empty((q_emb.shape[0], db_emb.shape[0]), dtype=torch.int32,
                      device=q_emb.device)
    # wide rows convert a column block at a time, inside ``dots``, and
    # take fewer db rows a step (float32 blocks of 2 GiB at most)
    cols = min(q_emb.shape[1], EXACT_COLS)
    q_f = q_emb.to(torch.float32) if q_emb.shape[1] <= EXACT_COLS else q_emb
    step = max(1, min(CHUNK, (1 << 31) // (4 * cols)))
    for off in range(0, db_emb.shape[0], step):
        out[:, off:off + step] = distances(
            q_f, db_emb[off:off + step], zc[off:off + step], seq_len)
    return out


def min2_reference(q_emb: torch.Tensor, db_emb: torch.Tensor,
                   zc: torch.Tensor, seq_len: int, shift: int,
                   with_count: bool = True) -> tuple[torch.Tensor, ...]:
    """Plain version of the min2 kernel (the semantics of
    ``min2_scan_pallas`` and ``min2_scan`` with span = Wp): per query row
    lo = min (dist << shift) | w, hi = min (dist << shift) | (Wp-1-w),
    and with_count the number of windows at the row's min distance.
    Returns (lo, hi[, cnt]) int32 [B]."""
    b, wp = q_emb.shape[0], db_emb.shape[0]
    dev = q_emb.device
    lo = torch.full((b,), BIG_KEY, dtype=torch.int32, device=dev)
    hi = lo.clone()
    cnt = torch.zeros((b,), dtype=torch.int32, device=dev)
    dmin = torch.full((b,), 2**30, dtype=torch.int32, device=dev)
    q_f = q_emb.to(torch.float32)
    for off in range(0, wp, CHUNK):
        d_emb = db_emb[off:off + CHUNK]
        dist = distances(q_f, d_emb, zc[off:off + CHUNK], seq_len)
        idx = torch.arange(off, off + d_emb.shape[0], dtype=torch.int32,
                           device=dev)
        sh = dist << shift
        lo = torch.minimum(lo, (sh | idx).amin(dim=1))
        hi = torch.minimum(hi, (sh | (wp - 1 - idx)).amin(dim=1))
        if with_count:
            cd = dist.amin(dim=1)
            cc = (dist == cd.unsqueeze(1)).sum(dim=1, dtype=torch.int32)
            cnt = torch.where(cd < dmin, cc,
                              torch.where(cd == dmin, cnt + cc, cnt))
            dmin = torch.minimum(dmin, cd)
    return (lo, hi, cnt) if with_count else (lo, hi)


def min2_pair_init(b: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Empty carry of ``min2_pair_merge``: (dist 2^30, i_lo and i_hi
    2^31 - 1, count 0) int32 [b]."""
    def full(v: int) -> torch.Tensor:
        return torch.full((b,), v, dtype=torch.int32, device=device)

    return full(2**30), full(BIG_KEY), full(BIG_KEY), full(0)


def min2_pair_merge(carry: tuple[torch.Tensor, ...], lo: torch.Tensor,
                    hi: torch.Tensor, cnt: torch.Tensor, off: int, span: int,
                    shift: int, seq_len: int) -> tuple[torch.Tensor, ...]:
    """Fold one db slab's min2 result into the carry (dist, i_lo, i_hi,
    count) of global indices (``smafa_tpu.parallel.slab._min2_step``,
    plus the tie count). The slab's keys pack slab-locally: lo decodes to
    index ``off + (lo & mask)`` and hi to ``off + (span - 1 - (hi &
    mask))``. Slabs come in ascending ``off``, so the lowest index keeps
    ties (strict <) and the highest takes them (<=); the count is
    replaced where the slab's min is smaller and summed where it is
    equal. A slab with no real row (its min decodes past ``seq_len``)
    leaves the carry as it is."""
    mask = (1 << shift) - 1
    empty = (lo == BIG_KEY) | ((lo >> shift) > seq_len)
    return min2_pair_fold(carry, (
        torch.where(empty, 2**30, lo >> shift),
        torch.where(empty, BIG_KEY, (lo & mask) + off),
        torch.where(empty, BIG_KEY, (span - 1 - (hi & mask)) + off),
        torch.where(empty, 0, cnt)))


def min2_pair_fold(carry: tuple[torch.Tensor, ...],
                   later: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
    """Fold the carry ``later`` (dist, i_lo, i_hi, count) of rows whose
    indices all exceed the carry's into ``carry``: the lowest index keeps
    ties (strict <), the highest takes them (<=), and the count is
    replaced where ``later``'s min is smaller and summed where it is
    equal. An empty ``later`` (dist 2^30, count 0) leaves the carry as it
    is."""
    d, i_lo, i_hi, c = carry
    d2, il2, ih2, c2 = later
    c = torch.where(d2 < d, c2, torch.where(d2 == d, c + c2, c))
    return (torch.minimum(d, d2), torch.where(d2 < d, il2, i_lo),
            torch.where(d2 <= d, ih2, i_hi), c)


def min2_pair_finish(carry: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
    """A merged carry -> (pair int32 [3, b] = (dist, i_lo, i_hi), count),
    the pair form ``HitModesMixin._min2_unpack`` reads (the convention of
    ``smafa_tpu.ops.distance.min2_pair_finish``): rows with no window
    read dist 2^30 and index 2^31 - 1 on both sides, count 0."""
    d, i_lo, i_hi, c = carry
    empty = d >= 2**30
    return (torch.stack([torch.where(empty, 2**30, d),
                         torch.where(empty, BIG_KEY, i_lo),
                         torch.where(empty, BIG_KEY, i_hi)]).to(torch.int32),
            torch.where(empty, 0, c).to(torch.int32))


def min_count_reference(q_emb: torch.Tensor, db_emb: torch.Tensor,
                        zc: torch.Tensor, n_valid: int, seq_len: int,
                        shift: int,
                        with_count: bool = True) -> tuple[torch.Tensor, ...]:
    """Plain version of the min_count kernel (the semantics of
    ``min_count_scan`` and of ``min1_scan`` with index offset 0): per
    query row, key = min over db rows w < n_valid of (dist << shift) | w,
    BIG_KEY when n_valid == 0; with_count also the number of those rows
    at the row's min distance (0 when n_valid == 0). Rows at or past
    n_valid are never read. Returns (key[, cnt]) int32 [B]."""
    b = q_emb.shape[0]
    dev = q_emb.device
    key = torch.full((b,), BIG_KEY, dtype=torch.int32, device=dev)
    cnt = torch.zeros((b,), dtype=torch.int32, device=dev)
    q_f = q_emb.to(torch.float32)
    for off in range(0, n_valid, CHUNK):
        end = min(off + CHUNK, n_valid)
        dist = distances(q_f, db_emb[off:end], zc[off:end], seq_len)
        idx = torch.arange(off, end, dtype=torch.int32, device=dev)
        new_key = torch.minimum(key, ((dist << shift) | idx).amin(dim=1))
        if with_count:
            cd = new_key >> shift  # this chunk's or an earlier min distance
            cc = (dist == cd.unsqueeze(1)).sum(dim=1, dtype=torch.int32)
            cnt = torch.where(cd < key >> shift, cc, cnt + cc)
        key = new_key
    return (key, cnt) if with_count else (key,)


def unpack_min_key(key: torch.Tensor,
                   shift: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed min keys -> (dist, idx) int32, with ``min_count_scan``'s
    sentinels for empty rows: dist 2**30, idx 2**31 - 1."""
    empty = key == BIG_KEY
    dist = torch.where(empty, 2**30, key >> shift)
    idx = torch.where(empty, BIG_KEY, key & ((1 << shift) - 1))
    return dist.to(torch.int32), idx.to(torch.int32)


_BIT_WEIGHTS = [1 << j for j in range(32)]


def compact_mask_reference(q_emb: torch.Tensor, db_emb: torch.Tensor,
                           zc: torch.Tensor, thresh: torch.Tensor,
                           seq_len: int) -> torch.Tensor:
    """Plain version of the compact_mask kernel (the semantics of
    ``compact_mask_pallas``): int32 [B, Wp/32] words whose bit j of word
    w in row r is set iff window 32w+j has dist <= thresh[r]."""
    b, wp = q_emb.shape[0], db_emb.shape[0]
    dev = q_emb.device
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int64, device=dev)
    mask = torch.empty((b, wp // 32), dtype=torch.int32, device=dev)
    q_f = q_emb.to(torch.float32)
    for off in range(0, wp, CHUNK):
        dist = distances(q_f, db_emb[off:off + CHUNK],
                          zc[off:off + CHUNK], seq_len)
        hit = (dist <= thresh.unsqueeze(1)).to(torch.int64)
        words = (hit.view(b, -1, 32) * weights).sum(dim=2)
        words = torch.where(words >= 2**31, words - 2**32, words)
        mask[:, off // 32:off // 32 + words.shape[1]] = words.to(torch.int32)
    return mask


def extract_mask_hits(mask: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """int32 [B, Wp/32] hit mask -> (rows, idx, counts), int64: every set
    bit as (row, window index) in (row, index) order, and the exact hit
    count of each of the B rows (the contract of
    ``smafa_tpu.ops.distance.extract_mask_hits``). Only the nonzero words
    expand to bits, so the cost follows the hits, not the mask."""
    r, wi = torch.nonzero(mask, as_tuple=True)  # row-major order
    shifts = torch.arange(32, dtype=torch.int32, device=mask.device)
    bits = (mask[r, wi].unsqueeze(1) >> shifts) & 1  # `& 1` masks the sign
    k, j = torch.nonzero(bits, as_tuple=True)
    rows = r[k]
    counts = torch.bincount(rows, minlength=mask.shape[0])
    return rows, wi[k] * 32 + j, counts


def hit_distances(q_codes: torch.Tensor, db_codes: torch.Tensor,
                  rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int32 distance of each hit (query row ``rows[h]`` vs db window
    ``idx[h]``) from the channel codes, N against N a match: the gather
    and compare of ``smafa_tpu``'s ``compactd`` program."""
    L = db_codes.shape[1]
    step = max(1, GATHER_BYTES // max(1, L))  # bound the [hits, L] gathers
    if rows.shape[0] <= step:
        return (q_codes[rows, :L] != db_codes[idx]).sum(dim=1,
                                                        dtype=torch.int32)
    return torch.cat([
        (q_codes[rows[s:s + step], :L] != db_codes[idx[s:s + step]])
        .sum(dim=1, dtype=torch.int32) for s in range(0, rows.shape[0], step)])


def sort_hit_keys(rows: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Per-hit keys ``(dist << shift) | idx`` (non-negative, below 2^31)
    sorted by (row, key), so each row's hits come in the reference's
    (distance, index) order (``smafa_tpu.ops.distance.sort_hit_keys``)."""
    comp = (rows.to(torch.int64) << 31) | keys.to(torch.int64)
    return torch.sort(comp).values & (2**31 - 1)


def stats_reference(q_emb: torch.Tensor, db_emb: torch.Tensor,
                    zc: torch.Tensor, ts: torch.Tensor, n_valid: int,
                    seq_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kstats kernel (the semantics of
    ``smafa_tpu.ops.distance._statsN_pass``): per query row r over db
    rows w < n_valid, cnt[p, r] = #{w : dist <= ts[p, r]} and mx[r] the
    max distance, -1 when n_valid == 0. Rows at or past n_valid are never
    read. Returns (cnt int32 [P, B], mx int32 [B])."""
    b = q_emb.shape[0]
    dev = q_emb.device
    cnt = torch.zeros(tuple(ts.shape), dtype=torch.int32, device=dev)
    mx = torch.full((b,), -1, dtype=torch.int32, device=dev)
    q_f = q_emb.to(torch.float32)
    for off in range(0, n_valid, CHUNK):
        end = min(off + CHUNK, n_valid)
        dist = distances(q_f, db_emb[off:end], zc[off:end], seq_len)
        for p in range(ts.shape[0]):
            cnt[p] += (dist <= ts[p].unsqueeze(1)).sum(dim=1, dtype=torch.int32)
        mx = torch.maximum(mx, dist.amax(dim=1))
    return cnt, mx


def hist_reference(q_emb: torch.Tensor, db_emb: torch.Tensor,
                   zc: torch.Tensor, n_valid: int,
                   seq_len: int) -> torch.Tensor:
    """Plain version of the hist kernel (the semantics of
    ``smafa_tpu.ops.distance.hist_scan``): int32 [B, L+1], hist[r, d] the
    number of db rows w < n_valid at distance d from query row r. Rows at
    or past n_valid are never read."""
    b = q_emb.shape[0]
    hist = torch.zeros((b, seq_len + 1), dtype=torch.int32,
                       device=q_emb.device)
    q_f = q_emb.to(torch.float32)
    for off in range(0, n_valid, CHUNK):
        end = min(off + CHUNK, n_valid)
        dist = distances(q_f, db_emb[off:end], zc[off:end], seq_len)
        hist.scatter_add_(1, dist.to(torch.int64), torch.ones_like(dist))
    return hist


def kmode_cutoffs_from_hist(hist: torch.Tensor, k: int,
                            max_divergence: int | None,
                            n_windows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The K-mode cutoff rule read off the distance histogram
    (``smafa_tpu.ops.distance.kmode_cutoffs_from_hist``, in torch on the
    histogram's device, so nothing is read back): the cutoff is the K-th
    smallest distance, or the row's largest when K exceeds the window
    count (lib.rs:253-256); eff = min(cutoff, max_divergence) clipped to
    [0, L], and hits the number of windows at distance <= eff. Returns
    (eff, hits) int32 [B], as ``kmode_phase1`` does."""
    seq_len = hist.shape[1] - 1
    cum = hist.cumsum(dim=1, dtype=torch.int64)
    kth = (cum < k).sum(dim=1)  # first d with cum[d] >= k; L + 1 if none
    # the last nonzero bin (L where a row is empty, as numpy's argmax)
    last = torch.argmax((hist > 0).flip(1).to(torch.int32), dim=1)
    cutoff = kth if k <= n_windows else seq_len - last
    if max_divergence is not None:
        cutoff = torch.clamp(cutoff, max=max_divergence)
    eff = torch.clamp(cutoff, 0, seq_len)
    hits = cum.gather(1, eff.unsqueeze(1)).squeeze(1)
    return eff.to(torch.int32), hits.to(torch.int32)


def kmode_phase1(scan_stats, k: int, maxdiv: int, n_windows: int,
                 seq_len: int, b: int,
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """K-mode cutoff search (``smafa_tpu.ops.distance.kmode_phase1``):
    per query row, the effective cutoff ``eff`` and the exact number of
    windows at distance <= eff, by the reference rule (lib.rs:253-265):
    the cutoff is the K-th smallest distance, or the row max when K
    exceeds the window count, and eff = min(cutoff, maxdiv).

    ``scan_stats(ts [P, B]) -> (cnt [P, B], mx [B])`` is one db pass at P
    = KSTATS_PROBES per-row thresholds: P - 1 interior probes of a P-way
    partition search for the smallest t with count(<= t) >= k, and
    min(maxdiv, L) as the last. kstats_steps(L) passes; ``maxdiv`` is
    L + 1 when unused. Everything stays on the device: the passes queue
    on the stream and nothing is read back. Returns (eff, hits) int32 [B].
    """
    P = KSTATS_PROBES

    def full(v: int) -> torch.Tensor:
        return torch.full((b,), v, dtype=torch.int32, device=device)

    md_c = min(maxdiv, seq_len)
    lo, hi = full(0), full(seq_len)
    # count(<= L) == n_windows: the upper bound's count is known before
    # any pass; it only ever tightens.
    cnt_hi = full(n_windows)
    cnt_md, mx = full(0), full(-1)
    for _ in range(kstats_steps(seq_len)):
        ms = [(lo * (P - i) + hi * i) // P for i in range(1, P)]
        cnts, mx = scan_stats(torch.stack(ms + [full(md_c)]))
        # the smallest probe with count >= k bounds the answer from
        # above; fold the cascade from the last interior probe down
        new_hi, new_cnt, new_lo = hi, cnt_hi, ms[-1] + 1
        for i in range(P - 2, -1, -1):
            ge = cnts[i] >= k
            new_hi = torch.where(ge, ms[i], new_hi)
            new_cnt = torch.where(ge, cnts[i], new_cnt)
            new_lo = torch.where(ge, lo if i == 0 else ms[i - 1] + 1, new_lo)
        lo, hi, cnt_hi, cnt_md = (torch.minimum(new_lo, new_hi), new_hi,
                                  new_cnt, cnts[P - 1])
    kth = hi  # smallest t with count(<= t) >= k (L if none)
    eff = torch.clamp(mx if k > n_windows else kth, max=maxdiv)
    # hits at eff with no extra pass: eff is md_c (probed every pass),
    # kth (tracked) or the row max (count(<= max) == n_windows); where
    # these coincide the counts agree, so the branch order is free.
    hits = torch.where(eff == md_c, cnt_md,
                       torch.where(eff == kth, cnt_hi, full(n_windows)))
    return eff, hits
