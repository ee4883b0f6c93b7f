"""The genotyping posterior: the plain numpy version with the kernel's
contract.

``posterior_plain(out, alpha, beta, kind, gt, state_u, smask, c, f, kmask,
bits)`` reduces each real node row (``kind == 1``) of G windows from
its forward and backward chains to what the node's record needs, as the
kernel ``csrc/post.cu`` does (``ops/post_cuda.posterior_``).  Each window
goes through ``posterior_window_np``, the engine's vectorised float64 body
(genotype.cpp:1371-1546): post = alpha·beta / Σ alpha·beta (0 where the sum
is 0), genotype keys packed from the state's sorted GT values, each key's
summed posterior, the winner group (the smallest key of the best sum), its
first state of the strictly largest post, and NAK/CAK/UK.

Arguments (all contiguous CPU tensors): out int32 [G, N, ``row_width(P)``];
alpha, beta float32 [G, N, S]; kind int32 [G, N]
(0 pad, 1 real, 2 reset; a window's pad rows follow its nodes); gt uint8
[G, N, 32 W], the node's GT value of each used hap (saturated at 255); state_u
int32 [G, S, P], each state's used-hap slots; smask bool [G, S] (a window's
valid states come first); c, f uint8 [G, N, K]; kmask bool [G, N, K]; bits
int32 [G, N, K, W], the used haps' uint32 words (hap u is bit u % 32 of
word u // 32).

A row of ``out`` holds, at the offsets below: the node's probability (the
best key's sum, a float64 in two int32 slots), the winner state (``NO_WINNER``
when its post is 0, ``FALLBACK`` when a GT above 9 sends the node to the
string-keyed path), UK, and the winner state's P NAK and P CAK in state
order.  A fallback row holds only its winner slot and UK: the host computes
its post from its alpha and beta rows with ``post_rows``.  A row that is not
real reads 0 but ``NO_WINNER``.
"""

from __future__ import annotations

import numpy as np

from ..utils import timing

# offsets in a row of ``out``
PROB, WINNER, UK, NAK = 0, 2, 3, 4
NO_WINNER, FALLBACK = -1, -2


def row_width(P: int) -> int:
    """int32 slots a node's row of ``out`` holds: 16 + 8 P bytes."""
    return NAK + 2 * P


def probabilities(out: np.ndarray) -> np.ndarray:
    """The float64 probabilities of ``out``'s rows ([..., row_width])."""
    return np.ascontiguousarray(out[..., PROB:PROB + 2]).view(np.float64)[..., 0]


def post_rows(alpha, beta) -> np.ndarray:
    """post = alpha·beta / Σ alpha·beta in float64 over each row of the
    float32 [n, s] chains, 0 where the sum is 0."""
    ab = alpha.astype(np.float64) * beta.astype(np.float64)
    den = ab.sum(axis=1)
    safe_den = np.where(den != 0, den, 1.0)
    return np.where((den != 0)[:, None], ab / safe_den[:, None], 0.0)


def posterior_window_np(kind, alpha_w, beta_w, G_nu, state_u, bits_u, c, f,
                        kmask, n: int, s: int):
    """One window's posterior in float64 numpy: (post, fallback,
    best_score_n, win_si, has_winner, nak_nu, cak_num, uk_n) over its n
    nodes and s states.  G_nu [n, U] GT values, state_u [s, P] slots,
    bits_u [n, K, U] 0/1, c, f int32 and kmask bool [n, K]."""
    # Genotype grouping uses string-sorted keys in the reference
    # (std::map<string>, genotype.cpp:1441-1459).  For GT values <= 9 the
    # string order of "a/b/..." (digits sorted ascending) equals the
    # lexicographic order of the ascending-sorted numeric tuples, so groups
    # are formed with packed integer keys; rare nodes carrying GT >= 10 fall
    # back to the exact string path.
    real = kind == 1
    post = post_rows(alpha_w[:n, :s], beta_w[:n, :s])

    # per-node GT values of the used haplotypes [n, U], gathered once
    # from the per-chrom GT matrix during prep
    G_nsp = G_nu[:, state_u]                    # [n, S, P]
    fallback = (G_nsp.max(axis=(1, 2)) > 9) & real

    P = state_u.shape[1]
    gts_sorted = np.sort(G_nsp, axis=2)          # ascending == sorted(str) for <=9
    shifts = (8 * np.arange(P - 1, -1, -1)).astype(np.int64)
    keys_ns = (gts_sorted << shifts).sum(axis=2)  # [n, S]

    # group-by per node: stable sort by key, segment sums, best = max
    # score with smallest key on ties (ascending scan with strict >)
    order = np.argsort(keys_ns, axis=1, kind="stable")
    ksort = np.take_along_axis(keys_ns, order, axis=1)
    psort = np.take_along_axis(post, order, axis=1)
    gstart = np.ones((n, s), bool)
    gstart[:, 1:] = ksort[:, 1:] != ksort[:, :-1]
    gid = np.cumsum(gstart, axis=1) - 1           # group index per position
    last_in_group = np.ones((n, s), bool)
    last_in_group[:, :-1] = gstart[:, 1:]
    csum = np.cumsum(psort, axis=1)
    # csum value just before each group's start, forward-filled within
    # the group (csum is nondecreasing, so maximum.accumulate fills)
    shifted = np.zeros_like(csum)
    shifted[:, 1:] = csum[:, :-1]
    base = np.maximum.accumulate(
        np.where(gstart, shifted, -np.inf), axis=1
    )
    totals_end = np.where(last_in_group, csum - base, -np.inf)  # [n, s]
    best_score_n = totals_end.max(axis=1)
    # first group (smallest key) achieving the max
    win_pos = np.argmax(totals_end == best_score_n[:, None], axis=1)
    win_group = np.take_along_axis(gid, win_pos[:, None], axis=1)[:, 0]

    # winner state: first (by si) strictly-max post among winner-group
    # states, matching `if max_post < post[si]` with max_post starting 0
    in_win = gid == win_group[:, None]            # positions in sorted order
    win_mask = np.zeros((n, s), bool)             # by original si
    np.put_along_axis(win_mask, order, in_win, axis=1)
    post_w = np.where(win_mask, post, -np.inf)
    max_post_n = post_w.max(axis=1)
    win_si = np.argmax(post_w == max_post_n[:, None], axis=1)
    has_winner = max_post_n > 0.0

    # NAK/CAK/UK, vectorized over the prep tensors
    nak_nu = (bits_u * kmask[:, :, None]).sum(axis=1)   # [n, U]
    cak_num = (c[:, :, None] * bits_u
               * kmask[:, :, None]).sum(axis=1)              # [n, U]
    uk_n = np.minimum(((f <= 1) & kmask).sum(axis=1), 255)
    return (post, fallback, best_score_n, win_si, has_winner, nak_nu,
            cak_num, uk_n)


def unpack_words(words: np.ndarray) -> np.ndarray:
    """[..., W] int32 hap words -> [..., 32 W] uint8 0/1, bit i of word w at
    w * 32 + i (the words' little-endian bytes, each little bit first)."""
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=-1,
                         bitorder="little")


def posterior_plain(out, alpha, beta, kind, gt, state_u, smask, c, f, kmask,
                    bits) -> None:
    """Fills ``out`` for G windows, one ``posterior_window_np`` a window (see
    the module docstring)."""
    o = out.numpy()
    kind_g, sm_g = kind.numpy(), smask.numpy()
    P = state_u.shape[2]
    o[...] = 0
    o[..., WINNER] = NO_WINNER
    for g in range(out.shape[0]):
        n = int((kind_g[g] != 0).sum())
        s = int(sm_g[g].sum())
        timing.count("post.plain_windows")
        if n == 0:
            continue
        kd = kind_g[g, :n]
        su = state_u[g, :s].numpy()
        (_, fallback, best, win_si, has_winner, nak_nu, cak_num,
         uk_n) = posterior_window_np(
            kd, alpha[g].numpy(), beta[g].numpy(),
            gt[g, :n].numpy().astype(np.int64), su,
            unpack_words(bits[g, :n].numpy()), c[g, :n].numpy().astype(np.int32),
            f[g, :n].numpy().astype(np.int32), kmask[g, :n].numpy(), n, s)
        real = kd == 1
        card = real & ~fallback
        won = card & has_winner
        row = o[g, :n]
        row[:, PROB:PROB + 2] = np.where(card, best, 0.0).view(np.int32).reshape(n, 2)
        row[won, WINNER] = win_si[won]
        row[fallback, WINNER] = FALLBACK
        row[real, UK] = uk_n[real]
        slots = su[win_si[won]]                              # [w, P]
        row[won, NAK:NAK + P] = np.take_along_axis(nak_nu[won], slots, axis=1)
        row[won, NAK + P:NAK + 2 * P] = np.take_along_axis(cak_num[won], slots,
                                                           axis=1)
