"""Structured covariance for uniform time grids (Toeplitz path).

All the reference's MNIST configs use uniform grids (times ``1..20``,
src/Models/Full_GP_VAE_fixed_for_MovMnist.py:280), where the gram is
symmetric Toeplitz — fully described by its first row (kernels.toeplitz_row,
O(T) memory instead of O(T^2)).  This module exploits that structure for the
long-sequence regime (BASELINE.json config 3, T=1024) where dense O(T^3)
work is wasteful on the *prior* side (fixed per-latent lengthscales, shared
across the batch):

* :func:`durbin_logdet` — log-determinant in O(T^2) via the Durbin
  recursion's prediction-error variances (det T = prod_k E_k), as a
  ``lax.scan`` of full-width elementwise ops;
* :func:`tri_toeplitz_matvec` / :func:`tri_toeplitz_matvec_t` — O(T log T)
  FFT application of the Gohberg-Semencul inverse factors (solves and the
  KL trace/quad terms ride these; a scan-based Levinson solver was removed
  in round 3 as production-dead once the GS route landed);
* :func:`circulant_prior_sample` — exact GP prior draws on a uniform grid
  in O(T log T) via circulant embedding + FFT, replacing the O(T^3)
  chol-then-matmul sampling path for long sequences.

The dense batched Cholesky remains the path for the posterior
bank (learnable lengthscales, per-sequence grams).
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

from gpvae_tpu import kernels as kernels_lib

def _durbin_block_config() -> tuple[int, int, bool]:
    """(block width, min T, compensated theta) for the blocked
    Schur/Durbin dispatch.

    Block width 0 disables the blocked path and every Durbin entry point
    falls back to the classical length-T scan.  A wider block means fewer
    tail-update roundings (128 is also the more accurate setting).  Below
    ``min T`` orders the scan is preferred (the blocked path's per-block
    conv glue isn't amortized; both paths are exact, so this is purely a
    speed dispatch).  The defaults have not been re-measured on the GPU.

    ``GPVAE_DURBIN_COMP`` (default on) routes the per-block Szego
    transfer-matrix product through the two-float compensated tree
    (:func:`_theta_tree_comp`) AND the tail advance through the
    compensated elementwise convolution (:func:`_gconv_causal_comp2`).
    Per-stage fp64 attribution on the CPU pinned the theta products as
    the dominant *algebraic* error (benchmarks/prof_durbin_comp.py); the
    compensated conv removes the rounding floor of a hardware
    convolution's tail update as well.

    Read from the environment on EVERY call and threaded into the jitted
    entry points as static arguments, so the jit cache keys on the values
    and changing ``GPVAE_DURBIN_BLOCK`` / ``GPVAE_DURBIN_MIN_T`` /
    ``GPVAE_DURBIN_COMP`` between calls takes effect without
    ``jax.clear_caches()``.
    """
    return (
        int(os.environ.get("GPVAE_DURBIN_BLOCK", "128")),
        int(os.environ.get("GPVAE_DURBIN_MIN_T", "256")),
        os.environ.get("GPVAE_DURBIN_COMP", "1") != "0",
    )


def _clamp_alpha(alpha: jnp.ndarray) -> jnp.ndarray:
    """Clamp a reflection coefficient into the open PD region (-1, 1).

    For a PD Toeplitz matrix every |alpha_k| < 1 exactly; fp32 rounding in
    near-singular regimes (e.g. T=4096, lengthscale spanning ~600 grid
    steps) can push a computed alpha past 1, making 1 - alpha^2 negative
    and NaN-ing every downstream log.  The limit is dtype-aware — 8 ulps
    below 1 (fp32 ~1e-6, fp64 ~1.8e-15) — so the clamp is the identity for
    every alpha the dtype can meaningfully represent inside the PD region
    (fp64 oracles and near-singular fp64 callers keep full precision and
    gradient flow); past it the recursion degrades gracefully
    instead of poisoning the whole logdet (measured: the clamped blocked
    path matches the fp64 oracle to 1.8e-4 in the regime that NaN'd)."""
    lim = jnp.asarray(1.0, alpha.dtype) - 8 * jnp.finfo(alpha.dtype).eps
    return jnp.clip(alpha, -lim, lim)


def _durbin_scan(rho: jnp.ndarray):
    """Run the Durbin recursion on normalized autocovariances ``rho [T-1]``.

    Returns (log_errors [T-1], y, rev_y): per-order normalized prediction
    error variances E_k (log), and the final forward (Yule-Walker) solution
    with its reversal (the Gohberg-Semencul ingredients).
    """
    t1 = rho.shape[-1]
    idx = jnp.arange(t1)

    def step(carry, k):
        y, rev_y, e = carry
        # alpha_k = -(rho[k] + <rho[:k], rev_y[:k]>) / E_{k}
        valid = (idx < k).astype(rho.dtype)
        num = rho[k] + jnp.sum(rho * rev_y * valid)
        alpha = _clamp_alpha(-num / e)
        y_new = y + alpha * rev_y
        y_new = jnp.where(idx == k, alpha, jnp.where(idx < k, y_new, 0.0))
        # reverse of the order-(k+1) solution: [alpha, rev_y + alpha*y]
        rev_shift = jnp.roll(rev_y + alpha * y, 1)
        rev_new = jnp.where(
            idx == 0, alpha, jnp.where(idx <= k, rev_shift, 0.0)
        )
        e_new = e * (1.0 - alpha * alpha)
        return (y_new, rev_new, e_new), jnp.log(e_new)

    init = (jnp.zeros_like(rho), jnp.zeros_like(rho), jnp.asarray(1.0, rho.dtype))
    (y, rev_y, e), log_e = jax.lax.scan(step, init, jnp.arange(t1))
    return log_e, y, rev_y, e


def _shift1(x: jnp.ndarray) -> jnp.ndarray:
    """Shift right by one along the last axis, zero-filling (Z in the
    polynomial recursions — no wraparound)."""
    return jnp.concatenate([jnp.zeros_like(x[..., :1]), x[..., :-1]], -1)


def _gconv_causal(x: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """Per-channel causal convolution ``out[c, m] = sum_d k[c, d] x[c, m-d]``
    for ``x [C, T]``, ``k [C, W]`` -> ``[C, T]`` (grouped direct conv at
    HIGHEST precision; lax.conv is cross-correlation, so the kernel is
    flipped and left-padded by W-1)."""
    c, _t = x.shape
    w = k.shape[-1]
    out = jax.lax.conv_general_dilated(
        x[None], k[:, None, ::-1],
        window_strides=(1,), padding=[(w - 1, 0)],
        dimension_numbers=("NCW", "OIW", "NCW"),
        feature_group_count=c,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[0]


def _theta_tree(alphas: jnp.ndarray) -> tuple[jnp.ndarray, ...]:
    """2x2 polynomial transfer matrix Theta(Z) = M_nb ... M_1 for
    ``alphas [B, nb]`` (nb a power of two), where
    M_k = [[1, alpha_k Z], [alpha_k, Z]].

    Built by a log2(nb)-depth pairwise product tree — each level is ONE
    grouped direct convolution over all pairs (8 coefficient products
    batched into the channel axis).  The pairwise order matters for more
    than speed: a *sequential* fp32 accumulation of the 128-step product
    loses ~3 digits to cancellation and was measured to corrupt the
    blocked recursion catastrophically in near-singular regimes (alpha
    drifting to +-1 where the true value is 8e-4); the tree's log-depth
    accumulation matches the fp64-accumulated Theta to working precision.
    Returns (th11, th12, th21, th22), each ``[B, nb+1]``.
    """
    bsz, nb = alphas.shape
    dt = alphas.dtype
    zeros = jnp.zeros_like(alphas)
    ones = jnp.ones_like(alphas)
    # leaves [B, nb, 2]: M_k's entries as degree-1 coefficient vectors
    th11 = jnp.stack([ones, zeros], -1)
    th12 = jnp.stack([zeros, alphas], -1)
    th21 = jnp.stack([alphas, zeros], -1)
    th22 = jnp.stack([zeros, ones], -1)
    p = nb
    while p > 1:
        ln = th11.shape[-1]
        a_ = [x[:, 1::2] for x in (th11, th12, th21, th22)]  # later = LEFT
        b_ = [x[:, 0::2] for x in (th11, th12, th21, th22)]
        # c11 = A11*B11 + A12*B21, c12 = A11*B12 + A12*B22,
        # c21 = A21*B11 + A22*B21, c22 = A21*B12 + A22*B22
        sig = jnp.stack([b_[0], b_[2], b_[1], b_[3],
                         b_[0], b_[2], b_[1], b_[3]])
        ker = jnp.stack([a_[0], a_[1], a_[0], a_[1],
                         a_[2], a_[3], a_[2], a_[3]])
        c = 8 * bsz * (p // 2)
        out = jax.lax.conv_general_dilated(
            sig.reshape(1, c, ln), ker.reshape(c, 1, ln)[:, :, ::-1],
            window_strides=(1,), padding=[(ln - 1, ln - 1)],
            dimension_numbers=("NCW", "OIW", "NCW"),
            feature_group_count=c,
            precision=jax.lax.Precision.HIGHEST,
        )[0].reshape(8, bsz, p // 2, 2 * ln - 1)
        th11, th12, th21, th22 = (
            out[0] + out[1], out[2] + out[3],
            out[4] + out[5], out[6] + out[7],
        )
        p //= 2
    return tuple(x[:, 0].astype(dt) for x in (th11, th12, th21, th22))


def _rp(x):
    """Defensive barrier for error-free transformations: round ``x`` to
    its own storage format via ``lax.reduce_precision`` — numerically the
    identity for an fp32/fp64 value, and a fence against any compiler
    rewrite of TwoSum's ``(a + b) - a`` style residuals.  The residuals
    have been seen to survive jit even without the fence; it is kept
    because it is ~free and pins the required semantics against future
    XLA passes."""
    if x.dtype == jnp.float64:
        return jax.lax.reduce_precision(x, 11, 52)
    return jax.lax.reduce_precision(x, 8, 23)


def _ds_add(ah, al, bh, bl):
    """Two-float (double-single) sum: Knuth TwoSum on the hi parts, lo
    parts folded into the error, one renormalization.  ~2^-48 relative
    per op at fp32 — the extended-precision accumulator the compensated
    theta tree runs on.  Every rounding-sensitive intermediate passes
    through the :func:`_rp` barrier (see there)."""
    s = _rp(ah + bh)
    v = _rp(s - ah)
    e = _rp(_rp(ah - _rp(s - v)) + _rp(bh - v))
    lo = _rp(e + al + bl)
    hi = _rp(s + lo)
    return hi, _rp(lo - _rp(hi - s))


_SPLIT32 = 4097.0          # 2^12 + 1 (Dekker split for fp32)
_SPLIT64 = 134217729.0     # 2^27 + 1 (fp64)


def _two_prod(a, b):
    """Exact product ``a*b = p + err`` via Dekker splitting (no FMA
    assumed; if XLA fuses the residual into an FMA the result is the
    same error term, computed faster).  :func:`_rp` barriers keep the
    split and the residual out of the simplifier's reach."""
    p = _rp(a * b)
    split = jnp.asarray(
        _SPLIT32 if a.dtype == jnp.float32 else _SPLIT64, a.dtype
    )
    sa = _rp(split * a)
    ah = _rp(sa - _rp(sa - a))
    al = _rp(a - ah)
    sb = _rp(split * b)
    bh = _rp(sb - _rp(sb - b))
    bl = _rp(b - bh)
    err = _rp(_rp(_rp(ah * bh - p) + ah * bl + al * bh) + al * bl)
    return p, err


def _ds_mul(ah, al, bh, bl):
    """Two-float product (drops the lo*lo term, below 2^-48)."""
    p, e = _two_prod(ah, bh)
    e = _rp(e + _rp(ah * bl + al * bh))
    hi = _rp(p + e)
    return hi, _rp(e - _rp(hi - p))


def _gconv_causal_comp2(xa, ka, xb, kb):
    """Compensated ``xa (*) ka + xb (*) kb`` (causal per-channel conv,
    ``x [C, T]``, ``k [C, W]`` -> ``[C, T]``): per-tap TwoProd products
    accumulated by Neumaier summation — true fp32-exact products with
    ~2^-48 accumulation, immune to reduced-precision passes in a
    hardware convolution and to fp32 partial-sum rounding, and covering
    cancellation BETWEEN the two convolutions (s' = Th11*s + Th12*t can
    cancel).

    Why it exists: the blocked Durbin amplifies tail-conv noise through
    log1p(1 - alpha^2) by 1/(1 - alpha^2) in near-singular regimes, so
    the rounding of a plain fp32 convolution sets the logdet's error
    floor there.  Cost: ~25 elementwise ops per tap, unrolled over the
    taps (its throughput and compile time on the GPU are open — ROADMAP
    A.5)."""
    t = xa.shape[-1]
    w = ka.shape[-1]
    pad = ((0, 0), (w - 1, 0))
    xap = jnp.pad(xa, pad)
    xbp = jnp.pad(xb, pad)
    s = jnp.zeros_like(xa)
    c = jnp.zeros_like(xa)

    def acc(s, c, p, e):
        tt = _rp(s + p)
        big = jnp.abs(s) >= jnp.abs(p)
        r = jnp.where(big, _rp(_rp(s - tt) + p), _rp(_rp(p - tt) + s))
        return tt, _rp(c + _rp(r + e))

    for d in range(w):
        sl = jax.lax.slice_in_dim(xap, w - 1 - d, w - 1 - d + t, axis=1)
        p, e = _two_prod(ka[:, d : d + 1], sl)
        s, c = acc(s, c, p, e)
        sl = jax.lax.slice_in_dim(xbp, w - 1 - d, w - 1 - d + t, axis=1)
        p, e = _two_prod(kb[:, d : d + 1], sl)
        s, c = acc(s, c, p, e)
    return _rp(s + c)


def _skew(p):
    """``p [.., La, Lb] -> q [.., La, La+Lb-1]`` with
    ``q[i, i:i+Lb] = p[i]`` (row i shifted right by i) — the classic
    pad-flatten-slice skew: row i of the width-(Lout+1) padded matrix
    starts at flat index ``i*(Lout+1) = i*Lout + i``, exactly where the
    shifted row must land in the flat view of ``q``.  Pure layout ops,
    no gather."""
    la, lb = p.shape[-2], p.shape[-1]
    lout = la + lb - 1
    pad = [(0, 0)] * (p.ndim - 1) + [(0, la)]
    q = jnp.pad(p, pad)                             # [.., La, Lout+1]
    q = q.reshape(p.shape[:-2] + (la * (lout + 1),))
    return q[..., : la * lout].reshape(p.shape[:-2] + (la, lout))


def _ds_poly_mul(ah, al, bh, bl):
    """Polynomial product with two-float coefficients:
    ``a [..., La] (*) b [..., Lb] -> c [..., La+Lb-1]``.

    Pairwise coefficient products are exact (TwoProd); the anti-diagonal
    accumulation — where the fp32 cancellation that corrupts the Szego
    transfer matrices lives — runs as a log-depth pairwise two-float
    reduction over skewed rows.  All elementwise / layout work on
    tiny [8, B, pairs, L, L'] tensors (<= ~70k entries per buffer at
    nb=128), nothing near the tail convolutions' cost."""
    la = ah.shape[-1]
    ph, pl = _ds_mul(ah[..., :, None], al[..., :, None],
                     bh[..., None, :], bl[..., None, :])   # [.., La, Lb]
    qh = _skew(ph)
    ql = _skew(pl)
    n = 1
    while n < la:
        n *= 2
    if n != la:
        pad = [(0, 0)] * (qh.ndim - 2) + [(0, n - la), (0, 0)]
        qh = jnp.pad(qh, pad)
        ql = jnp.pad(ql, pad)
    while n > 1:
        h = n // 2
        qh, ql = _ds_add(qh[..., :h, :], ql[..., :h, :],
                         qh[..., h:, :], ql[..., h:, :])
        n = h
    return qh[..., 0, :], ql[..., 0, :]


def _theta_tree_comp(alphas: jnp.ndarray) -> tuple[jnp.ndarray, ...]:
    """Compensated :func:`_theta_tree`: identical pairwise product order,
    coefficients carried in two-float through every level, hi parts
    returned (rounding the *result* to fp32 is harmless — measured
    7.4e-6 logdet rel err with exact theta vs 3.3e-4 all-fp32 at the
    T=4096 near-singular regime, benchmarks/prof_durbin_comp.py)."""
    bsz, nb = alphas.shape
    dt = alphas.dtype
    zeros = jnp.zeros_like(alphas)
    ones = jnp.ones_like(alphas)
    # leaves [B, nb, 2]: [th11, th12, th21, th22]
    hi = [
        jnp.stack([ones, zeros], -1),
        jnp.stack([zeros, alphas], -1),
        jnp.stack([alphas, zeros], -1),
        jnp.stack([zeros, ones], -1),
    ]
    lo = [jnp.zeros_like(x) for x in hi]
    p = nb
    while p > 1:
        a_h = [x[:, 1::2] for x in hi]  # later factor = LEFT
        a_l = [x[:, 1::2] for x in lo]
        b_h = [x[:, 0::2] for x in hi]
        b_l = [x[:, 0::2] for x in lo]
        # c11 = A11 B11 + A12 B21, c12 = A11 B12 + A12 B22,
        # c21 = A21 B11 + A22 B21, c22 = A21 B12 + A22 B22
        ka = jnp.stack([a_h[0], a_h[1], a_h[0], a_h[1],
                        a_h[2], a_h[3], a_h[2], a_h[3]])
        kal = jnp.stack([a_l[0], a_l[1], a_l[0], a_l[1],
                         a_l[2], a_l[3], a_l[2], a_l[3]])
        kb = jnp.stack([b_h[0], b_h[2], b_h[1], b_h[3],
                        b_h[0], b_h[2], b_h[1], b_h[3]])
        kbl = jnp.stack([b_l[0], b_l[2], b_l[1], b_l[3],
                         b_l[0], b_l[2], b_l[1], b_l[3]])
        ch, cl = _ds_poly_mul(ka, kal, kb, kbl)  # [8, B, p/2, 2ln-1]
        hi, lo = [], []
        for k in range(4):
            h, l = _ds_add(ch[2 * k], cl[2 * k],
                           ch[2 * k + 1], cl[2 * k + 1])
            hi.append(h)
            lo.append(l)
        p //= 2
    return tuple(x[:, 0].astype(dt) for x in hi)


def _durbin_schur_blocked(rho: jnp.ndarray, nb: int, comp: bool = False):
    """Blocked Schur/Durbin recursion (VERDICT r3 #9): sequential depth
    T/nb outer steps instead of T.

    Same quantities as :func:`_durbin_scan` — reflection coefficients,
    prediction-error variances, and the Yule-Walker solution — computed
    through the Szego-polynomial pair

        a^(k) = a^(k-1) + alpha_k Z b^(k-1)
        b^(k) = Z b^(k-1) + alpha_k a^(k-1)          (Z = down-shift)

    and its rho-correlation images ``s = rho (*) a``, ``t = rho (*) b``
    which satisfy the *same* linear recursion.  ``alpha_k`` reads only
    ``s_k`` and ``t_{k-1}``, so a block of ``nb`` steps needs just
    length-``nb`` windows of (s, t): the unrolled inner recursion updates
    only those windows and extracts the alphas (the minimal serial
    chain); the block's 2x2 polynomial transfer matrix Theta(Z) = prod_k
    [[1, alpha_k Z], [alpha_k, Z]] (degree <= nb) is then built OFF the
    chain by :func:`_theta_tree`, and the full (s, t) and (a, b) tails
    advance by two grouped direct causal convolutions with Theta per
    block — convolution work instead of a length-T scan.  (Direct, not FFT: the
    FFT's rounding is relative to the whole-vector norm and swamps the
    small trailing Szego-polynomial entries at fp32 — measured 2-10x
    worse GS-identity error at T=4096.)  Exact same algebra as the scan
    (verified to fp64 in tests); only the summation order of the tail
    updates differs.

    Prediction-error variances accumulate in log space
    (sum log1p(-alpha^2)), so near-singular banks degrade gracefully
    instead of underflowing E to zero.

    Args: ``rho [B, t1]`` normalized autocovariances (t1 = T-1 steps).
    Returns ``(sum_log_e [B], y [B, t1], e [B])`` with e the final
    normalized prediction-error variance.
    """
    bsz, t1 = rho.shape
    t = t1 + 1
    assert nb > 0 and nb & (nb - 1) == 0, (
        f"blocked Durbin needs a power-of-two block (theta tree), got {nb}"
    )
    nblocks = -(-t1 // nb)
    dt = rho.dtype

    rho_full = jnp.concatenate([jnp.ones((bsz, 1), dt), rho], -1)  # [B, T]
    s0 = rho_full
    t0 = rho_full
    a0 = jnp.zeros((bsz, t), dt).at[:, 0].set(1.0)
    b0 = a0
    iota = jnp.arange(nb)

    def block(carry, k0):
        s, t_, a, b_, log_e, acc = carry
        # windows: sh[i] = s[k0+1+i], th[i] = t[k0+i]  (i = 0..nb-1)
        pad = jnp.zeros((bsz, nb + 1), dt)
        sp = jnp.concatenate([s, pad], -1)
        tp = jnp.concatenate([t_, pad], -1)
        sh = jax.lax.dynamic_slice_in_dim(sp, k0 + 1, nb, axis=1)
        th = jax.lax.dynamic_slice_in_dim(tp, k0, nb, axis=1)

        alphas = []
        for i in range(nb):
            valid = k0 + 1 + i <= t1
            den = jnp.where(valid, th[:, i], jnp.ones((), dt))
            alpha = jnp.where(
                valid, _clamp_alpha(-sh[:, i] / den), jnp.zeros((), dt)
            )
            alphas.append(alpha)
            al = alpha[:, None]
            # th' uses the OLD sh (order matters)
            th_new = _shift1(th + al * sh)
            sh = sh + al * th
            th = th_new
        al_blk = jnp.stack(alphas, axis=1)                   # [B, nb]

        # log prediction-error accumulation, off the serial chain
        valid_v = (k0 + 1 + iota <= t1).astype(dt)           # [nb]
        le = jnp.log1p(-al_blk * al_blk) * valid_v           # [B, nb]
        cum = jnp.cumsum(le, axis=-1)
        acc = acc + jnp.sum((log_e[:, None] + cum) * valid_v, axis=-1)
        log_e = log_e + cum[:, -1]

        th11, th12, th21, th22 = (
            _theta_tree_comp(al_blk) if comp else _theta_tree(al_blk)
        )
        left = jnp.stack([s, s, a, a]).reshape(4 * bsz, t)
        right = jnp.stack([t_, t_, b_, b_]).reshape(4 * bsz, t)
        kl_ = jnp.stack([th11, th21, th11, th21]).reshape(4 * bsz, nb + 1)
        kr_ = jnp.stack([th12, th22, th12, th22]).reshape(4 * bsz, nb + 1)
        if comp:
            out = _gconv_causal_comp2(left, kl_, right, kr_).reshape(
                4, bsz, t
            )
        else:
            out = (_gconv_causal(left, kl_) + _gconv_causal(right, kr_)
                   ).reshape(4, bsz, t)
        return (out[0], out[1], out[2], out[3], log_e, acc), None

    z0 = jnp.zeros((bsz,), dt)
    k0s = jnp.arange(nblocks, dtype=jnp.int32) * nb
    (s, t_, a, b_, log_e, acc), _ = jax.lax.scan(
        block, (s0, t0, a0, b0, z0, z0), k0s
    )
    return acc, a[:, 1:], jnp.exp(log_e)


def _durbin_flat(
    flat_rho: jnp.ndarray, block: int, min_t: int, comp: bool = False
):
    """Dispatch: blocked Schur for long sequences, classical scan below
    the crossover.  ``flat_rho [B, t1]`` -> (sum_log_e, y, e), each
    batched.  Both paths compute identical quantities (same recursion,
    different schedule)."""
    t1 = flat_rho.shape[-1]
    if block > 0 and t1 + 1 >= min_t:
        return _durbin_schur_blocked(flat_rho, block, comp)

    def one(r):
        log_e, y, _rev, e = _durbin_scan(r)
        return jnp.sum(log_e), y, e

    return jax.vmap(one)(flat_rho)


@functools.partial(jax.jit, static_argnames=("block", "min_t", "comp"))
def _durbin_logdet_impl(row, block: int, min_t: int, comp: bool):
    row = jnp.asarray(row)
    batch = row.shape[:-1]
    t = row.shape[-1]
    flat = row.reshape((-1, t))
    r0 = flat[:, 0]
    sum_log_e, _, _ = _durbin_flat(
        flat[:, 1:] / r0[:, None], block, min_t, comp
    )
    return (t * jnp.log(r0) + sum_log_e).reshape(batch)


def durbin_logdet(row: jnp.ndarray) -> jnp.ndarray:
    """logdet of the symmetric PD Toeplitz matrix with first row ``row``
    (``[..., T]`` -> ``[...]``), O(T^2) instead of O(T^3).

    det T_n = prod_{k=0}^{n-1} E_k with E_0 = r_0 and the Durbin
    prediction-error recursion E_k = E_{k-1} (1 - alpha_k^2).
    """
    block, min_t, comp = _durbin_block_config()
    return _durbin_logdet_impl(row, block=block, min_t=min_t, comp=comp)


def tri_toeplitz(col: jnp.ndarray) -> jnp.ndarray:
    """Dense lower-triangular Toeplitz ``[..., T, T]`` from its first column
    ``[..., T]`` (materialized once; multiplication is then a matmul)."""
    t = col.shape[-1]
    i = jnp.arange(t)[:, None]
    j = jnp.arange(t)[None, :]
    idx = jnp.clip(i - j, 0, t - 1)
    return jnp.where(i >= j, col[..., idx], jnp.zeros((), col.dtype))


@functools.partial(jax.jit, static_argnames=("block", "min_t", "comp"))
def _durbin_gs_factors_impl(row, block: int, min_t: int, comp: bool):
    row = jnp.asarray(row)
    batch = row.shape[:-1]
    t = row.shape[-1]
    flat = row.reshape((-1, t))
    r0 = flat[:, 0]
    sum_log_e, y, e = _durbin_flat(
        flat[:, 1:] / r0[:, None], block, min_t, comp
    )
    logdet = t * jnp.log(r0) + sum_log_e
    ones = jnp.ones((flat.shape[0], 1), flat.dtype)
    zeros = jnp.zeros((flat.shape[0], 1), flat.dtype)
    a = jnp.concatenate([ones, y], axis=1)
    b = jnp.concatenate([zeros, y[:, ::-1]], axis=1)   # (0, rev_y)
    return (
        logdet.reshape(batch),
        a.reshape(batch + (t,)),
        b.reshape(batch + (t,)),
        (r0 * e).reshape(batch),
    )


def durbin_gs_factors(
    row: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Log-determinant + Gohberg-Semencul inverse representation of the
    symmetric PD Toeplitz matrix with first row ``row [..., T]``.

    Returns ``(logdet, a, b, e)`` with

        K^{-1} = (1/e) (A A^T - B B^T)

    where ``A``/``B`` are the lower-triangular Toeplitz matrices with first
    columns ``a = (1, y_1..y_{T-1})`` and ``b = (0, y_{T-1}..y_1)`` built
    from the final Durbin (Yule-Walker) solution ``y``, and ``e`` is the
    final unnormalized prediction-error variance.  One O(T^2) scan yields
    the logdet AND an O(T^2)-to-build exact inverse whose application is
    matrix products — this is what replaces the O(T^3) sequential prior
    Cholesky for uniform grids (BASELINE.json config 3; all reference MNIST
    grids are uniform, src/Models/Full_GP_VAE_fixed_for_MovMnist.py:280).
    """
    block, min_t, comp = _durbin_block_config()
    return _durbin_gs_factors_impl(row, block=block, min_t=min_t, comp=comp)


def _fft_len(t: int) -> int:
    """Power-of-two FFT length >= 2T-1 (radix-2 keeps the FFT on its fast path)."""
    m = 1
    while m < 2 * t - 1:
        m *= 2
    return m


def tri_toeplitz_matvec_t(
    col: jnp.ndarray, y: jnp.ndarray
) -> jnp.ndarray:
    """``A^T @ y`` for lower-triangular Toeplitz ``A`` (first column
    ``col [Z, T]``) applied to ``y [..., Z, T, C]`` along the T axis,
    in O(T log T) per column via FFT correlation — no ``[Z, T, T]`` matrix.

    ``(A^T y)[i] = sum_{j >= i} col[j - i] * y[j]`` is an anticausal
    correlation: with both operands zero-padded to M >= 2T-1,
    ``irfft(conj(rfft(col)) * rfft(y))[..., :T]`` gives exactly the
    non-negative lags.  This is what makes the Gohberg-Semencul inverse
    *application* O(T^2 log T) for the whole trace term instead of dense
    O(T^3) matmuls (the round-2 structured path materialized ``A``/``B``
    densely and lost to the dense prior at its own design point).
    """
    t = col.shape[-1]
    m = _fft_len(t)
    fc = jnp.conj(jnp.fft.rfft(col, n=m, axis=-1))      # [Z, M/2+1]
    fy = jnp.fft.rfft(y, n=m, axis=-2)                  # [..., Z, M/2+1, C]
    prod = fc[..., :, None] * fy
    out = jnp.fft.irfft(prod, n=m, axis=-2)[..., :t, :]
    return out.astype(y.dtype)


def tri_toeplitz_matvec(
    col: jnp.ndarray, y: jnp.ndarray
) -> jnp.ndarray:
    """``A @ y`` (causal convolution) for lower-triangular Toeplitz ``A``
    with first column ``col [Z, T]``; ``y [..., Z, T, C]``."""
    t = col.shape[-1]
    m = _fft_len(t)
    fc = jnp.fft.rfft(col, n=m, axis=-1)
    fy = jnp.fft.rfft(y, n=m, axis=-2)
    prod = fc[..., :, None] * fy
    out = jnp.fft.irfft(prod, n=m, axis=-2)[..., :t, :]
    return out.astype(y.dtype)


@functools.partial(jax.jit, static_argnames=("num_samples",))
def circulant_prior_sample(
    key: jax.Array,
    row: jnp.ndarray,
    num_samples: int = 1,
) -> jnp.ndarray:
    """Exact stationary GP draws on a uniform grid in O(T log T).

    Embeds the Toeplitz gram (first row ``row [Z, T]``) in a circulant of
    size 2(T-1), takes the FFT eigenvalues, and filters white noise — the
    classic circulant-embedding sampler, replacing ``chol(K) @ eps``
    (reference ``prior_gp_sample``,
    src/Models/FullGP_and_GPdecoder_dynamic_time_analysis.py:24-30) for long
    sequences.  Returns ``[S, Z, T]``.

    Negative embedding eigenvalues (possible for very smooth kernels at
    short T) are clamped to zero — the draw is then from the nearest valid
    spectrum.
    """
    z, t = row.shape
    m = 2 * (t - 1)
    # circulant first row: [r0, r1, ..., r_{T-1}, r_{T-2}, ..., r1]
    circ = jnp.concatenate([row, row[:, -2:0:-1]], axis=-1)  # [Z, M]
    lam = jnp.fft.rfft(circ, axis=-1).real  # [Z, M/2+1]
    lam = jnp.maximum(lam, 0.0)
    shape = (num_samples, z, m)
    eps = jax.random.normal(key, shape)
    spec = jnp.fft.rfft(eps, axis=-1)
    filtered = spec * jnp.sqrt(lam / m)[None]
    draw = jnp.fft.irfft(filtered, n=m, axis=-1) * jnp.sqrt(
        jnp.asarray(m, row.dtype)
    )
    return draw[..., :t]
