"""Error attribution + compensated-option A/B for the blocked Durbin
recursion at T=4096 (VERDICT r4 weak #5 / next #7).

Round-4 measured 5.2e-4 fp32 logdet rel err vs the fp64 dense oracle at
T=4096 in the near-singular ls=64 regime — 5x the 1e-4 parity discipline
the repo holds everywhere else.  Before compensating anything, this
script attributes the error: it re-runs the blocked Schur/Durbin
recursion with each stage selectively upcast to fp64 (window recursion /
theta tree / tail convolutions), on CPU where fp64 is native, against a
full-fp64 run of the same schedule.  The dominant stage is the one worth
a two-float (double-single) fp32 implementation.

Runs on the CPU (fp64 is native there; x64 is enabled here directly).
"""
from __future__ import annotations

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

# the attribution needs native fp64: pin the CPU backend before any
# backend initializes
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from gpvae_tpu import toeplitz as tz


def _blocked_hybrid(rho, nb, *, window_dt, theta_dt, tail_dt,
                    theta_mode="plain"):
    """toeplitz._durbin_schur_blocked with per-stage dtype knobs.

    Identical schedule to the production path; the only difference is the
    dtype each stage computes in (casts at stage boundaries round back to
    the carry dtype fp32 unless the stage keeps fp64 state alive).
    ``theta_mode="comp"`` routes the tree through the production two-float
    :func:`toeplitz._theta_tree_comp` instead of the dtype-cast plain tree.
    Returns sum_log_e [B] in fp64.
    """
    bsz, t1 = rho.shape
    t = t1 + 1
    nblocks = -(-t1 // nb)
    carry_dt = jnp.float32

    rho32 = rho.astype(carry_dt)
    rho_full = jnp.concatenate(
        [jnp.ones((bsz, 1), carry_dt), rho32], -1
    )
    s0 = rho_full
    t0 = rho_full
    a0 = jnp.zeros((bsz, t), carry_dt).at[:, 0].set(1.0)
    b0 = a0
    iota = jnp.arange(nb)

    def block(carry, k0):
        s, t_, a, b_, log_e, acc = carry
        pad = jnp.zeros((bsz, nb + 1), carry_dt)
        sp = jnp.concatenate([s, pad], -1)
        tp = jnp.concatenate([t_, pad], -1)
        sh = jax.lax.dynamic_slice_in_dim(sp, k0 + 1, nb, axis=1)
        th = jax.lax.dynamic_slice_in_dim(tp, k0, nb, axis=1)

        # --- window recursion (stage 1) ---
        sh = sh.astype(window_dt)
        th = th.astype(window_dt)
        alphas = []
        for i in range(nb):
            valid = k0 + 1 + i <= t1
            den = jnp.where(valid, th[:, i], jnp.ones((), window_dt))
            alpha = jnp.where(
                valid,
                tz._clamp_alpha(-sh[:, i] / den),
                jnp.zeros((), window_dt),
            )
            alphas.append(alpha)
            al = alpha[:, None]
            th_new = tz._shift1(th + al * sh)
            sh = sh + al * th
            th = th_new
        al_blk = jnp.stack(alphas, axis=1)

        # log E accumulation always fp64 (off-chain, cheap, not under test)
        al64 = al_blk.astype(jnp.float64)
        valid_v = (k0 + 1 + iota <= t1).astype(jnp.float64)
        le = jnp.log1p(-al64 * al64) * valid_v
        cum = jnp.cumsum(le, axis=-1)
        acc = acc + jnp.sum((log_e[:, None] + cum) * valid_v, axis=-1)
        log_e = log_e + cum[:, -1]

        # --- theta tree (stage 2) ---
        if theta_mode == "comp":
            th11, th12, th21, th22 = tz._theta_tree_comp(
                al_blk.astype(theta_dt)
            )
        else:
            th11, th12, th21, th22 = tz._theta_tree(al_blk.astype(theta_dt))

        # --- tail convolutions (stage 3) ---
        left = jnp.stack([s, s, a, a]).reshape(4 * bsz, t).astype(tail_dt)
        right = jnp.stack([t_, t_, b_, b_]).reshape(4 * bsz, t).astype(tail_dt)
        kl_ = (
            jnp.stack([th11, th21, th11, th21])
            .reshape(4 * bsz, nb + 1)
            .astype(tail_dt)
        )
        kr_ = (
            jnp.stack([th12, th22, th12, th22])
            .reshape(4 * bsz, nb + 1)
            .astype(tail_dt)
        )
        out = (
            tz._gconv_causal(left, kl_) + tz._gconv_causal(right, kr_)
        ).reshape(4, bsz, t)
        out = out.astype(carry_dt)
        return (out[0], out[1], out[2], out[3], log_e, acc), None

    z64 = jnp.zeros((bsz,), jnp.float64)
    k0s = jnp.arange(nblocks, dtype=jnp.int32) * nb
    (s, t_, a, b_, log_e, acc), _ = jax.lax.scan(
        block, (s0, t0, a0, b0, z64, z64), k0s
    )
    return acc


def main():
    t = 4096
    nb = 128
    noise = 1e-3
    # the round-4 regime that measured 5.2e-4 (benchmarks/prof_durbin.py):
    # the t4096 preset grid — spacing 60/T, ls=9 (~614 grid steps, the
    # near-singular case) and ls=3 (~205 steps), noise 1e-3
    ls = 9.0
    dt_grid = 60.0 / t
    lag = np.arange(t, dtype=np.float64) * dt_grid
    row = (1.0 - noise) * np.exp(-(lag**2) / (2 * ls**2))
    row[0] += noise
    rho = jnp.asarray(
        (row[1:] / row[0]).astype(np.float32)
    ).astype(jnp.float32)[None, :]  # [1, T-1]
    r0 = row[0]

    # fp64 oracle: dense slogdet
    k = np.asarray(
        (1.0 - noise) * np.exp(
            -((lag[:, None] - lag[None, :]) ** 2) / (2 * ls**2)
        )
        + noise * np.eye(t)
    )
    _, want = np.linalg.slogdet(k)

    f32, f64 = jnp.float32, jnp.float64
    cases = {
        "all fp32 (production)": (f32, f32, f32, "plain"),
        "window fp64": (f64, f32, f32, "plain"),
        "theta fp64": (f32, f64, f32, "plain"),
        "theta comp (production)": (f32, f32, f32, "comp"),
        "tail fp64": (f32, f32, f64, "plain"),
        "window+theta fp64": (f64, f64, f32, "plain"),
        "window+tail fp64": (f64, f32, f64, "plain"),
        "theta+tail fp64": (f32, f64, f64, "plain"),
        "theta comp + tail fp64": (f32, f32, f64, "comp"),
        "all fp64": (f64, f64, f64, "plain"),
    }
    print(f"T={t} nb={nb} ls={ls} noise={noise}  oracle logdet={want:.9e}")

    # Input-quantization floor: pure-fp64 Durbin (the production scan) on
    # the fp32-ROUNDED rho vs the unrounded fp64 rho.  No compensated
    # arithmetic can beat the fp32-rounded-input line; if it is already at
    # the 5.2e-4 band, the fix is computing rho itself more accurately,
    # not compensating the recursion.
    rho64 = jnp.asarray(row[1:] / row[0])[None, :]
    for tag, rh in (("fp64 scan, fp64 rho", rho64),
                    ("fp64 scan, fp32-rounded rho",
                     rho64.astype(jnp.float32).astype(jnp.float64))):
        sle, _y, _e = tz._durbin_flat(rh, 0, 10**9)
        got = t * np.log(r0) + float(sle[0])
        rel = abs(got - want) / abs(want)
        print(f"  {tag:28s} logdet={got:.9e}  rel={rel:.2e}")
    for name, (wd, thd, tld, tm) in cases.items():
        sum_log_e = _blocked_hybrid(rho, nb, window_dt=wd, theta_dt=thd,
                                    tail_dt=tld, theta_mode=tm)
        got = t * np.log(r0) + float(sum_log_e[0])
        rel = abs(got - want) / abs(want)
        print(f"  {name:24s} logdet={got:.9e}  rel={rel:.2e}")


if __name__ == "__main__":
    main()
