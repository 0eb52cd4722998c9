"""Independent NumPy oracle for DCA math, used to validate the JAX kernels.

These are straightforward (loop/broadcast) NumPy implementations of the
documented algorithms — written from the mathematical spec in SURVEY.md, kept
deliberately different in structure from the JAX code so that agreement is
meaningful.  All in float64.

Conventions: 0-based states, gap = q-1, pair order (0,1), (0,2), ..., (L-2,L-1).
"""

import numpy as np


def spearman(a, b):
    """Spearman rank correlation of two score vectors (ties broken by order)."""
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra**2).sum() * (rb**2).sum()))


def top_overlap(a, b, k):
    """Share of the top-k entries of ``a`` that are also top-k in ``b``."""
    return len(set(np.argsort(-a)[:k]) & set(np.argsort(-b)[:k])) / k


def seq_weights(msa, seqid):
    """O(N^2 L) all-pairs identity weighting (blocked for memory)."""
    n, l = msa.shape
    counts = np.zeros(n, dtype=np.int64)
    block = 512
    for s in range(0, n, block):
        chunk = msa[s : s + block]  # (b, L)
        iid = (chunk[:, None, :] == msa[None, :, :]).sum(axis=2)  # (b, N)
        counts[s : s + block] = (iid.astype(np.float64) / l > seqid).sum(axis=1)
    return 1.0 / counts.astype(np.float64)


def single_site_freqs(msa, w, q):
    n, l = msa.shape
    meff = w.sum()
    fi = np.zeros((l, q))
    for a in range(q):
        fi[:, a] = ((msa == a) * w[:, None]).sum(axis=0)
    return fi / meff


def pair_site_freqs(msa, w, q, include_gap=False):
    n, l = msa.shape
    meff = w.sum()
    qe = q if include_gap else q - 1
    pairs = []
    for i in range(l - 1):
        for j in range(i + 1, l):
            fij = np.zeros((qe, qe))
            for a in range(qe):
                mask_a = (msa[:, i] == a) * w
                for b in range(qe):
                    fij[a, b] = (mask_a * (msa[:, j] == b)).sum()
            pairs.append(fij / meff)
    return np.stack(pairs)


def reg_fi(fi, q, theta):
    return theta / q + (1 - theta) * fi


def reg_fij(fij, q, theta):
    return theta / (q * q) + (1 - theta) * fij


def corr_mat(fi_r, fij_r, l, q):
    qm1 = q - 1
    c = np.zeros((l * qm1, l * qm1))
    pc = 0
    for i in range(l):
        for j in range(i, l):
            for a in range(qm1):
                for b in range(qm1):
                    if i == j:
                        v = fi_r[i, a] * (1 - fi_r[i, a]) if a == b else -fi_r[i, a] * fi_r[i, b]
                    else:
                        v = fij_r[pc, a, b] - fi_r[i, a] * fi_r[j, b]
                    c[i * qm1 + a, j * qm1 + b] = v
                    c[j * qm1 + b, i * qm1 + a] = v
            if i != j:
                pc += 1
    return c


def couplings(c):
    return -np.linalg.inv(c)


def fn_scores(coup, l, q):
    """Gauge-shifted Frobenius norms, (P,)."""
    qm1 = q - 1
    out = []
    for i in range(l - 1):
        for j in range(i + 1, l):
            cij = coup[i * qm1 : (i + 1) * qm1, j * qm1 : (j + 1) * qm1]
            shifted = (
                cij
                - cij.mean(axis=0, keepdims=True)
                - cij.mean(axis=1, keepdims=True)
                + cij.mean()
            )
            out.append(np.sqrt((shifted**2).sum()))
    return np.array(out)


def apc(scores, l):
    iu, ju = np.triu_indices(l, k=1)
    av = np.zeros(l)
    for i in range(l):
        mask = (iu == i) | (ju == i)
        av[i] = scores[mask].sum() / (l - 1)
    av_all = av.mean()
    return scores - av[iu] * av[ju] / av_all


def two_site_fields_and_di(coup_blocks, fi_r, l, q, tol=1e-4, eps=1e-20):
    """Per-pair two-site fixed point + direct information, serial."""
    iu, ju = np.triu_indices(l, k=1)
    dis = np.zeros(len(iu))
    for p, (i, j) in enumerate(zip(iu, ju)):
        w = np.zeros((q, q))
        w[: q - 1, : q - 1] = coup_blocks[p]
        w = np.exp(w)
        fi = fi_r[i].reshape(q, 1)
        fj = fi_r[j].reshape(q, 1)
        hi = np.full((q, 1), 1.0 / q)
        hj = np.full((q, 1), 1.0 / q)
        change = 10.0
        while change > tol:
            xi = w @ hj
            xj = w.T @ hi
            hi_new = fi / xi
            hi_new /= hi_new.sum()
            hj_new = fj / xj
            hj_new /= hj_new.sum()
            change = max(np.abs(hi_new - hi).max(), np.abs(hj_new - hj).max())
            hi, hj = hi_new, hj_new
        pdir = w * (hi @ hj.T)
        pdir /= pdir.sum()
        fprod = fi @ fj.T
        pr = pdir[: q - 1, : q - 1] + eps
        fr = fprod[: q - 1, : q - 1] + eps
        dis[p] = (pr * np.log(pr / fr)).sum()
    return dis


def plm_loss_and_grad(theta, msa, w, lam_h, lam_J, q, term_scale=False):
    """Regularized negative pseudolikelihood (symmetric-J variant) + gradient.

    Parameter layout matches the reference flat vector
    (``plmdca_numerics.cpp:319-343``): fields (L*q, site-major) then couplings
    ((P, q, q) pair-major, a-major).  NOTE: unlike the reference C++ this does
    NOT carry the prob accumulator across sequences (plmdca_numerics.cpp:492-499
    never resets prob_ni between n iterations — a reference quirk).

    With ``term_scale`` also returns the gradient of the absolute terms,
    ``|dlogits|^T X + 2 lam |theta|``: the scale that rounding errors of a
    float32 or TF32 evaluation are proportional to.
    """
    n, l = msa.shape
    p = l * (l - 1) // 2
    h = theta[: l * q].reshape(l, q)
    J = theta[l * q :].reshape(p, q, q)
    pair_of = {}
    c = 0
    for i in range(l - 1):
        for j in range(i + 1, l):
            pair_of[(i, j)] = c
            c += 1
    # full symmetric coupling tensor
    Jfull = np.zeros((l, l, q, q))
    for (i, j), k in pair_of.items():
        Jfull[i, j] = J[k]
        Jfull[j, i] = J[k].T
    X = np.eye(q)[msa]  # (N, L, q)
    logits = h[None] + np.einsum("ijab,njb->nia", Jfull, X, optimize=True)
    m = logits.max(axis=2, keepdims=True)
    z = np.exp(logits - m)
    probs = z / z.sum(axis=2, keepdims=True)
    logp = logits - m - np.log(z.sum(axis=2, keepdims=True))
    picked = np.take_along_axis(logp, msa[:, :, None].astype(np.int64), axis=2)[:, :, 0]
    fx = -(w[:, None] * picked).sum() + lam_h * (h**2).sum() + lam_J * (J**2).sum()

    dlogits = w[:, None, None] * (probs - X)  # (N, L, q)
    gh = dlogits.sum(axis=0) + 2 * lam_h * h
    gJ = 2 * lam_J * J
    # dL/dJfull[i,j,a,b] = sum_n dlogits[n,i,a] X[n,j,b]; symmetric accumulation
    def pair_grad(dl, reg):
        gfull = np.einsum("nia,njb->ijab", dl, X, optimize=True)
        out = reg.copy()
        for (i, j), k in pair_of.items():
            out[k] += gfull[i, j] + gfull[j, i].T
        return out

    g = np.concatenate([gh.ravel(), pair_grad(dlogits, gJ).ravel()])
    if not term_scale:
        return fx, g
    ah = np.abs(dlogits).sum(axis=0) + 2 * lam_h * np.abs(h)
    aJ = pair_grad(np.abs(dlogits), 2 * lam_J * np.abs(J))
    return fx, g, np.concatenate([ah.ravel(), aJ.ravel()])
