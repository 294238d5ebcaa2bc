"""GrabCut-equivalent mask refinement on the device (no cv2).

Port of `leaffliction_tpu/segment/grabcut.py`, the analog of
`cv2.grabCut(..., iterCount=1, GC_INIT_WITH_MASK)`:

1. fit two diagonal-covariance colour GMMs (k components each) to the
   probable-foreground and the background pixels with weighted EM, on a
   copy downscaled to a 160 px long side (weighted k-means seeds from the
   luminance order, no RNG);
2. the unary at full resolution is the log-likelihood ratio fg vs bg;
3. ICM sweeps: each pixel takes the side its unary plus an edge-aware
   3x3 neighbourhood agreement favours;
4. pixels outside the initial mask stay locked background, as cv2's
   GC_BGD; an empty result keeps the input mask.

It runs under `LEAF_GRABCUT=device`, and under `auto` where cv2 is missing
(`segment/mask._grabcut_any`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from leaffliction_tpu_torch.ops.image import resize

_LOG2PI = 1.8378770664093453
_LUMA = (0.299, 0.587, 0.114)


def _weighted_kmeans(x: torch.Tensor, w: torch.Tensor, k: int, iters: int
                     ) -> torch.Tensor:
    """Weighted k-means centres over pixels x [P, C] with weights w [P],
    seeded at the luminance quantiles of the weighted pixels."""
    lum = x @ torch.tensor(_LUMA, dtype=x.dtype, device=x.device)
    order = torch.argsort(torch.where(w > 0, lum, torch.inf), stable=True)
    n_valid = torch.clamp((w > 0).sum(), min=1).float()
    qs = ((torch.arange(k, dtype=torch.float32, device=x.device) + 0.5) / k
          * n_valid).long()
    centers = x[order[torch.clamp(qs, 0, x.shape[0] - 1)]]
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    for _ in range(iters):
        c2 = torch.sum(centers * centers, dim=1)[None, :]
        d = x2 - 2.0 * (x @ centers.T) + c2
        onehot = F.one_hot(torch.argmin(d, dim=1), k).float() * w[:, None]
        counts = onehot.sum(dim=0)[:, None]
        new = (onehot.T @ x) / torch.clamp(counts, min=1e-3)
        centers = torch.where(counts > 1e-3, new, centers)
    return centers


def _log_prob(x, means, var, log_pi) -> torch.Tensor:
    """[P, k] per-component log density of diagonal gaussians."""
    inv = 1.0 / var
    quad = ((x * x) @ inv.T - (2.0 * x) @ (means * inv).T
            + torch.sum(means * means * inv, dim=1)[None, :])
    logdet = torch.sum(torch.log(var), dim=1)[None, :]
    return log_pi[None, :] - 0.5 * (quad + logdet + x.shape[1] * _LOG2PI)


def _fit_gmm(x: torch.Tensor, w: torch.Tensor, k: int, km_iters: int = 6,
             em_iters: int = 4):
    """→ (means [k, C], var [k, C], log_pi [k]) by weighted EM from a
    weighted-k-means init."""
    means = _weighted_kmeans(x, w, k, km_iters)
    var = torch.full((k, x.shape[1]), 100.0, device=x.device)
    log_pi = torch.full((k,), -float(torch.log(torch.tensor(float(k)))),
                        device=x.device)
    for _ in range(em_iters):
        resp = torch.softmax(_log_prob(x, means, var, log_pi), dim=1) \
            * w[:, None]
        nk = resp.sum(dim=0)
        denom = torch.clamp(nk[:, None], min=1e-3)
        means = (resp.T @ x) / denom
        ex2 = (resp.T @ (x * x)) / denom
        var = torch.clamp(ex2 - means * means, 4.0, 1e4)
        log_pi = torch.log(torch.clamp(
            nk / torch.clamp(nk.sum(), min=1e-3), min=1e-6))
    return means, var, log_pi


def _gmm_loglik(pixels: torch.Tensor, means, var, log_pi) -> torch.Tensor:
    """Pixels [..., C] → log p(x) under the mixture, shape [...]."""
    x = pixels.reshape(-1, pixels.shape[-1])
    lp = _log_prob(x, means, var, log_pi)
    return torch.logsumexp(lp, dim=1).reshape(pixels.shape[:-1])


def grabcut_refine(rgb: torch.Tensor, mask: torch.Tensor, gmm_k: int = 5,
                   icm_iters: int = 10, fit_long_side: int = 160,
                   smooth_gamma: float = 2.0) -> torch.Tensor:
    """GrabCut-style refinement of one image: rgb [h, w, 3], `mask` the
    probable foreground [h, w] → refined bool mask (a subset of `mask`)."""
    rgb = rgb.float()
    m = mask.bool()
    h, w = m.shape

    # fit the GMMs on a downsampled image (Orchard-Bouman analog)
    scale = fit_long_side / max(h, w)
    sh, sw = max(1, int(h * scale)), max(1, int(w * scale))
    xs = resize(rgb, (sh, sw, 3), "linear").reshape(-1, 3)
    w_fg = resize(m.float(), (sh, sw), "nearest").reshape(-1)
    fg = _fit_gmm(xs, w_fg, gmm_k)
    bg = _fit_gmm(xs, 1.0 - w_fg, gmm_k)

    # unary at full resolution: > 0 → foreground
    llr = _gmm_loglik(rgb, *fg) - _gmm_loglik(rgb, *bg)

    # edge-aware smoothness weight: weak across strong colour gradients
    half = resize(rgb, (h // 2 or 1, w // 2 or 1, 3), "linear")
    diff = torch.abs(rgb - resize(half, (h, w, 3), "linear")).mean(dim=-1)
    edge_w = torch.exp(-diff / 20.0)

    ones = torch.ones((1, 1, 3, 3), device=rgb.device)
    labels = m
    for _ in range(icm_iters):
        neigh = F.conv2d(labels.float()[None, None], ones, padding=1
                         )[0, 0] / 9.0
        field = llr + smooth_gamma * edge_w * (2.0 * neigh - 1.0)
        labels = (field > 0.0) & m  # locked background
    # cv2 keeps PR_FGD when the cut is degenerate; guard empty results
    return labels if bool(labels.any()) else m
