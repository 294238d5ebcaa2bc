"""Histogram filter — masked HSV analysis figure (reference
`filters/hist.py:22-300`).

Port of `leaffliction_tpu/segment/hist.py`. Every pixel statistic (the
colour-region percentages, the 60-bin HSV histograms, the hue pie counts)
is computed on the image's device in `hist_dispatch`; matplotlib only
renders the returned scalars and vectors (`_render_figure` is the JAX
package's, copied). Where matplotlib is not installed, `histogram_filter`
logs the statistics, warns once that the figure needs matplotlib, and
returns None (the transform CLI then writes no Hist image).
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Optional

import numpy as np
import torch

from leaffliction_tpu_torch.core.logging import get_logger
from leaffliction_tpu_torch.segment.config import TransformConfig

LOGGER = get_logger(__name__)

# pyplot state is process-global; folder mode renders from worker threads
_MPL_LOCK = threading.Lock()

COLOR_KEYS = ("Vert Sain", "Vert Jaunâtre", "Jaune", "Brun/Orange", "Rouge",
              "Zones Sombres", "Zones Claires", "Violet/Pourpre")

_BAR_COLORS = {
    "Vert Sain": "#2E7D32", "Vert Jaunâtre": "#7CB342", "Jaune": "#FBC02D",
    "Brun/Orange": "#FF6F00", "Rouge": "#D32F2F", "Zones Sombres": "#424242",
    "Zones Claires": "#E0E0E0", "Violet/Pourpre": "#7B1FA2",
}

HUE_KEYS = ("Vert (35-85°)", "Jaune/Orange (15-35°)",
            "Rouge (0-15° & 160-180°)", "Violet (120-160°)", "Autres")
_PIE_COLORS = ["#4CAF50", "#FFC107", "#F44336", "#9C27B0", "#607D8B"]


def hist_dispatch(rgb: torch.Tensor):
    """Phase 1: the one-pass statistics of `rgb` (a tensor on its device),
    queued, not read back: (color [8], h_hist, s_hist, v_hist [60 each],
    hue_counts [5], masked pixel count)."""
    from leaffliction_tpu_torch.ops.colorspace import rgb_to_hsv

    hsv = rgb_to_hsv(rgb.float())
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    mask = (s > 10) & (v > 15) & (v < 245)
    n_mask = mask.sum()
    total = torch.clamp(n_mask, min=1)

    def frac(cond):
        return (mask & cond).sum() / total * 100.0

    color = torch.stack([
        frac((h >= 35) & (h <= 85) & (s >= 40) & (v >= 30)),
        frac((h >= 20) & (h <= 40) & (s >= 25) & (v >= 30)),
        frac((h >= 15) & (h <= 35) & (s >= 50) & (v >= 50)),
        frac((((h >= 0) & (h <= 25)) | (h >= 160)) & (s >= 30) & (v >= 20)),
        frac((((h >= 160) & (h <= 180)) | ((h >= 0) & (h <= 10)))
             & (s >= 40) & (v >= 30)),
        frac((v <= 50) & (s >= 20)),
        frac((v >= 200) & (s <= 30)),
        frac((h >= 120) & (h <= 160) & (s >= 20)),
    ])

    # 60-bin densities over each channel's fixed range; the bin is
    # x·(60/hi) in float32, the one product XLA folds x / hi * 60 into
    def hist60(x, hi):
        per_bin = float(np.float32(1.0 / hi) * np.float32(60.0))
        idx = torch.clamp((x * per_bin).to(torch.int32), 0, 59)
        counts = torch.bincount(idx.reshape(-1).long(),
                                weights=mask.reshape(-1).float(),
                                minlength=60).float()
        return counts / torch.clamp(counts.sum() * (hi / 60.0), min=1e-9)

    hue_counts = torch.stack([
        (mask & (h >= 35) & (h <= 85)).sum(),
        (mask & (h >= 15) & (h <= 35)).sum(),
        (mask & (((h >= 0) & (h <= 15)) | (h >= 160))).sum(),
        (mask & (h >= 120) & (h <= 160)).sum(),
        (mask & (h > 85) & (h < 120)).sum(),
    ]).float()
    return (color, hist60(h, 180.0), hist60(s, 255.0), hist60(v, 255.0),
            hue_counts, n_mask)


def color_region_percentages(rgb, device="cuda") -> Dict[str, float]:
    """The colour-region percentages of an RGB image, alone (computed on
    `device`)."""
    color = hist_dispatch(torch.as_tensor(np.asarray(rgb)).to(device))[0]
    return dict(zip(COLOR_KEYS, color.cpu().tolist()))


@functools.cache
def _warn_no_matplotlib() -> None:
    """The one warning of a process that renders no Hist figure."""
    LOGGER.warning("Hist: matplotlib is not installed, so no Hist figure is "
                   "written; its statistics are logged")


def histogram_filter(rgb: np.ndarray, cfg: TransformConfig, stats=None,
                     device="cuda") -> Optional[np.ndarray]:
    """→ RGB uint8 rendering of the analysis figure, or None without
    matplotlib (the statistics are logged instead).

    `stats`: optional pre-dispatched tuple from `hist_dispatch`. pyplot
    state is global, so only the figure build is serialized."""
    if stats is None:
        stats = hist_dispatch(torch.as_tensor(np.asarray(rgb)).to(device))
    color, h_hist, s_hist, v_hist, hue_counts, n_mask = (
        t.cpu().numpy() for t in stats)
    color_analysis: Dict[str, float] = dict(zip(COLOR_KEYS, color.tolist()))
    try:
        import matplotlib
    except ImportError:
        _warn_no_matplotlib()
        LOGGER.info("Hist statistics: %d pixels, %s", int(n_mask),
                    ", ".join(f"{k} {v:.1f}%"
                              for k, v in color_analysis.items()))
        return None

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with _MPL_LOCK:
        return _render_figure(plt, color_analysis, h_hist, s_hist, v_hist,
                              hue_counts, n_mask)


def _render_figure(plt, color_analysis, h_hist, s_hist, v_hist,
                   hue_counts, n_mask) -> np.ndarray:
    fig = plt.figure(figsize=(14, 8))

    # 1. color distribution bars (≥1% only)
    ax1 = plt.subplot(2, 2, 1)
    significant = {k: v for k, v in color_analysis.items() if v >= 1.0}
    if significant:
        names = list(significant)
        vals = list(significant.values())
        bars = ax1.bar(range(len(names)), vals,
                       color=[_BAR_COLORS.get(n, "#90A4AE") for n in names],
                       alpha=0.8, edgecolor="black", linewidth=0.5)
        for bar, pct in zip(bars, vals):
            ax1.text(bar.get_x() + bar.get_width() / 2, bar.get_height() + 0.5,
                     f"{pct:.1f}%", ha="center", va="bottom", fontsize=8,
                     weight="bold")
        ax1.set_xticks(range(len(names)))
        ax1.set_xticklabels(names, rotation=45, ha="right", fontsize=8)
        ax1.set_ylim(0, max(vals) * 1.15)
        ax1.grid(axis="y", alpha=0.3)
    else:
        ax1.text(0.5, 0.5, "Aucune couleur\nsignificative détectée",
                 ha="center", va="center", transform=ax1.transAxes, fontsize=12)
    ax1.set_title("Distribution des Couleurs Détectées")
    ax1.set_xlabel("Types de Couleurs")
    ax1.set_ylabel("Pourcentage (%)")

    # 2. HSV density histogram
    ax2 = plt.subplot(2, 2, 2)
    for hist, hi, color_name, label in (
            (h_hist, 180.0, "red", "Teinte (H)"),
            (s_hist, 255.0, "green", "Saturation (S)"),
            (v_hist, 255.0, "blue", "Valeur (V)")):
        centers = (np.arange(60) + 0.5) * hi / 60
        ax2.bar(centers, hist, width=hi / 60, color=color_name, alpha=0.6,
                label=label)
    ax2.axvline(x=35, color="darkgreen", linestyle="--", alpha=0.7,
                label="Vert début")
    ax2.axvline(x=85, color="darkgreen", linestyle="--", alpha=0.7,
                label="Vert fin")
    ax2.axvline(x=15, color="orange", linestyle=":", alpha=0.7,
                label="Jaune/Brun")
    ax2.set_xlabel("Valeur")
    ax2.set_ylabel("Densité")
    ax2.set_title("Histogramme HSV Amélioré")
    ax2.legend(fontsize=8)
    ax2.grid(True, alpha=0.3)

    # 3. text summary + health status
    ax3 = plt.subplot(2, 2, 3)
    ax3.axis("off")
    lines = ["ANALYSE DES COULEURS:", "",
             f"Pixels analysés: {int(n_mask):,}", ""]
    for name, pct in sorted(color_analysis.items(), key=lambda kv: -kv[1])[:6]:
        if pct >= 0.5:
            lines.append(f"• {name}: {pct:.1f}%")
    lines.append("")
    healthy = color_analysis["Vert Sain"] + color_analysis["Vert Jaunâtre"]
    disease = (color_analysis["Brun/Orange"] + color_analysis["Rouge"]
               + color_analysis["Jaune"])
    if healthy > 50:
        status = "Feuillage majoritairement sain"
    elif disease > 30:
        status = "Signes significatifs de maladie"
    elif color_analysis["Jaune"] > 20:
        status = "Possible jaunissement/stress"
    else:
        status = "État mixte ou indéterminé"
    lines.append(f"ÉTAT: {status}")
    ax3.text(0.05, 0.95, "\n".join(lines), transform=ax3.transAxes,
             fontsize=10, verticalalignment="top", fontfamily="monospace",
             bbox={"boxstyle": "round,pad=0.5", "facecolor": "lightgray",
                   "alpha": 0.8})

    # 4. hue pie
    ax4 = plt.subplot(2, 2, 4)
    total_hue = hue_counts.sum()
    if total_hue > 0:
        fractions = {k: v / total_hue * 100
                     for k, v in zip(HUE_KEYS, hue_counts) if v > 0}
        if fractions:
            _, _, autotexts = ax4.pie(
                fractions.values(), labels=fractions.keys(),
                colors=_PIE_COLORS[:len(fractions)], autopct="%1.1f%%",
                startangle=90)
            for t in autotexts:
                t.set_color("white")
                t.set_weight("bold")
                t.set_fontsize(8)
    ax4.set_title("Répartition par Teinte")

    plt.tight_layout()
    fig.canvas.draw()
    w, h_fig = fig.canvas.get_width_height()
    rgba = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8
                         ).reshape((h_fig, w, 4))
    out = rgba[..., :3].copy()
    plt.close(fig)
    return out
