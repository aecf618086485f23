"""Image-fusion quality metrics, in numpy: the port's own copy of
`fusionmamba_tpu/eval/metrics_fusion.py`.

  * ssim        -- structural similarity (Gaussian window 11, sigma 1.5, the
                   constants of pytorch_msssim), over the 'valid' region
  * qabf        -- Xydeas & Petrovic gradient-based fusion quality Q^{AB/F}
  * entropy     -- Shannon entropy of the fused image (EN)
  * std_dev     -- standard deviation (SD)
  * mutual_information -- MI(A;F) + MI(B;F) over 256-bin histograms
All functions take float arrays in [0, 1] (or uint8, normalised).
"""
from __future__ import annotations

import numpy as np


def _to_float01(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    if x.max() > 1.5:
        x = x / 255.0
    return np.squeeze(x)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def _filter2_valid(img: np.ndarray, win: np.ndarray) -> np.ndarray:
    """2-D correlation, 'valid' region (no padding bias)."""
    kh, kw = win.shape
    h, w = img.shape
    out = np.zeros((h - kh + 1, w - kw + 1))
    for i in range(kh):
        for j in range(kw):
            out += win[i, j] * img[i:i + h - kh + 1, j:j + w - kw + 1]
    return out


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Gaussian-window SSIM matching `pytorch_msssim/__init__.py:26-75`."""
    a = _to_float01(a)
    b = _to_float01(b)
    win = _gaussian_window()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2_valid(a, win)
    mu_b = _filter2_valid(b, win)
    saa = _filter2_valid(a * a, win) - mu_a ** 2
    sbb = _filter2_valid(b * b, win) - mu_b ** 2
    sab = _filter2_valid(a * b, win) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * sab + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (saa + sbb + c2)
    return float(np.mean(num / den))


def _sobel(img: np.ndarray):
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float64)
    ky = kx.T
    p = np.pad(img, 1, mode="edge")
    gx = _filter2_valid(p, kx)
    gy = _filter2_valid(p, ky)
    return gx, gy


def qabf(a: np.ndarray, b: np.ndarray, f: np.ndarray) -> float:
    """Q^{AB/F} (Xydeas & Petrovic 2000): edge-strength and orientation
    preservation from each source into the fused image, weighted by source
    edge strength. Constants are the published ones."""
    a, b, f = _to_float01(a) * 255, _to_float01(b) * 255, _to_float01(f) * 255
    gamma_g, kappa_g, sigma_g = 0.9994, -15.0, 0.5
    gamma_a, kappa_a, sigma_a = 0.9879, -22.0, 0.8
    eps = 1e-10

    def edge(img):
        gx, gy = _sobel(img)
        g = np.hypot(gx, gy)
        # published metric uses atan (range (-pi/2, pi/2]) -- orientation
        # modulo polarity, so contrast-inverted edges (common between IR
        # and fused) still count as preserved; atan2 would score them 0
        alpha = np.arctan(gy / (gx + eps))
        return g, alpha

    g_a, al_a = edge(a)
    g_b, al_b = edge(b)
    g_f, al_f = edge(f)

    def q_xf(g_x, al_x):
        ratio = np.where(g_x > g_f, (g_f + eps) / (g_x + eps),
                         (g_x + eps) / (g_f + eps))
        ang = 1.0 - np.abs(al_x - al_f) / (np.pi / 2.0)
        q_g = gamma_g / (1.0 + np.exp(kappa_g * (ratio - sigma_g)))
        q_a = gamma_a / (1.0 + np.exp(kappa_a * (ang - sigma_a)))
        return q_g * q_a

    q_af = q_xf(g_a, al_a)
    q_bf = q_xf(g_b, al_b)
    num = np.sum(q_af * g_a + q_bf * g_b)
    den = np.sum(g_a + g_b)
    return float(num / (den + eps))


def entropy(f: np.ndarray) -> float:
    """Shannon entropy (EN) over a 256-bin histogram."""
    f = _to_float01(f)
    hist, _ = np.histogram(f, bins=256, range=(0.0, 1.0))
    p = hist / max(hist.sum(), 1)
    p = p[p > 0]
    return float(-np.sum(p * np.log2(p)))


def std_dev(f: np.ndarray) -> float:
    return float(np.std(_to_float01(f) * 255.0))


def mutual_information(a: np.ndarray, b: np.ndarray,
                       f: np.ndarray) -> float:
    """MI = I(A;F) + I(B;F), 256-bin joint histograms."""
    def mi(x, y):
        x = (_to_float01(x) * 255).astype(np.uint8).ravel()
        y = (_to_float01(y) * 255).astype(np.uint8).ravel()
        joint, _, _ = np.histogram2d(x, y, bins=256,
                                     range=[[0, 256], [0, 256]])
        pxy = joint / joint.sum()
        px = pxy.sum(1, keepdims=True)
        py = pxy.sum(0, keepdims=True)
        nz = pxy > 0
        return float(np.sum(pxy[nz] * np.log2(
            pxy[nz] / (px @ py)[nz])))

    return mi(a, f) + mi(b, f)


def fusion_report(a: np.ndarray, b: np.ndarray, f: np.ndarray,
                  ref: np.ndarray | None = None) -> dict:
    """All metrics for one (source A, source B, fused) triple; if `ref`
    (a reference implementation's fused image) is given, adds parity
    SSIM(F, ref) -- the BASELINE.json north-star check."""
    out = {
        "qabf": qabf(a, b, f),
        "entropy": entropy(f),
        "std_dev": std_dev(f),
        "mi": mutual_information(a, b, f),
        "ssim_vis": ssim(f, a),
        "ssim_ir": ssim(f, b),
    }
    if ref is not None:
        out["ssim_vs_reference"] = ssim(f, ref)
    return out
