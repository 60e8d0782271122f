"""Stateless, batched sampling warps, CDF tables, and QMC sequences.

All warps take uniform [0,1) samples with any broadcastable batch shape and
return matching batched outputs, with pdfs as separate pure functions — the
same math as the reference (src/GoblinSampler.{h,cpp}:159-290,420-657) but
expressed as vectorized jnp so the whole wavefront warps in one fused op.

The reference's stateful mt19937 + stratified-buffer Sampler is replaced by
counter-based stateless streams (see core/rng.py); the warps here are pure.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .vecmath import INV_PI, INV_TWO_PI, TWO_PI


# ---------------------------------------------------------------------------
# Warps + pdfs
# ---------------------------------------------------------------------------


def uniform_sample_triangle(u1, u2):
    """-> barycentric (u, v) uniformly over a triangle."""
    r = jnp.sqrt(u1)
    return 1.0 - r, r * u2


def uniform_sample_cone(u1, u2, cos_theta_max):
    """Uniform direction in a z-up cone with half-angle acos(cos_theta_max)."""
    cos_t = 1.0 - u1 + u1 * cos_theta_max
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = TWO_PI * u2
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (TWO_PI * (1.0 - cos_theta_max))


def uniform_sample_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = TWO_PI * u2
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), z], axis=-1)


def uniform_sphere_pdf():
    return 0.5 * INV_TWO_PI


def uniform_sample_hemisphere(u1, u2):
    z = u1
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - u1 * u1))
    phi = TWO_PI * u2
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), z], axis=-1)


def uniform_hemisphere_pdf():
    return INV_TWO_PI


def cosine_sample_hemisphere(u1, u2):
    sin_t = jnp.sqrt(u1)
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - u1))
    phi = TWO_PI * u2
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def uniform_sample_disk(u1, u2):
    """Shirley–Chiu concentric square->disk map -> (x, y).

    Branchless port of the 4-quadrant map (reference
    src/GoblinSampler.cpp:561-601): r = max coordinate, theta pieced per
    quadrant; identical outputs up to fp rounding.
    """
    x = 2.0 * u1 - 1.0
    y = 2.0 * u2 - 1.0
    quarter_pi = 0.25 * np.pi
    safe_x = jnp.where(x == 0.0, 1.0, x)
    safe_y = jnp.where(y == 0.0, 1.0, y)
    # quadrant selectors
    upper = x + y > 0.0
    right = upper & (x > y)  # r = x
    up = upper & ~(x > y)  # r = y
    left = ~upper & (x < y)  # r = -x
    down = ~upper & ~(x < y)  # r = -y
    r = jnp.where(right, x, jnp.where(up, y, jnp.where(left, -x, -y)))
    theta = jnp.where(
        right,
        quarter_pi * (y / safe_x),
        jnp.where(
            up,
            quarter_pi * (2.0 - x / safe_y),
            jnp.where(
                left,
                quarter_pi * (4.0 + y / safe_x),
                jnp.where(y != 0.0, quarter_pi * (6.0 - x / safe_y), 0.0),
            ),
        ),
    )
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def gaussian_sample_2d(u1, u2, falloff, r_max=None):
    """Sample (x,y) ~ exp(-falloff * r^2), optionally truncated to r <= r_max."""
    u1 = jnp.maximum(u1, 1e-12)
    if r_max is None:
        r = jnp.sqrt(jnp.log(u1) / -falloff)
    else:
        r = jnp.sqrt(
            jnp.log(1.0 - u1 * (1.0 - jnp.exp(-falloff * r_max * r_max))) / -falloff
        )
    theta = TWO_PI * u2
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def gaussian_sample_2d_pdf(x, y, falloff, r_max=None):
    p = INV_PI * falloff * jnp.exp(-falloff * (x * x + y * y))
    if r_max is None:
        return p
    return p / (1.0 - jnp.exp(-falloff * r_max * r_max))


def exponential_sample(u, falloff):
    return -jnp.log(jnp.maximum(u, 1e-12)) / falloff


def exponential_pdf(x, falloff):
    return falloff * jnp.exp(-falloff * x)


def exponential_sample_range(u, sigma, a, b):
    """Sample t in [a,b] with pdf ~ exp(-sigma*(t-a))."""
    return a - jnp.log(1.0 - u * (1.0 - jnp.exp(sigma * (a - b)))) / sigma


def exponential_pdf_range(t, sigma, a, b):
    return sigma / (jnp.exp(sigma * (t - a)) - jnp.exp(sigma * (t - b)))


def equi_angular_sample(u, D, theta_a, theta_b):
    """Kulla–Fajardo equi-angular distance sampling along a ray."""
    return D * jnp.tan((1.0 - u) * theta_a + u * theta_b)


def equi_angular_pdf(t, D, theta_a, theta_b):
    return D / ((theta_b - theta_a) * (D * D + t * t))


def power_heuristic(n_a, pdf_a, n_b, pdf_b):
    """Veach power heuristic (beta=2) MIS weight for strategy A."""
    a = n_a * pdf_a
    b = n_b * pdf_b
    return a * a / jnp.maximum(a * a + b * b, 1e-30)


# ---------------------------------------------------------------------------
# CDF tables (discrete + piecewise-constant continuous)
# ---------------------------------------------------------------------------


def build_cdf_1d(f):
    """f: (..., N) nonneg -> dict with normalized cdf for inversion sampling.

    Matches reference CDF1D (src/GoblinSampler.cpp:309-356): dx = 1/N,
    cdf[i] = prefix-sum / integral.
    """
    f = jnp.asarray(f, dtype=jnp.float32)
    n = f.shape[-1]
    dx = 1.0 / n
    integral = jnp.sum(f, axis=-1, keepdims=True) * dx
    safe_int = jnp.where(integral > 0.0, integral, 1.0)
    cdf = jnp.cumsum(f, axis=-1) * dx / safe_int
    cdf = jnp.concatenate([jnp.zeros_like(cdf[..., :1]), cdf], axis=-1)
    return {"func": f, "cdf": cdf, "integral": integral[..., 0], "count": n}


def _cdf_find(cdf, u):
    """Last index i with cdf[..., i] <= u, clipped to valid cells.

    Compare-all search: broadcasts over batched per-row tables (which
    jnp.searchsorted cannot) with dense compares; CDF tables here are
    small (lights, env-map rows).
    """
    n = cdf.shape[-1] - 1
    idx = jnp.sum((cdf[..., :-1] <= u[..., None]).astype(jnp.int32), axis=-1) - 1
    return jnp.clip(idx, 0, n - 1)


def _gather_last(a, idx):
    """a[..., idx] with idx batched over leading axes of a."""
    if a.ndim == 1:
        return a[idx]
    return jnp.take_along_axis(a, idx[..., None], axis=-1)[..., 0]


def sample_cdf_discrete(table, u):
    """Pick index i with prob f[i]/sum(f). Returns (i, pdf_i)."""
    u = jnp.asarray(u)
    idx = _cdf_find(table["cdf"], u)
    n = table["count"]
    pdf = _gather_last(table["func"], idx) / jnp.maximum(
        table["integral"] * n, 1e-30
    )
    return idx, pdf


def sample_cdf_continuous(table, u):
    """Invert the piecewise-constant cdf. Returns (x in [0,1), pdf, idx)."""
    u = jnp.asarray(u)
    cdf = table["cdf"]
    n = table["count"]
    idx = _cdf_find(cdf, u)
    c0 = _gather_last(cdf, idx)
    c1 = _gather_last(cdf, idx + 1)
    d = jnp.where(c1 > c0, (u - c0) / jnp.maximum(c1 - c0, 1e-30), 0.0)
    x = (idx.astype(jnp.float32) + d) / n
    pdf = _gather_last(table["func"], idx) / jnp.maximum(table["integral"], 1e-30)
    return x, pdf, idx


def build_cdf_2d(f):
    """f: (H, W) -> separable row-marginal + per-row conditional tables.

    Matches reference CDF2D (src/GoblinSampler.cpp:359-405): conditional
    along W per row, marginal over row integrals.
    """
    f = jnp.asarray(f, dtype=jnp.float32)
    h, w = f.shape
    cond = build_cdf_1d(f)  # (H, W) batched over rows
    marg = build_cdf_1d(cond["integral"])  # (H,)
    return {"cond": cond, "marg": marg, "shape": (h, w)}


def sample_cdf_2d(table, u1, u2):
    """-> ((u, v) in [0,1)^2, pdf) with pdf w.r.t. unit-square area."""
    h, w = table["shape"]
    v, pdf_v, row = sample_cdf_continuous(table["marg"], u1)
    cond = table["cond"]
    row_table = {
        "func": cond["func"][row],
        "cdf": cond["cdf"][row],
        "integral": cond["integral"][row],
        "count": w,
    }
    uu, pdf_u, _ = sample_cdf_continuous(row_table, u2)
    return jnp.stack([uu, v], axis=-1), pdf_v * pdf_u


def pdf_cdf_2d(table, u, v):
    """pdf at (u, v) w.r.t. unit-square area."""
    h, w = table["shape"]
    row = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    col = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    f = table["cond"]["func"][row, col]
    integral = table["marg"]["integral"]
    return f / jnp.maximum(integral, 1e-30)


# ---------------------------------------------------------------------------
# QMC: radical inverse / permuted Halton (used by SPPM)
# ---------------------------------------------------------------------------

_PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149,
    151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229,
    233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311, 313,
]


def primes(n):
    """First n primes (host-side)."""
    ps = list(_PRIMES)
    c = ps[-1]
    while len(ps) < n:
        c += 2
        if all(c % p for p in ps if p * p <= c):
            ps.append(c)
    return ps[:n]


def radical_inverse(n, base, n_digits=32):
    """Van der Corput radical inverse of integer n in `base` (traceable)."""
    n = jnp.asarray(n, dtype=jnp.uint32)
    inv_base = 1.0 / base

    def body(_, carry):
        n, inv, val = carry
        d = (n % base).astype(jnp.float32)
        return n // base, inv * inv_base, val + d * inv

    _, _, val = jax.lax.fori_loop(
        0,
        n_digits,
        body,
        (n, jnp.full(jnp.shape(n), inv_base, jnp.float32), jnp.zeros(jnp.shape(n), jnp.float32)),
    )
    return val


def permuted_radical_inverse(n, base, perm):
    """Radical inverse with a digit permutation table perm: (base,) int32.

    perm must satisfy perm[0] != 0 handling: trailing zeros map to perm[0],
    compensated by the closed-form tail perm[0]*base/(base-1) scaled per the
    reference (src/GoblinSampler.cpp:700-748).
    """
    n = jnp.asarray(n, dtype=jnp.uint32)
    inv_base = 1.0 / base
    n_digits = int(np.ceil(32 / np.log2(base))) + 1

    def body(_, carry):
        n, inv, val = carry
        d = perm[(n % base).astype(jnp.int32)].astype(jnp.float32)
        return n // base, inv * inv_base, val + d * inv

    _, inv, val = jax.lax.fori_loop(
        0,
        n_digits,
        body,
        (n, jnp.full(jnp.shape(n), inv_base, jnp.float32), jnp.zeros(jnp.shape(n), jnp.float32)),
    )
    # account for the infinite tail of permuted zero digits
    val = val + perm[0].astype(jnp.float32) * inv / (1.0 - inv_base) * inv_base
    return jnp.minimum(val, 1.0 - 1e-7)


# ---------------------------------------------------------------------------
# Stratified jitter helpers (stateless replacement for reference Sampler)
# ---------------------------------------------------------------------------


def stratified_1d(key, n, jitter=True):
    """n stratified samples in [0,1)."""
    cells = (jnp.arange(n, dtype=jnp.float32)) / n
    if jitter:
        off = jax.random.uniform(key, (n,)) / n
    else:
        off = 0.5 / n
    return cells + off


def stratified_2d(key, nx, ny, jitter=True):
    """(nx*ny, 2) stratified samples in [0,1)^2."""
    ix, iy = jnp.meshgrid(jnp.arange(nx), jnp.arange(ny), indexing="ij")
    base = jnp.stack([ix.reshape(-1), iy.reshape(-1)], axis=-1).astype(jnp.float32)
    scale = jnp.array([1.0 / nx, 1.0 / ny], dtype=jnp.float32)
    if jitter:
        off = jax.random.uniform(key, (nx * ny, 2)) * scale
    else:
        off = 0.5 * scale
    return base * scale + off
