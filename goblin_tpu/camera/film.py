"""Film: sharded scatter-add accumulation replacing per-thread tiles.

The reference accumulates into per-thread full-frame ImageTiles merged
under a mutex (src/GoblinThreadLocalStorage.h:60-101, GoblinFilm.cpp:61-90).
Here the film is a pair of device arrays (color (H,W,3), weight (H,W))
updated with `scatter-add` filter splats from the whole sample batch; the
cross-device merge is a `psum` in the sharded render step.

Reconstruction filters (box/triangle/gaussian/mitchell) are evaluated
analytically (closed form, differentiable) rather than through the
reference's quantized 16x16 lookup table — same normalization semantics
(src/GoblinFilter.cpp, GoblinFilm.cpp:10-37).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..io import exr as exr_io

FILTER_BOX = "box"
FILTER_TRIANGLE = "triangle"
FILTER_GAUSSIAN = "gaussian"
FILTER_MITCHELL = "mitchell"


@dataclass(frozen=True)
class FilterSpec:
    kind: str = FILTER_GAUSSIAN
    x_width: float = 1.0
    y_width: float = 1.0
    falloff: float = 2.0  # gaussian
    b: float = 2.0  # mitchell
    c: float = 2.0  # mitchell

    def normalize_term(self) -> float:
        """Filter integral (reference getNormalizeTerm per filter)."""
        if self.kind == FILTER_BOX:
            return 4.0 * self.x_width * self.y_width
        if self.kind == FILTER_TRIANGLE:
            return self.x_width ** 2 * self.y_width ** 2
        if self.kind == FILTER_GAUSSIAN:
            # numeric approximation, 20x20 midpoint-free grid like the
            # reference (src/GoblinFilter.cpp:48-63)
            step = 20
            dx = self.x_width / step
            dy = self.y_width / step
            ex = np.exp(-self.falloff * self.x_width ** 2)
            ey = np.exp(-self.falloff * self.y_width ** 2)
            xs = np.arange(step) * dx
            ys = np.arange(step) * dy
            gx = np.maximum(0.0, np.exp(-self.falloff * xs ** 2) - ex)
            gy = np.maximum(0.0, np.exp(-self.falloff * ys ** 2) - ey)
            return float(4.0 * dx * dy * np.outer(gy, gx).sum())
        if self.kind == FILTER_MITCHELL:
            # Correct separable integral: the 1D filter in pixel units is
            # M(2x/width), so each axis integrates to width * (I0 + I1)
            # with I0 = int_0^1 M, I1 = int_1^2 M of the Mitchell poly.
            # (The reference's getNormalizeTerm mixes the two 1D pieces
            # into a single non-separable sum with a -B-6B typo,
            # src/GoblinFilter.cpp:74-79; the constant cancels for
            # weight-normalized camera integrators, and we use the correct
            # value so splatting integrators stay unbiased.)
            b, c = self.b, self.c
            i0 = ((12 - 9 * b - 6 * c) / 4 + (-18 + 12 * b + 6 * c) / 3
                  + (6 - 2 * b)) / 6.0
            i1 = (15 * (-b - 6 * c) / 4 + 7 * (6 * b + 30 * c) / 3
                  + 3 * (-12 * b - 48 * c) / 2 + (8 * b + 24 * c)) / 6.0
            one_d = i0 + i1
            return float(self.x_width * self.y_width * one_d * one_d)
        raise ValueError(self.kind)

    def evaluate(self, dx, dy):
        """Unnormalized filter value at offsets (broadcastable jnp)."""
        if self.kind == FILTER_BOX:
            return jnp.ones_like(dx)
        if self.kind == FILTER_TRIANGLE:
            return jnp.maximum(0.0, self.x_width - jnp.abs(dx)) * jnp.maximum(
                0.0, self.y_width - jnp.abs(dy)
            )
        if self.kind == FILTER_GAUSSIAN:
            ex = float(np.exp(-self.falloff * self.x_width ** 2))
            ey = float(np.exp(-self.falloff * self.y_width ** 2))
            gx = jnp.maximum(0.0, jnp.exp(-self.falloff * dx * dx) - ex)
            gy = jnp.maximum(0.0, jnp.exp(-self.falloff * dy * dy) - ey)
            return gx * gy
        if self.kind == FILTER_MITCHELL:
            return self._mitchell_1d(dx / self.x_width) * self._mitchell_1d(
                dy / self.y_width
            )
        raise ValueError(self.kind)

    def _mitchell_1d(self, x):
        b, c = self.b, self.c
        x = jnp.abs(2.0 * x)
        inner = (
            (12 - 9 * b - 6 * c) * x ** 3 + (-18 + 12 * b + 6 * c) * x ** 2 + (6 - 2 * b)
        ) / 6.0
        outer = (
            (-b - 6 * c) * x ** 3
            + (6 * b + 30 * c) * x ** 2
            + (-12 * b - 48 * c) * x
            + (8 * b + 24 * c)
        ) / 6.0
        return jnp.where(x > 1.0, outer, inner)


@dataclass(frozen=True)
class FilmSpec:
    x_res: int = 512
    y_res: int = 512
    crop: tuple = (0.0, 1.0, 0.0, 1.0)
    filename: str = "goblin.exr"
    tone_mapping: bool = False
    bloom_radius: float = 0.0
    bloom_weight: float = 0.0
    filter: FilterSpec = field(default_factory=FilterSpec)

    @property
    def aspect_ratio(self) -> float:
        return self.x_res / self.y_res

    def crop_window(self):
        """(x_start, x_count, y_start, y_count) like reference Film ctor."""
        xs = int(np.ceil(self.x_res * self.crop[0]))
        xc = max(1, int(np.ceil(self.x_res * self.crop[1])) - xs)
        ys = int(np.ceil(self.y_res * self.crop[2]))
        yc = max(1, int(np.ceil(self.y_res * self.crop[3])) - ys)
        return xs, xc, ys, yc

    def sample_range(self):
        """Continuous sample bounds extended by filter width
        (reference Film::getSampleRange)."""
        xs, xc, ys, yc = self.crop_window()
        fw, fh = self.filter.x_width, self.filter.y_width
        return (
            int(np.floor(xs + 0.5 - fw)),
            int(np.floor(xs + 0.5 + xc + fw)),
            int(np.floor(ys + 0.5 - fh)),
            int(np.floor(ys + 0.5 + yc + fh)),
        )


def new_film(spec: FilmSpec):
    """-> (color (H,W,3), weight (H,W)) zero-initialized device arrays."""
    return (
        jnp.zeros((spec.y_res, spec.x_res, 3), jnp.float32),
        jnp.zeros((spec.y_res, spec.x_res), jnp.float32),
    )


def splat_taps(spec: FilmSpec, x, y, L, normalized=False):
    """Tap-expansion half of the filter splat: sample (x, y, L) ->
    (flat_idx, w, wL) update streams for the film scatter.

    Kept apart from the scatter: the splatting drivers jit splat_taps
    and splat_accum as separate dispatches, a shape that served an XLA
    scatter slow path of the accelerator this was first written for;
    whether it still pays on a GPU is open.
    """
    f = spec.filter
    dx_img = x - 0.5
    dy_img = y - 0.5
    nan_ok = jnp.all(jnp.isfinite(L), axis=-1) & jnp.isfinite(x) & jnp.isfinite(y)
    Kx = int(np.floor(2 * f.x_width)) + 1
    Ky = int(np.floor(2 * f.y_width)) + 1
    x0 = jnp.ceil(dx_img - f.x_width).astype(jnp.int32)
    y0 = jnp.ceil(dy_img - f.y_width).astype(jnp.int32)

    # static KyxKx window of candidate pixels per sample
    ky, kx = jnp.meshgrid(jnp.arange(Ky), jnp.arange(Kx), indexing="ij")
    px = x0[:, None, None] + kx[None]  # (R, Ky, Kx)
    py = y0[:, None, None] + ky[None]
    fdx = px.astype(jnp.float32) - dx_img[:, None, None]
    fdy = py.astype(jnp.float32) - dy_img[:, None, None]
    w = f.evaluate(fdx, fdy)
    inside = (
        (jnp.abs(fdx) <= f.x_width)
        & (jnp.abs(fdy) <= f.y_width)
        & (px >= 0)
        & (px < spec.x_res)
        & (py >= 0)
        & (py < spec.y_res)
        & nan_ok[:, None, None]
    )
    w = jnp.where(inside, w, 0.0)
    if normalized:
        w = w / f.normalize_term()
    # a masked weight of 0 times a NaN/inf sample is still NaN — zero the
    # radiance itself on discarded lanes before the multiply
    L = jnp.where(nan_ok[:, None], L, 0.0)
    flat_idx = (
        jnp.clip(py, 0, spec.y_res - 1) * spec.x_res + jnp.clip(px, 0, spec.x_res - 1)
    ).reshape(-1)
    w_flat = w.reshape(-1)
    wL = (w[..., None] * L[:, None, None, :]).reshape(-1, 3)
    return flat_idx, w_flat, wL


def splat_accum(color, weight, flat_idx, w_flat, wL):
    """Scatter half of the filter splat (see splat_taps), sliced into
    scatter-adds of at most 2M update points each."""
    SLICE = 1 << 21
    n = flat_idx.shape[0]
    cflat = color.reshape(-1, 3)
    wflat = weight.reshape(-1)
    for c0 in range(0, n, SLICE):
        sl = slice(c0, min(c0 + SLICE, n))
        cflat = cflat.at[flat_idx[sl]].add(wL[sl])
        wflat = wflat.at[flat_idx[sl]].add(w_flat[sl])
    return cflat.reshape(color.shape), wflat.reshape(weight.shape)


def splat(spec: FilmSpec, color, weight, x, y, L, normalized=False):
    """Filter-splat a batch of samples into the film (taps + scatter in
    one call — fine OUTSIDE jit where each op dispatches separately; jit
    users must call splat_taps / splat_accum as separate dispatches, see
    splat_taps)."""
    flat_idx, w_flat, wL = splat_taps(spec, x, y, L, normalized)
    return splat_accum(color, weight, flat_idx, w_flat, wL)


def splat_dense(spec: FilmSpec, color, weight, jx, jy, L, ys0=0, xs0=0):
    """Dense filter splat for the one-stratified-sample-per-pixel pass.

    When a render pass produces exactly one sample per crop pixel in image
    layout, filter splatting is a small non-stationary convolution: pixel
    (iy, ix) sums w(0.5 - o - jitter) * L over the static window of
    neighboring samples — dense shifted multiply-adds, no scatter. This
    replaces the (H*W*taps)-point scatter-add for the camera-sampled
    integrators; splatting integrators (LT/BDPT) keep the general
    scatter `splat`.

    jx, jy: (yc, xc) per-pixel jitters in [0,1); L: (yc, xc, 3) radiance.
    Returns updated full-film (color, weight); non-finite samples are
    discarded (reference ImageTile::addSample NaN guard,
    src/GoblinFilm.cpp:61-90).
    """
    f = spec.filter
    yc, xc = jx.shape
    Kx2 = int(np.floor(f.x_width + 0.5))
    Ky2 = int(np.floor(f.y_width + 0.5))
    fin = jnp.all(jnp.isfinite(L), axis=-1)
    Lz = jnp.where(fin[..., None], L, 0.0)

    def pad2(a, fill=0.0):
        return jnp.pad(a, ((Ky2, Ky2), (Kx2, Kx2)) + ((0, 0),) * (a.ndim - 2),
                       constant_values=fill)

    Lp = pad2(Lz)
    jxp = pad2(jx)
    jyp = pad2(jy)
    finp = pad2(fin.astype(jnp.float32))
    acc_c = jnp.zeros((yc, xc, 3), jnp.float32)
    acc_w = jnp.zeros((yc, xc), jnp.float32)
    for oy in range(-Ky2, Ky2 + 1):
        for ox in range(-Kx2, Kx2 + 1):
            # sample of pixel (iy+oy, ix+ox) seen from target (iy, ix)
            sl = (slice(Ky2 + oy, Ky2 + oy + yc), slice(Kx2 + ox, Kx2 + ox + xc))
            fdx = 0.5 - ox - jxp[sl]
            fdy = 0.5 - oy - jyp[sl]
            w = f.evaluate(fdx, fdy)
            w = jnp.where(
                (jnp.abs(fdx) <= f.x_width) & (jnp.abs(fdy) <= f.y_width),
                w * finp[sl], 0.0,
            )
            acc_c = acc_c + w[..., None] * Lp[sl]
            acc_w = acc_w + w
    color = color.at[ys0:ys0 + yc, xs0:xs0 + xc].add(acc_c)
    weight = weight.at[ys0:ys0 + yc, xs0:xs0 + xc].add(acc_w)
    return color, weight


def to_image(color, weight, normalize: bool = True):
    """Resolve accumulation to an image (reference Film::writeImage)."""
    if normalize:
        return color / jnp.maximum(weight, 1e-30)[..., None]
    return color


def luminance(rgb):
    return (
        0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]
    )


def tone_map(img: np.ndarray) -> np.ndarray:
    """Reinhard photographic tone mapping exactly as the reference
    implements it (src/GoblinImageIO.cpp:223-237, including its
    log(1e4 + y) world-adaptation constant)."""
    img = np.asarray(img, dtype=np.float32)
    y = np.asarray(luminance(jnp.asarray(img)))
    ywa = float(np.exp(np.mean(np.log(1e4 + y))))
    inv_y2 = 1.0 / (ywa * ywa)
    s = (1.0 + y * inv_y2) / (1.0 + y)
    return img * s[..., None]


def bloom(img: np.ndarray, radius: float, weight: float) -> np.ndarray:
    """Distance-falloff bloom post-process (src/GoblinImageIO.cpp:169-219),
    vectorized with an FFT-free separable-ish dense conv in numpy."""
    if radius <= 0.0 or weight <= 0.0:
        return img
    img = np.asarray(img, dtype=np.float32)
    h, w = img.shape[:2]
    fw = int(np.ceil(radius * max(w, h))) // 2
    if fw < 1:
        return img
    ys, xs = np.meshgrid(np.arange(-fw + 1, fw), np.arange(-fw + 1, fw),
                         indexing="ij")
    d = np.sqrt(xs.astype(np.float32) ** 2 + ys ** 2) / fw
    kern = np.maximum(0.0, 1.0 - d) ** 4
    kern[fw - 1, fw - 1] = 0.0  # exclude the center pixel
    from numpy.fft import irfft2, rfft2

    # padded FFT convolution for both numerator and normalization
    ph, pw = h + kern.shape[0] - 1, w + kern.shape[1] - 1
    K = rfft2(kern, (ph, pw))
    ones = np.ones((h, w), dtype=np.float32)
    norm = irfft2(rfft2(ones, (ph, pw)) * K, (ph, pw))[
        fw - 1 : fw - 1 + h, fw - 1 : fw - 1 + w
    ]
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        conv = irfft2(rfft2(img[:, :, c], (ph, pw)) * K, (ph, pw))[
            fw - 1 : fw - 1 + h, fw - 1 : fw - 1 + w
        ]
        out[:, :, c] = conv / np.maximum(norm, 1e-12)
    return (1.0 - weight) * img + weight * out


def write_image(spec: FilmSpec, image, normalize_note: str = "") -> str:
    """Post-process (bloom, tonemap) and write EXR/PPM. Returns the path."""
    img = np.asarray(image)
    if spec.bloom_radius > 0.0 and spec.bloom_weight > 0.0:
        img = bloom(img, spec.bloom_radius, spec.bloom_weight)
    if spec.tone_mapping:
        img = tone_map(img)
    path = spec.filename
    if path.endswith(".exr"):
        exr_io.write_exr(path, img)
    else:
        if not path.endswith(".ppm"):
            path = path + ".ppm"
        exr_io.write_ppm(path, img)
    return path
