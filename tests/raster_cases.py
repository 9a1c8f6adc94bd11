"""Splat sets shared by the raster tests of street_crafter_tpu_torch (the
CPU tests and the ``cuda`` ones). numpy only: no JAX, no torch."""

import numpy as np

ALPHA_MIN_F32 = np.float32(1.0) / np.float32(255.0)


def adversarial_cull_splats(W, H, seed, channels=4):
    """Projected splats at the edges of the per-warp cull (kernels B and C
    skip a pair for a 16x2-pixel warp when no pixel centre there can reach
    alpha >= 1/255). Four groups:

    - grazers: the alpha = 1/255 contour passes within 1e-3 px (half of
      them 1e-6 px) of a pixel centre, inside or outside it, at random
      anisotropic conics;
    - opacities of 1/255 and one f32 ulp either side of it;
    - near-degenerate conics, a c - b^2 close to 0, of either sign;
    - centres far outside the image with radii that reach into it.

    plus tangent grazers, whose contour touches a pixel row at a pixel
    centre. Returns a dict of float32 arrays (``valid`` bool) in the raster's
    argument names, with ``channels`` colour channels in [0, 1]."""
    rng = np.random.default_rng(seed)
    groups = []

    def conics(n, lo, hi):
        s1, s2 = rng.uniform(lo, hi, n), rng.uniform(lo, hi, n)
        th = rng.uniform(0, np.pi, n)
        ct, st = np.cos(th), np.sin(th)
        a = ct ** 2 / s1 ** 2 + st ** 2 / s2 ** 2
        c = st ** 2 / s1 ** 2 + ct ** 2 / s2 ** 2
        b = ct * st * (1 / s1 ** 2 - 1 / s2 ** 2)
        return a, b, c, np.maximum(s1, s2)

    # grazers: centre = pixel centre - (s + delta) d along a unit d, where
    # sigma(s d) = ln(255 o) exactly (in float64)
    n = 160
    a, b, c, smax = conics(n, 0.8, 6.0)
    o = rng.uniform(0.02, 1.0, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.cos(phi), np.sin(phi)], 1)
    q = a * d[:, 0] ** 2 + 2 * b * d[:, 0] * d[:, 1] + c * d[:, 1] ** 2
    s = np.sqrt(2 * np.log(255 * o) / q)
    # half within 1e-3 px, half within 1e-6 px (below the f32 spacing of
    # the centre: the rounding decides which side the pixel falls)
    s += rng.uniform(-1e-3, 1e-3, n) * np.where(np.arange(n) % 2, 1e-3, 1.0)
    pc = np.stack([rng.integers(0, W, n) + 0.5, rng.integers(0, H, n) + 0.5],
                  1)
    ctr = pc - s[:, None] * d
    groups.append((ctr[:, 0], ctr[:, 1], a, b, c, o, smax))

    # tangent grazers: the contour touches a pixel row at a pixel centre
    # (the row's least sigma, which is what the cull tests, is there), from
    # the side away from the warp's other row; offsets within 1e-6 px
    n = 160
    a, b, c, smax = conics(n, 0.8, 6.0)
    o = rng.uniform(0.02, 1.0, n)
    pcx = rng.integers(0, W, n) + 0.5
    pyi = rng.integers(0, H, n)
    # min over dx of sigma at row offset dy is dy^2 (a c - b^2) / (2 a)
    dy = np.sqrt(2 * np.log(255 * o) * a / (a * c - b * b))
    dy *= np.where(pyi % 2 == 0, 1.0, -1.0) * (1 + rng.uniform(-1e-6, 1e-6,
                                                               n))
    groups.append((pcx + b * dy / a, pyi + 0.5 - dy, a, b, c, o, smax))

    # opacities at 1/255 and one ulp either side
    n = 60
    a, b, c, smax = conics(n, 0.5, 3.0)
    o = np.array([np.nextafter(ALPHA_MIN_F32, np.float32(0)), ALPHA_MIN_F32,
                  np.nextafter(ALPHA_MIN_F32, np.float32(1))],
                 np.float32)[rng.integers(0, 3, n)]
    groups.append((rng.integers(0, W, n) + 0.5 + rng.uniform(-0.3, 0.3, n),
                   rng.integers(0, H, n) + 0.5 + rng.uniform(-0.3, 0.3, n),
                   a, b, c, o, smax))

    # near-degenerate conics: b^2 within a few 1e-7 of a c, either side
    n = 60
    s1, s2 = rng.uniform(1.0, 6.0, n), rng.uniform(1.0, 6.0, n)
    a, c = 1 / s1 ** 2, 1 / s2 ** 2
    eps = rng.choice([-3e-7, -1e-7, 0.0, 1e-7, 3e-7, 1e-6], n)
    b = np.sqrt(a * c) * (1 - eps) * rng.choice([-1.0, 1.0], n)
    groups.append((rng.uniform(0, W, n), rng.uniform(0, H, n), a, b, c,
                   rng.uniform(0.05, 1.0, n), np.maximum(s1, s2)))

    # centres far outside the image, wide enough to reach in
    n = 40
    a, b, c, smax = conics(n, 40.0, 90.0)
    side = rng.integers(0, 4, n)
    far = rng.uniform(100.0, 200.0, n)
    u = np.where(side == 0, -far, np.where(side == 1, W + far,
                                           rng.uniform(0, W, n)))
    v = np.where(side == 2, -far, np.where(side == 3, H + far,
                                           rng.uniform(0, H, n)))
    groups.append((u, v, a, b, c, rng.uniform(0.3, 1.0, n), smax))

    u, v, a, b, c, o, smax = (np.concatenate(x) for x in zip(*groups))
    n = u.shape[0]
    f32 = np.float32
    return dict(u=u.astype(f32), v=v.astype(f32), conic_a=a.astype(f32),
                conic_b=b.astype(f32), conic_c=c.astype(f32),
                colors=rng.uniform(0, 1, (n, channels)).astype(f32),
                opacities=o.astype(f32),
                depths=rng.uniform(1, 50, n).astype(f32),
                valid=np.ones(n, bool),
                # 4 std: the 1/255 contour reaches up to sqrt(2 ln 255) =
                # 3.33 std from the centre
                radii=np.ceil(4 * smax).astype(f32))
