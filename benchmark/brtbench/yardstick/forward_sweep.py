"""The work of a forward render kernel with a dense sphere sweep (K1; K2
counted as brute force, every sphere a round; K4), frozen from the port's
chip checks.

Per executed (path, bounce) round: the discriminant of every sphere
(oc 3, hb 5, cq 6, disc 2 = 16 float32 operations; the root only where the
discriminant is positive, a small share, and not counted) plus the hit
frame, scatter and sky (~120).  Per path: the thin-lens camera ray (~70).
Bytes: the sphere tables in (48 a sphere) and the camera (64), the image out
(12 a pixel), K1's pixel ids in and path lengths out (8 a pixel), and
`res_streams` int16 residual streams out (2 bytes a pixel, sample and
bounce).  The rounds are the paths' own lengths, which every correct
renderer of the same inputs shares.
"""

from brtbench.yardstick.peaks import bound_seconds

SWEEP_FLOPS = 16
ROUND_FLOPS = 120
CAMERA_FLOPS = 70


def forward_work(kernel: str, n_spheres: int, n_pix: int, spp: int,
                 depth: int, rounds: float, res_streams: int = 0) -> tuple:
    """(flops, bytes) of one launch over n_pix pixels x spp samples whose
    paths took `rounds` rounds in all."""
    flops = (rounds * (n_spheres * SWEEP_FLOPS + ROUND_FLOPS)
             + n_pix * spp * CAMERA_FLOPS)
    nbytes = (n_spheres * 48 + 64 + n_pix * 12
              + (n_pix * 8 if kernel == "k1" else 0)
              + res_streams * 2 * spp * depth * n_pix)
    return flops, nbytes


def forward_bound(kernel: str, n_spheres: int, n_pix: int, spp: int,
                  depth: int, rounds: float, res_streams: int = 0) -> tuple:
    """(least seconds, what bounds it) of that launch on the card."""
    return bound_seconds(*forward_work(kernel, n_spheres, n_pix, spp, depth,
                                       rounds, res_streams))
