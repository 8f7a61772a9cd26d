"""The work of the replay-gradient kernel (K3), frozen from the port's
chip checks (`chip_smoke.py`'s K3 bound, PERF.md's K3 row).

Per path: the thin-lens camera ray and its adjoint (~160 float32
operations).  Per bounce that hit a sphere: the recorded winner's closed-
form root, hit frame, scatter and silhouette term and their adjoints
(~200).  A bounce that missed adds the sky and ends the path (counted in
the path's share).  Bytes: the residuals read, `res_streams` int16 streams
at one entry a (path, bounce) round the paths took; the sphere table in
(44 a sphere) and the camera (64); the image's cotangent in (12 a pixel);
the table's and camera's float64 cotangents out (88 a sphere, 128).  The
rounds and hit bounces are the paths' own, which every correct renderer of
the same inputs shares.
"""

from brtbench.yardstick.peaks import bound_seconds

PATH_FLOPS = 160
HIT_FLOPS = 200


def replay_work(n_spheres: int, n_pix: int, spp: int, rounds: float,
                hits: float, res_streams: int = 2) -> tuple:
    """(flops, bytes) of one launch over n_pix pixels x spp samples whose
    paths took `rounds` rounds in all, `hits` of them on a sphere."""
    flops = hits * HIT_FLOPS + n_pix * spp * PATH_FLOPS
    nbytes = (rounds * res_streams * 2 + n_spheres * 44 + 64 + n_pix * 12
              + n_spheres * 88 + 128)
    return flops, nbytes


def replay_bound(n_spheres: int, n_pix: int, spp: int, rounds: float,
                 hits: float, res_streams: int = 2) -> tuple:
    """(least seconds, what bounds it) of that launch on the card."""
    return bound_seconds(*replay_work(n_spheres, n_pix, spp, rounds, hits,
                                      res_streams))
