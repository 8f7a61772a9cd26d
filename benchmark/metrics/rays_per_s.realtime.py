"""rays_per_s.realtime: `rays_per_s` (see that file) in the real-time cell,
under a name of its own: its host-bound frames spread 3-12% between
processes, where the render cells' spread 0.1-0.9%, and one bound for both
would hide a K1 regression of a fifth in the render cells."""

from brtbench import spec


def read(run):
    return spec.reader("rays_per_s")(run)
