"""rays_per_s: camera paths of every item completed in the window (a
frame, or an optimizer step's render and gradient: width x height x spp
each), over the window's seconds."""


def read(run):
    return run.frames * run.paths_per_frame / run.window_s
