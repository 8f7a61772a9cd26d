"""rays_per_s: camera paths (width x height x spp) of every frame completed
in the window, over the window's seconds."""


def read(run):
    return run.frames * run.paths_per_frame / run.window_s
