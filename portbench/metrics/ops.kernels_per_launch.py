"""ops.kernels_per_launch: CUDA kernels (copies and sets not counted) in
the profiled period of the running pipeline, over the whole launches it
holds."""


def read(r):
    p = r.profile
    if p is None or not p.launches or not p.kernels:
        return None
    return p.kernels / p.launches
