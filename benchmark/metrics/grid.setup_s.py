"""grid.setup_s: host seconds of the Voronoi grid's set-up in the
benchmark's span: sampling the sites, the tessellation (build_sites)
and the 12 direction plans (VoronoiEngine.build_plans), from the disk
cache after a checkout's first run.  Layer: grid.  Moves setup_s."""


def read(run):
    return run.spans.get("grid_s")
