"""A mesh of ranks: the spatial and wavelength axes across processes.

The port's counterpart of voronoirt_tpu/parallel/mesh.py (make_mesh,
make_hybrid_mesh, shard_regular, shard_voronoi).  JAX places an engine's
arrays on a device mesh and GSPMD emits the collectives; here each rank
is one process of a torch.distributed world (parallel/lam.py: join_group,
spawn) and the engines call the collectives themselves:

  * "lam": one block of wavelengths a rank, the rate integrals summed
    over the axis (parallel/lam.py; its LamGroup is this mesh's "lam"
    sub-group, so a ("lam",) mesh is that module's lambda split);
  * "x", "y" of the regular grid: one (x, y) tile of every field a rank.
    The xy step's stencil reaches one cell (two for the Bezier step's
    second-upwind sample), so S and the extinction travel as padded
    tiles with halos filled once per lambda chunk, and the carried
    intensity plane's halo is refilled after every xy step (JAX: the
    collective-permutes of jnp.roll's one-column halos).  The yz / xz
    march is sequential along x or y and its line interpolation wraps
    across the other, so a march segment gathers the whole planes it
    reads and runs on them on every rank of the spatial group, keeping
    its tile of each plane it makes;
  * "site" of the Voronoi grid (alias "y" / "x", as in JAX): a
    contiguous block of sites a rank; S and the extinction are gathered
    over the site group before each sweep, which runs on the whole site
    set (JAX: "gathers become all-gathers").

Only all_reduce and broadcast are used, so gloo can carry CUDA tensors
when ranks share one card (NCCL refuses that): a halo exchange writes
each rank's edge rows into its slot of a zeroed (P, 2, ...) buffer and
all_reduces it (SUM); a gathered plane is one broadcast a rank.  x and
y tiles need corners: x is exchanged first, then y with the x halo.
Mesh.tally counts the halo and gather calls, bytes and seconds.

Rank order: make_mesh lays the world's ranks out row-major over
axis_sizes; make_hybrid_mesh puts the dcn_axes outermost, so they vary
slowest (JAX's single-process rule, voronoirt_tpu/parallel/mesh.py:84-94).
Every extent must divide evenly, as JAX requires.  Angle slots
(parallel/angles.py) are an alternative to any mesh on the same devices.

Usage, in each of n processes (spawn() starts them from one, and hands
each its world, join_group's LamGroup):
    mesh = make_mesh((2, 2), ("lam", "y"), world=world)
    eng = RegularEngine(atmos, line, cfg, device=mesh.device, mesh=mesh)
    res = eng.run()                        # res.S: block and tile
    S = gather_space(gather_lambda(res.S, mesh.lam), mesh)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import lam as _lam

# the axes a regular engine splits its (x, y) tile over, and the names a
# Voronoi engine takes for its site axis, first found first (JAX's rule)
SPACE_AXES = ("x", "y")
SITE_AXES = ("site", "y", "x")


def _axis_groups(grid, dims, world):
    """The rank's LamGroup over the mesh axes `dims` (the ranks that
    differ only there, in C order), or None when they hold one rank.
    Every rank creates every such sub-group, in one order, as
    dist.new_group requires."""
    sizes = [grid.shape[d] for d in dims]
    if int(np.prod(sizes)) == 1:
        return None
    rest = [d for d in range(grid.ndim) if d not in dims]
    lines = np.transpose(grid, rest + list(dims)).reshape(
        -1, int(np.prod(sizes)))
    mine = None
    for line in lines:
        ranks = [int(r) for r in line]
        pg = dist.new_group(ranks)
        if world.rank in ranks:
            mine = _lam.LamGroup(ranks.index(world.rank), len(ranks),
                                 world.device, world.backend, pg=pg,
                                 ranks=ranks)
    return mine


class Mesh:
    """This rank's place in a mesh of torch.distributed ranks.

    axis_names / shape: the axes and their sizes; ranks: the global rank
    at each mesh coordinate (JAX's mesh.devices); coords: this rank's
    coordinate on each axis; device: this rank's; world: the whole
    world's LamGroup (the criterion's maximum); groups: one LamGroup a split axis (the ranks
    that differ only on it), and lam (the "lam" axis's, else None) and
    space (the non-"lam" axes together, else None); tally: the halo
    and gather collectives' calls, bytes and seconds."""

    def __init__(self, world, axis_sizes, axis_names, grid):
        self.world = world
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))
        self.ranks = grid
        self.device = world.device
        self.coords = self.coords_of(world.rank)
        self.groups = {}
        for d, name in enumerate(self.axis_names):
            g = _axis_groups(grid, [d], world)
            if g is not None:
                self.groups[name] = g
        self.lam = self.groups.get("lam")
        self.space = _axis_groups(
            grid, [d for d, n in enumerate(self.axis_names) if n != "lam"],
            world)
        self.tally = {k: {"calls": 0, "bytes": 0, "seconds": 0.0}
                      for k in ("halo", "gather")}

    def size(self, name):
        return self.shape.get(name, 1)

    def coords_of(self, rank):
        """The mesh coordinate of a global rank, {axis: index}."""
        where = np.argwhere(self.ranks == rank)[0]
        return dict(zip(self.axis_names, (int(i) for i in where)))

    def block(self, name, n, rank=None):
        """The slice of an n-long extent that `rank` (default: this
        rank) holds along axis `name`; the whole extent without the
        axis.  An extent the axis does not divide raises."""
        p = self.size(name)
        if n % p:
            raise ValueError(f"an extent of {n} does not split over the "
                             f"{p} ranks of mesh axis {name!r}")
        at = self.coords if rank is None else self.coords_of(rank)
        k, i = n // p, at.get(name, 0)
        return slice(i * k, (i + 1) * k)

    def site_axis(self):
        """The Voronoi engine's site axis: the first of "site", "y", "x"
        the mesh has (JAX's rule), or None; a second one split raises."""
        names = [n for n in SITE_AXES if n in self.shape]
        split = [n for n in names if self.size(n) > 1]
        if len(split) > 1:
            raise ValueError(f"a Voronoi engine splits one site axis, not "
                             f"{split}")
        return split[0] if split else (names[0] if names else None)

    def _run(self, kind, group, collective, tensor, **kwargs):
        _, dt = group._run(collective, tensor, **kwargs)
        t = self.tally[kind]
        t["calls"] += 1
        t["bytes"] += tensor.numel() * tensor.element_size()
        t["seconds"] += dt
        return tensor

    def halo(self, width):
        """The halo exchange and plane gather of the regular grid's (x, y)
        tiles at halo `width` (1 for the linear xy step, 2 for Bezier's)
        on the split axes; None when neither x nor y is split."""
        if self.size("x") == 1 and self.size("y") == 1:
            return None
        return Halo(self, width)


class Halo:
    """The halo exchange, plane gather and tile cut of one batched sweep
    on a spatially split regular grid.

    A padded tile is (..., nx + 2 hx, ny + 2 hy), hx = width on a split
    x axis and 0 otherwise (hy likewise).  flip_x / flip_y: (B,) bool
    per batch element (dim -3 of a plane), the mirror flips of a group
    sweep, or None.  A rank's tile flipped locally, halos included, is
    the padded tile of the mirrored position P - 1 - i in the flipped
    field, so an element's neighbours follow from its position there."""

    def __init__(self, mesh, width, flip_x=None, flip_y=None):
        self.mesh, self.width = mesh, int(width)
        self.hx = self.width if mesh.size("x") > 1 else 0
        self.hy = self.width if mesh.size("y") > 1 else 0
        self.flip_x, self.flip_y = flip_x, flip_y

    def with_flips(self, flip_x, flip_y):
        """This halo for a batch whose elements carry the given flips
        ((B,) bool tensors)."""
        return Halo(self.mesh, self.width, flip_x, flip_y)

    def _axes(self):
        """(dim, axis name, halo width, flips) of each split axis, x
        first."""
        return [(d, n, h, f) for d, n, h, f in
                ((-2, "x", self.hx, self.flip_x),
                 (-1, "y", self.hy, self.flip_y)) if h]

    def pad(self, A):
        """A tile (..., nx, ny) as a padded tile with its halos filled."""
        hx, hy = self.hx, self.hy
        nx, ny = A.shape[-2:]
        out = A.new_empty(tuple(A.shape[:-2]) + (nx + 2 * hx, ny + 2 * hy))
        out[..., hx:hx + nx, hy:hy + ny] = A
        return self.refill(out)

    def strip(self, P):
        """The interior (the tile) of a padded tile, a view."""
        X, Y = P.shape[-2:]
        return P[..., self.hx:X - self.hx, self.hy:Y - self.hy]

    def refill(self, P):
        """Fill the halos of a padded tile in place from the neighbours'
        interiors (periodic across the domain), x first, then y with the
        x halo, so the corners hold the diagonal neighbours'."""
        for dim, name, h, flip in self._axes():
            group = self.mesh.groups[name]
            n, i, N = group.size, group.rank, P.shape[dim]
            edges = torch.stack([P.narrow(dim, h, h),
                                 P.narrow(dim, N - 2 * h, h)])
            buf = edges.new_zeros((n,) + tuple(edges.shape))
            m = None if flip is None else flip.view(-1, 1, 1)
            if m is None:
                buf[i] = edges
            else:
                buf[i] += torch.where(m, 0.0, edges)
                buf[n - 1 - i] += torch.where(m, edges, 0.0)
            self.mesh._run("halo", group, dist.all_reduce, buf,
                           op=dist.ReduceOp.SUM)
            lo, hi = buf[(i - 1) % n, 1], buf[(i + 1) % n, 0]
            if m is not None:
                q = n - 1 - i
                lo = torch.where(m, buf[(q - 1) % n, 1], lo)
                hi = torch.where(m, buf[(q + 1) % n, 0], hi)
            P.narrow(dim, 0, h).copy_(lo)
            P.narrow(dim, N - h, h).copy_(hi)
        return P

    def gather(self, P):
        """The whole plane (B, Nx, Ny), each element in its own frame,
        from every rank's padded tile plane (B, nx + 2hx, ny + 2hy): one
        broadcast a rank of the spatial group."""
        mesh, space = self.mesh, self.mesh.space
        I = self.strip(P)
        px, py = mesh.size("x"), mesh.size("y")
        G = I.new_empty((px, py) + tuple(I.shape))
        for s, rank in enumerate(space.ranks):
            c = mesh.coords_of(rank)
            dst = G[c.get("x", 0), c.get("y", 0)]
            if s == space.rank:
                dst.copy_(I)
            mesh._run("gather", space, dist.broadcast, dst, src=rank)
        for d, flip in ((0, self.flip_x), (1, self.flip_y)):
            if flip is not None and G.shape[d] > 1:
                G = torch.where(flip.view(1, 1, -1, 1, 1), G.flip(d), G)
        B, nx, ny = I.shape
        return G.permute(2, 0, 3, 1, 4).reshape(B, px * nx, py * ny)

    def slab(self, W):
        """This rank's padded tile of a whole plane (B, Nx, Ny), each
        element at its position in its own frame (periodic)."""
        for dim, name, h, flip in self._axes():
            p, N = self.mesh.size(name), W.shape[dim]
            n, i = N // p, self.mesh.coords[name]

            def rows(q):
                return (torch.arange(-h, n + h, device=W.device)
                        + q * n) % N

            cut = W.index_select(dim, rows(i))
            if flip is not None:
                cut = torch.where(flip.view(-1, 1, 1),
                                  W.index_select(dim, rows(p - 1 - i)), cut)
            W = cut
        return W.contiguous()


# ---------------------------------------------------------------- meshes


def _checked(axis_sizes, axis_names, world):
    axis_sizes = tuple(int(s) for s in axis_sizes)
    axis_names = tuple(axis_names)[:len(axis_sizes)]
    if len(axis_sizes) != len(axis_names):
        raise ValueError("axis_sizes and axis_names length mismatch")
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"repeated mesh axis in {axis_names}")
    total = int(np.prod(axis_sizes))
    if total != world.size:
        raise ValueError(f"mesh {axis_sizes} needs {total} ranks, the "
                         f"world has {world.size}")
    return axis_sizes, axis_names


def make_mesh(axis_sizes, axis_names=("lam", "y"), *, world):
    """A Mesh over the world's ranks laid out row-major, e.g.
    make_mesh((2, 4), world=world) -> 2 lam-shards x 4 y-shards.  world:
    this rank's LamGroup from join_group (what spawn hands its function;
    JAX's `devices`).  Every rank calls it with the same arguments (it
    creates the sub-groups)."""
    axis_sizes, axis_names = _checked(axis_sizes, axis_names, world)
    grid = np.arange(world.size).reshape(axis_sizes)
    return Mesh(world, axis_sizes, axis_names, grid)


def make_hybrid_mesh(axis_sizes, axis_names, dcn_axes=("x",), *, world):
    """A Mesh whose `dcn_axes` vary slowest over the ranks: in a world
    spanning hosts, ranks are numbered host by host, so each coordinate
    of a DCN axis is one host's ranks and the other axes' collectives
    stay inside a host (the JAX package's layout rule: the spatial "x"
    axis, whose only collectives are halo exchanges, across hosts)."""
    axis_sizes, axis_names = _checked(axis_sizes, axis_names, world)
    unknown = set(dcn_axes) - set(axis_names)
    if unknown:
        raise ValueError(f"dcn_axes {unknown} not in axis_names")
    order = sorted(range(len(axis_names)),
                   key=lambda i: (axis_names[i] not in dcn_axes, i))
    grid = np.arange(world.size).reshape([axis_sizes[i] for i in order])
    return Mesh(world, axis_sizes, axis_names,
                np.transpose(grid, np.argsort(order)))


# --------------------------------------------------------------- engines


def shard_regular(engine, mesh):
    """Give a RegularEngine built whole this rank's place on `mesh` (any
    of "lam", "x", "y"): its fields keep the rank's (x, y) tile and its
    B0 (and a loaded S) the lambda block's rows of the tile.  JAX's name;
    building the engine with mesh=mesh avoids holding the whole fields
    first."""
    engine._attach_mesh(mesh)
    engine._cut_fields()
    return engine


def shard_voronoi(engine, mesh):
    """Give a VoronoiEngine built whole this rank's place on `mesh`
    ("lam" and one site axis, "site" or its alias "y" / "x"): its
    fields keep the rank's block of sites, its B0 the lambda block's
    rows of them."""
    engine._attach_mesh(mesh)
    engine._cut_fields()
    return engine


def gather_space(t, mesh, dims=(-2, -1)):
    """The whole array, on every rank, from each rank's tile: dims are
    t's spatial dims in the order of the mesh's spatial axes (x, y for
    the regular grid; the site dim for the Voronoi grid, dims=(d,)).
    One broadcast a rank of the spatial group, counted as a gather."""
    space = mesh.space
    if space is None:
        return t
    names = ([mesh.site_axis()] if len(dims) == 1 else list(SPACE_AXES))
    dims = [d % t.dim() for d in dims]
    shape = list(t.shape)
    for d, name in zip(dims, names):
        shape[d] *= mesh.size(name)
    out = t.new_empty(shape)
    for s, rank in enumerate(space.ranks):
        buf = (t.contiguous().clone() if s == space.rank
               else torch.empty_like(t, memory_format=torch.contiguous_format))
        mesh._run("gather", space, dist.broadcast, buf, src=rank)
        idx = [slice(None)] * t.dim()
        for d, name in zip(dims, names):
            idx[d] = mesh.block(name, shape[d], rank)
        out[tuple(idx)] = buf
    return out

