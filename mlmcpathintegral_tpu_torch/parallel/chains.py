"""Chain-parallel layer over ``torch.distributed`` (PyTorch port of
``mlmcpathintegral_tpu/parallel/chains.py``).

The reference parallelises by running independent Markov chains on MPI
ranks and allreducing scalar statistics (src/mpi/mpi_wrapper.{hh,cc}).
The JAX package shards the chain axis of every state over a device mesh.
Here each process (one rank, one card) holds a contiguous block of the
global chain axis:

  * ``chain_mesh`` names the ranks that split the chains: a
    :class:`ChainMesh` holds the process group, this rank's index in it,
    the group's size and the axis name; with no process group initialised
    it is a one-rank mesh.  ``make_mesh`` lays the ranks out on several
    named axes (chains x space), each axis a process group of its own;
  * ``shard_chains`` keeps this rank's block [r C/W, (r+1) C/W) of every
    leaf's leading axis, the counterpart of ``device_put`` with
    ``P('chains')``; ``gather_chains`` rebuilds the global chain axis on
    every rank, which is how the statistics getters see all chains;
  * a kernel launched on a rank's block takes ``chain0 = r C/W``, so its
    counter RNG hashes the global chain index and the block draws what
    the same chains of a one-process run draw.

Collectives on a gloo group take host tensors: the helpers here copy a
CUDA operand to the host before a gloo collective and the result back
after it (``host_staged``), a fixed rule of the group's backend.  An NCCL
group takes the card's tensors directly.

``distribute_n`` (even split of a sample budget, mpi_wrapper.hh:125)
becomes a static per-chain target.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mlmcpathintegral_tpu_torch.utils.tree import tree_flatten, tree_unflatten


class ChainMesh:
    """One named axis of ranks: ``group`` (None for one rank), this
    process's ``rank`` in it, ``world_size`` and ``axis_name``;
    ``ranks`` are the group's global ranks in axis order."""

    def __init__(self, group, rank: int, world_size: int, axis_name: str,
                 ranks=None):
        self.group = group
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.axis_name = axis_name
        self.ranks = tuple(ranks) if ranks is not None \
            else tuple(range(world_size))

    def axis(self, name: str | None = None) -> "ChainMesh":
        if name is not None and name != self.axis_name:
            raise ValueError(f"mesh has no axis '{name}' (its axis is "
                             f"'{self.axis_name}')")
        return self

    def __repr__(self):
        return (f"ChainMesh(axis_name={self.axis_name!r}, rank={self.rank}, "
                f"world_size={self.world_size})")


class Mesh:
    """Ranks laid out on several named axes (row-major over the world);
    ``axis(name)`` is the :class:`ChainMesh` of this rank's line along
    that axis."""

    def __init__(self, axes: dict):
        self._axes = dict(axes)

    @property
    def axis_names(self):
        return tuple(self._axes)

    @property
    def shape(self) -> dict:
        return {n: a.world_size for n, a in self._axes.items()}

    def axis(self, name: str | None = None) -> ChainMesh:
        if name is None:
            name = self.axis_names[0]
        if name not in self._axes:
            raise ValueError(f"mesh has no axis '{name}' (axes "
                             f"{self.axis_names})")
        return self._axes[name]

    def __repr__(self):
        return f"Mesh({self.shape})"


def chain_mesh(n_devices: int | None = None, group=None,
               axis_name: str = "chains") -> ChainMesh:
    """1-D mesh over the ranks of ``group`` (default: every rank of the
    initialised process group; a one-rank mesh when none is initialised).
    ``n_devices``, when given, must be the group's size."""
    if not dist.is_available() or not dist.is_initialized():
        size, rank, ranks = 1, 0, (0,)
        group = None
    else:
        group = group if group is not None else dist.group.WORLD
        size = dist.get_world_size(group)
        rank = dist.get_rank(group)
        ranks = dist.get_process_group_ranks(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"need {n_devices} devices, have {size}")
    return ChainMesh(group if size > 1 else None, rank, size, axis_name,
                     ranks)


def make_mesh(shape, axis_names) -> Mesh:
    """Lay the world's ranks out row-major on ``shape`` with one process
    group per line of each axis (``dist.new_group``; every rank builds
    every group in the same order, as the call requires).  A 2-D
    ``(n_chains, n_space)`` mesh is the chains x space layout of
    ``parallel/spatial.py``."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError("one axis name per mesh dimension")
    world = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    total = 1
    for s in shape:
        total *= s
    if total != world:
        raise ValueError(f"mesh {shape} needs {total} ranks, have {world}")
    # row-major coordinates of every rank
    coords = []
    for r in range(world):
        c, rem = [], r
        for s in reversed(shape):
            c.append(rem % s)
            rem //= s
        coords.append(tuple(reversed(c)))
    axes = {}
    for d, name in enumerate(axis_names):
        mine = None
        lines = {}
        for r in range(world):
            key = coords[r][:d] + coords[r][d + 1:]
            lines.setdefault(key, []).append(r)
        for key in sorted(lines):
            ranks = lines[key]
            group = (dist.new_group(ranks)
                     if dist.is_initialized() and len(ranks) > 1 else None)
            if me in ranks:
                mine = ChainMesh(group, ranks.index(me), len(ranks), name,
                                 ranks)
        axes[name] = mine
    return Mesh(axes)


def host_staged(group) -> bool:
    """True where the group's collectives take host tensors (gloo)."""
    return group is not None and dist.get_backend(group) == "gloo"


def _block(mesh: ChainMesh, n: int) -> tuple[int, int]:
    W = mesh.world_size
    if n % W:
        raise ValueError(f"chain count {n} must be a multiple of the "
                         f"{W} ranks of mesh axis '{mesh.axis_name}'")
    per = n // W
    return mesh.rank * per, per


def chain_offset(mesh, n_chains: int, axis_name: str = "chains") -> int:
    """Global index of this rank's first chain (its kernels' chain0)."""
    if mesh is None:
        return 0
    return _block(mesh.axis(axis_name), n_chains)[0]


def shard_chains(mesh, tree, axis_name: str = "chains"):
    """This rank's block of every tensor leaf's leading (chain) axis;
    0-dim leaves (counters, scalars) and non-tensor leaves are kept
    whole, as JAX replicates them."""
    ax = mesh.axis(axis_name)

    def place(leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            return leaf
        lo, per = _block(ax, leaf.shape[0])
        return leaf[lo:lo + per]

    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [place(x) for x in leaves])


def _all_gather_rows(ax: ChainMesh, flat: torch.Tensor) -> torch.Tensor:
    """[W, n] of every rank's ``flat`` [n] in rank order."""
    if ax.world_size == 1:
        return flat[None]
    staged = host_staged(ax.group)
    src = (flat.cpu() if staged else flat).contiguous()
    out = [torch.empty_like(src) for _ in range(ax.world_size)]
    dist.all_gather(out, src, group=ax.group)
    res = torch.stack(out)
    return res.to(flat.device) if staged else res


def gather_chains(mesh, tree, axis_name: str = "chains"):
    """Every tensor leaf of a chain-sharded tree on the global chain axis
    (the ranks' blocks in rank order), on every rank.  0-dim and
    non-tensor leaves are taken as replicated and kept.  Leaves of one
    dtype travel in one collective."""
    if mesh is None:
        return tree
    ax = mesh.axis(axis_name)
    leaves, treedef = tree_flatten(tree)
    if ax.world_size == 1:
        return tree
    out = list(leaves)
    by_dtype = {}
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor) and x.dim() > 0:
            by_dtype.setdefault((x.dtype, x.device), []).append(i)
    for (dtype, _), idx in by_dtype.items():
        wire = torch.uint8 if dtype == torch.bool else dtype
        flat = torch.cat([leaves[i].reshape(-1).to(wire) for i in idx])
        rows = _all_gather_rows(ax, flat)
        off = 0
        for i in idx:
            x = leaves[i]
            n = x.numel()
            part = rows[:, off:off + n].reshape(
                ax.world_size * x.shape[0], *x.shape[1:])
            out[i] = part.to(dtype).contiguous()
            off += n
    return tree_unflatten(treedef, out)


def all_reduce_scalar(mesh, value: float, op: str = "max",
                      axis_name: str = "chains", operand_on=None) -> float:
    """``value`` reduced over the ranks of the axis ("max" or "sum"), the
    same float on every rank (in float64).  ``operand_on``: the device of
    the run's tensors (an NCCL group's operand goes there; a gloo group's
    stays on the host)."""
    if mesh is None:
        return float(value)
    ax = mesh.axis(axis_name)
    if ax.world_size == 1:
        return float(value)
    on = "cpu" if host_staged(ax.group) or operand_on is None \
        else operand_on
    t = torch.tensor([float(value)], dtype=torch.float64, device=on)
    red = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[op]
    dist.all_reduce(t, op=red, group=ax.group)
    return float(t.item())


def distribute_n(n: int, n_chains: int) -> int:
    """Per-chain sample target for a global budget of n samples — the
    static analog of mpi_wrapper's distribute_n (mpi_wrapper.hh:125)."""
    return -(-n // n_chains)
