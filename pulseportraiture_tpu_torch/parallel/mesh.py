"""Device mesh and batch placement for sharded fits (port of the JAX
package's ``parallel/mesh.py``).

One process drives a ('subint', 'chan', 'bin') grid of devices, as the
reference's single-controller ``Mesh`` does; the collectives the
reference's GSPMD inserts become explicit gathers in the sharded fit
(``fit/portrait.py``), with no ``torch.distributed`` inside a process:

* 'subint' — data parallelism over the fit batch (archives x subints, or
  pulsars x epochs for IPTA sweeps).  Each subint group runs its own
  solver on its lead device (the group's (chan 0, bin 0) device).
* 'chan'   — model parallelism over frequency channels.  The heavy arrays
  (data, model, cross-spectrum, |m|^2) live on their channel shard; the
  hand kernels run there, and their per-channel outputs are gathered on
  the lead device, where every channel sum is taken.
* 'bin'    — sequence parallelism over the phase-bin axis: the data of a
  (subint, chan) cell is gathered onto the cell's (bin 0) device before
  its rFFT, as the reference's complex path gathers the axis first.

A device may be named more than once (``make_mesh(devices=["cpu"] * 8)``;
eight cells on one card): each cell then runs where its device says, and
the gathers between cells on one device are no-ops.
"""

import collections
import itertools

import numpy as np
import torch

__all__ = ["AXES", "Mesh", "Shard", "ShardedTensor", "make_mesh", "shard",
           "shard_batch"]

# the mesh's axes, which are also the placement of a [B, nchan, nbin]
# fit batch: dimension d split over axis AXES[d]
AXES = ("subint", "chan", "bin")


def _device(d):
    """``d`` as a torch.device, a CUDA device with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A [n_subint, n_chan, n_bin] array of torch devices with the axis
    names ('subint', 'chan', 'bin')."""

    axis_names = AXES

    def __init__(self, devices):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != len(AXES):
            raise ValueError("mesh devices %s do not match the axes %s"
                             % (self.devices.shape, AXES))

    @property
    def shape(self):
        """{axis name: size}, in axis order (as the reference's
        ``Mesh.shape``)."""
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def first(self):
        """The device the sharded fit returns its results on."""
        return self.devices.flat[0]

    def lead(self, i):
        """Subint group ``i``'s lead device: its solver runs there."""
        return self.devices[i, 0, 0]

    def __repr__(self):
        return "Mesh(%s, %s)" % (dict(self.shape),
                                 [str(d) for d in self.devices.flat])


def make_mesh(n_subint=None, n_chan=1, n_bin=1, devices=None):
    """Mesh with axes ('subint', 'chan', 'bin').

    Defaults to every visible CUDA device once, all on the subint (data)
    axis; set n_chan > 1 to split the channels and n_bin > 1 to split the
    phase bins as well.  ``devices`` lists the devices (names or
    torch.device; one may appear more than once).  With no CUDA device
    and no ``devices`` this raises, as every entry point of the port does.
    """
    if devices is None:
        from ..config import default_device

        default_device()  # no CUDA: raise
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if n_subint is None:
        n_subint = n // (n_chan * n_bin)
    if n_subint * n_chan * n_bin != n:
        raise ValueError(
            f"mesh {n_subint}x{n_chan}x{n_bin} != {n} devices")
    dev_array = np.empty(n, dtype=object)
    dev_array[:] = devices
    return Mesh(dev_array.reshape(n_subint, n_chan, n_bin))


Shard = collections.namedtuple("Shard", "device coords index data")
Shard.__doc__ = """One block of a :class:`ShardedTensor`: the tensor
``data`` on ``device``, the mesh coordinates ``coords`` (subint, chan,
bin) of that device and the block's ``index`` (a slice per dimension)
in the global array."""


class ShardedTensor:
    """A global array of ``shape`` split over ``mesh`` by ``spec`` (a mesh
    axis name or None per dimension), one :class:`Shard` per mesh cell; a
    dimension whose axis is not in ``spec`` holds copies."""

    def __init__(self, mesh, spec, shape, shards):
        self.mesh, self.spec = mesh, tuple(spec)
        self.shape, self.shards = tuple(shape), list(shards)
        self._by_coords = {s.coords: s for s in self.shards}

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        return self.shards[0].data.dtype

    def block(self, coords):
        """The shard at mesh coordinates ``coords``."""
        return self._by_coords[tuple(coords)]

    def cell(self, i, j):
        """The (subint group ``i``, channel shard ``j``) block with its
        bin shards joined, on the cell's device (bin coordinate 0)."""
        dev = self.mesh.devices[i, j, 0]
        parts = [self.block((i, j, k)).data
                 for k in range(self.mesh.devices.shape[2])]
        if "bin" not in self.spec or len(parts) == 1:
            return parts[0].to(dev)
        return torch.cat([p.to(dev) for p in parts], dim=-1)

    def gather(self, device=None):
        """The whole array on ``device`` (the mesh's first by default)."""
        device = self.mesh.first if device is None else _device(device)
        out = None
        for s in self.shards:
            if out is None:
                out = torch.empty(self.shape, dtype=s.data.dtype,
                                  device=device)
            out[s.index] = s.data.to(device)
        return out

    def __repr__(self):
        return "ShardedTensor(shape=%s, spec=%s, %d shards)" % (
            self.shape, self.spec, len(self.shards))


def _blocks(size, n, what):
    if size % n:
        raise ValueError("%s of %d does not divide over %d mesh devices"
                         % (what, size, n))
    b = size // n
    return [slice(i * b, (i + 1) * b) for i in range(n)]


def shard(mesh, x, spec, dtype=None):
    """Place array ``x`` (tensor or numpy) on ``mesh``: dimension d is
    split over mesh axis ``spec[d]`` (None: whole), each block copied to
    its cell's device (as ``dtype`` when given).  Raises ValueError where
    a dimension does not divide over its axis."""
    spec = tuple(spec)
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    if len(spec) != x.ndim:
        raise ValueError("spec %s for a %d-D array" % (spec, x.ndim))
    sizes = mesh.shape
    slices = [None if ax is None else _blocks(
        x.shape[d], sizes[ax], "%s axis (dim %d)" % (ax, d))
        for d, ax in enumerate(spec)]
    shards = []
    for coords in itertools.product(*(range(n) for n in
                                      mesh.devices.shape)):
        pos = dict(zip(AXES, coords))
        index = tuple(slice(None) if ax is None else slices[d][pos[ax]]
                      for d, ax in enumerate(spec))
        dev = mesh.devices[coords]
        shards.append(Shard(dev, coords, index,
                            x[index].to(device=dev, dtype=dtype)))
    return ShardedTensor(mesh, spec, x.shape, shards)


def shard_batch(mesh, data_ports, model_ports=None, errs=None,
                weights=None):
    """Place fit-batch arrays on the mesh: data and model [B, nchan, nbin]
    over ('subint', 'chan', 'bin'), errs and weights [B, nchan] over
    ('subint', 'chan') (copied on the bin axis).  Returns ShardedTensors,
    one alone or a tuple in the argument order."""
    out = [shard(mesh, data_ports, AXES)]
    if model_ports is not None:
        out.append(shard(mesh, model_ports, AXES))
    for x in (errs, weights):
        if x is not None:
            out.append(shard(mesh, x, AXES[:2]))
    return tuple(out) if len(out) > 1 else out[0]
