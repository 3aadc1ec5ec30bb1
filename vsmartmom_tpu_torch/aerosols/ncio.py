"""NetCDF reading without a netCDF4 binding.

Counterpart of the JAX package's ``aerosols/ncio.py`` (reference
NCDatasets.jl reads in src/Aerosols/readers.jl and schemes/*.jl): NetCDF-3
(classic) through ``scipy.io.netcdf_file``, NetCDF-4 (an HDF5 file)
through ``h5py``, chosen by the file's signature; ``h5py`` is imported
only for a NetCDF-4 file.

The port names each variable's dimensions (``NCFile.dimensions``) and
``horizontal_mean_profile`` finds the ``lev`` and ``time`` axes by name.
The JAX package's function assumes the column-major ``(..., lev, time)``
order instead: on a GCHP field read in C order, ``(time, lev, nf, Ydim,
Xdim)``, it averages over the levels and returns a Ydim-long vector.
"""

import numpy as np


class NCFile:
    """Uniform variable access over scipy (NetCDF-3) or h5py (NetCDF-4)."""

    def __init__(self, path: str):
        self.path = path
        self._h5 = None
        self._sp = None
        with open(path, "rb") as f:
            netcdf3 = f.read(3) == b"CDF"
        if netcdf3:
            from scipy.io import netcdf_file
            self._sp = netcdf_file(path, "r", mmap=False)
        else:
            import h5py
            self._h5 = h5py.File(path, "r")

    def close(self):
        if self._sp is not None:
            self._sp.close()
        if self._h5 is not None:
            self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def variables(self):
        if self._sp is not None:
            return list(self._sp.variables)
        out = []
        self._h5.visit(lambda name: out.append(name))
        return [n for n in out if hasattr(self._h5[n], "shape")]

    def __contains__(self, name):
        return name in self.variables()

    def read(self, name):
        if self._sp is not None:
            return np.asarray(self._sp.variables[name][...])
        return np.asarray(self._h5[name][...])

    def dimensions(self, name):
        """The dimension names of variable ``name``, in its storage order
        (NetCDF-4: the dimension scales attached through ``DIMENSION_LIST``;
        a coordinate variable, itself a scale, names its own dimension),
        or None where a NetCDF-4 axis has no dimension scale."""
        if self._sp is not None:
            return tuple(self._sp.variables[name].dimensions)
        import h5py
        var = self._h5[name]
        if var.ndim == 1 and h5py.h5ds.is_scale(var.id):
            return (var.name.rsplit("/", 1)[-1],)
        dims = []
        for axis in var.dims:
            if len(axis) == 0:
                return None
            dims.append(axis[0].name.rsplit("/", 1)[-1])
        return tuple(dims)

    def profile(self, name):
        """``horizontal_mean_profile`` of variable ``name``."""
        return horizontal_mean_profile(self.read(name),
                                       self.dimensions(name))

    def attrs(self):
        if self._sp is not None:
            return {k: v for k, v in self._sp._attributes.items()}
        return dict(self._h5.attrs)


def horizontal_mean_profile(arr: np.ndarray, dims=None) -> np.ndarray:
    """Average a GEOS-Chem field over its horizontal (and face) axes,
    keeping the ``lev`` axis, at time index 0 (the readers in
    schemes/tomas15.jl:101-112 average the horizontal dimensions).

    ``dims`` names the axes of ``arr`` (``NCFile.dimensions``). A field of
    rank 1 is returned as it is; one of higher rank must have a ``lev``
    axis. The other axes are averaged one at a time from the first, lev
    moved last, so on ``(..., lev, time)`` data the result equals the JAX
    package's bit for bit."""
    a = np.asarray(arr, dtype=np.float64)
    if a.ndim == 1:
        return a
    dims = tuple(dims) if dims is not None else ()
    if len(dims) != a.ndim or "lev" not in dims:
        raise ValueError(f"a field of rank {a.ndim} needs a 'lev' "
                         f"dimension; its dimensions are {dims or None}")
    if "time" in dims:
        at = [slice(None)] * a.ndim
        at[dims.index("time")] = 0
        a = a[tuple(at)]
        dims = tuple(d for d in dims if d != "time")
    a = np.moveaxis(a, dims.index("lev"), -1)
    while a.ndim > 1:
        a = a.mean(axis=0)
    return a
