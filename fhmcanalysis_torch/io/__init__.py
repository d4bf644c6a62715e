from .netcdf import NCFile, read_composite, write_composite

__all__ = ["NCFile", "read_composite", "write_composite"]
