from . import collect, n1, ntot

__all__ = ["collect", "n1", "ntot"]
