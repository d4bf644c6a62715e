"""Window patching: simulation windows into one composite lnPI(N).

The PyTorch port's copy of the JAX package's ``win_patch/`` (host numpy;
no device work).  Front-ends for FHMCSimulation output (``fhmc_patch``,
``fhmc_equil``), its checkpoint dumps (``chkpt_patch``, ``chkpt_equil``)
and FEASST (``feasst_patch``, ``feasst_equil``), and the window-bound
generators (``windows``).  Each window class has ``to_composite()``, the
composite as ``io.read_composite`` would return it, and ``to_nc(fname)``,
which writes that dict (h5py needed only there).
"""

from . import chkpt_equil, chkpt_patch, feasst_equil, feasst_patch, fhmc_equil, fhmc_patch, windows

__all__ = ["fhmc_equil", "fhmc_patch", "chkpt_equil", "chkpt_patch", "feasst_equil", "feasst_patch", "windows"]
