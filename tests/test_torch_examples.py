"""PyTorch port: the example scripts ported from examples/, run as a user
runs them, each in a fresh interpreter on the CPU.

examples/torch_joint_binary_surface.py is held against the JAX package's
examples/joint_binary_surface.py: the same assertions pass inside the
script, and the printed table and counts are the same lines.  With
--shards 4 it also runs the sweep split over four CPU shards and asserts
that it matches the unsharded sweep.
"""

import os
import subprocess
import sys

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _run(code, timeout):
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=timeout, cwd=EXAMPLES)
    assert res.returncode == 0, "%s\n%s" % (res.stdout[-2000:], res.stderr[-2000:])
    return res.stdout.splitlines()


def test_torch_joint_binary_surface():
    port = _run(
        "import sys, runpy; sys.argv = ['torch_joint_binary_surface.py', '--device', 'cpu', '--shards', '4'];"
        "runpy.run_path(%r, run_name='__main__')" % os.path.join(EXAMPLES, "torch_joint_binary_surface.py"),
        timeout=120,
    )
    ref = _run(
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        "import runpy; runpy.run_path(%r, run_name='__main__')" % os.path.join(EXAMPLES, "joint_binary_surface.py"),
        timeout=120,
    )
    assert any(line.startswith("sharded over GridMesh(") and line.endswith("matches the unsharded sweep") for line in port)
    table = [line for line in port if not line.startswith("sharded over")]
    assert table[:-1] == ref[:-1]  # the header and the rows
    assert table[-1].split("; on ")[0] == ref[-1].split("; one launch")[0]  # the counts
