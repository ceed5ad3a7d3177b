"""Real two-process multi-host rendering over the CPU backend.

The only genuinely multi-host code path (parallel/multihost.py) cannot be
reached by single-process tests or the virtual mesh: `jax.distributed`
ordering bugs and cross-host image assembly only fail with >= 2 real
processes. This test launches two subprocesses that join one process group
via `multihost.initialize("localhost:port", 2, i)` (CPU backend, one device
each -> a 2-device global mesh spanning processes), render caustics.json
through `render_distributed`, and asserts host 0's assembled image equals
the single-process render (the sharded engines are bit-identical to
unsharded by global-lane-id construction, tests/test_parallel.py).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from conftest import CAUSTICS

W, H, SPP = 48, 36, 4
SCENE = CAUSTICS


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_render_matches_single(tmp_path):
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
    out = str(tmp_path / "mh.npy")

    env = dict(os.environ)
    # one CPU device per process (the conftest's 8-device forcing must not
    # leak into the workers: 2 processes x 1 device = a 2-device global mesh)
    env["XLA_FLAGS"] = ""
    env.pop("JAX_PLATFORMS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(i), "2", SCENE, str(W), str(H), str(SPP), out],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            cwd=os.path.dirname(os.path.dirname(worker)),
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=560) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]

    mh = np.load(out)

    # single-process reference (this process: unsharded fast engine)
    import jax

    from kajo_tpu.models.wavefront import render_pass_fast

    from kajo_tpu.scene import parser

    scene = parser.load(SCENE, W / H)
    # render_distributed uses fold_in(key, pass_index) per pass
    k0 = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    single = np.asarray(render_pass_fast(scene, k0, W, H, SPP))
    assert mh.shape == single.shape
    np.testing.assert_allclose(mh, single, rtol=1e-5, atol=1e-6)


def test_initialize_no_cluster_is_noop():
    """No cluster spec/env: initialize() must leave the session single-process
    (and not hide real errors behind a bare except — see multihost.py)."""
    import jax

    from kajo_tpu.parallel import multihost

    multihost.initialize()
    assert jax.process_count() == 1
