"""Worker process for the two-process multi-host test (test_multihost.py).

Run as:  python tests/_multihost_worker.py PORT PROCESS_ID NUM_PROCESSES \
             SCENE WIDTH HEIGHT SPP OUT.npy

Joins the process group via kajo_tpu.parallel.multihost.initialize (the real
entry under test — it must run BEFORE any backend touch), renders the scene
across all processes' devices, and (on process 0) saves the assembled image.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    port, pid, nproc = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    scene_path, w, h, spp = sys.argv[4], int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7])
    out = sys.argv[8]

    import jax

    # stay on the CPU even where JAX has a CUDA backend; set through
    # jax.config before ANY backend use (tests/conftest.py)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)

    from kajo_tpu.parallel import multihost

    # the call under test: joins the group before any backend init
    multihost.initialize(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.process_index() == pid

    import numpy as np

    from kajo_tpu.scene import parser

    scene = parser.load(scene_path, w / h)
    img = multihost.render_distributed(scene, w, h, spp, jax.random.PRNGKey(0), passes=1)
    if pid == 0:
        assert img is not None
        np.save(out, img)
    else:
        assert img is None


if __name__ == "__main__":
    main()
