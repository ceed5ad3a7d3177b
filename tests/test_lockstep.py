"""RNG-tape lockstep validation against the reference estimator.

Builds the tape recorder (the reference's own Shader with a generate() hook),
records a few hundred samples' exact rays + uniform draws + radiances, and
replays them through our estimator math (tools/lockstep.py). Per-sample
agreement to ~1e-4 relative validates every MIS weight, Russian-roulette
factor and lottery division exactly — no Monte-Carlo noise floor involved
(SURVEY.md §7.4 hard-part 2b; spec cpu/Shader.cpp:50-215).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

from conftest import CAUSTICS, REPO

DRIVER = os.path.join(REPO, "tools", "tape_driver")


@pytest.fixture(scope="module")
def tape_driver():
    if not os.path.exists(DRIVER):
        r = subprocess.run(
            ["bash", os.path.join(REPO, "tools", "build_tape_driver.sh")],
            capture_output=True,
            timeout=300,
        )
        if r.returncode != 0:
            pytest.skip(f"tape driver build failed: {r.stderr.decode()[-500:]}")
    return DRIVER


def _run_lockstep(tape_driver, scene_path, n_pixels=40, spp=4, seed=123):
    from lockstep import LockstepIntegrator, parse_tape

    from kajo_tpu.scene import parser

    out = subprocess.run(
        [tape_driver, scene_path, "64", "48", str(spp), str(n_pixels), str(seed)],
        capture_output=True,
        timeout=300,
        check=True,
    )
    samples = parse_tape(out.stdout.decode())
    assert len(samples) == n_pixels * int(spp**0.5) ** 2
    scene = parser.load(scene_path, 64 / 48)
    integ = LockstepIntegrator(scene)
    return integ.replay(samples)


def _gate(ours, theirs, leftover, frac=0.97, tol=1e-3):
    # exclude samples where the reference itself produced non-finite radiance
    # (its exponent-0 backface-mirror divide-by-zero bug)
    finite = np.isfinite(theirs[:, :3]).all(axis=1)
    o, t = ours[finite, :3], theirs[finite, :3]
    denom = np.maximum(np.abs(t), 1e-3)
    rel = np.max(np.abs(o - t) / denom, axis=1)
    match = rel < tol
    # every consumed uniform accounted for on matching samples
    assert (leftover[finite][match] == 0).all(), "uniform stream desynchronized"
    frac_ok = match.mean()
    assert frac_ok >= frac, (
        f"only {frac_ok:.1%} of samples matched (worst rel {np.sort(rel)[-5:]})"
    )
    return frac_ok, rel


def test_lockstep_diffuse_scene(tape_driver, tmp_path):
    """Lambert + one light (caustics.json with every non-emissive sphere made
    diffuse) — the full NEE/MIS/RR math, per path."""
    import json

    with open(CAUSTICS) as f:
        scene = json.load(f)
    for obj in scene["objects"]:
        if obj["type"] == "sphere" and "emission" not in obj:
            for k in ("specular", "specularExponent", "transparency", "refractiveIndex"):
                obj.pop(k, None)
            obj["diffuse"] = "#b84"
    path = tmp_path / "diffuse.json"
    path.write_text(json.dumps(scene))
    ours, theirs, leftover = _run_lockstep(tape_driver, str(path))
    frac, rel = _gate(ours, theirs, leftover, frac=0.97, tol=1e-3)
    # the typical sample should agree far tighter than the gate
    assert np.median(rel) < 2e-5, np.median(rel)


def test_lockstep_spheres_scene(tape_driver):
    """caustics.json: adds Phong lobes, an ideal mirror and refraction."""
    ours, theirs, leftover = _run_lockstep(tape_driver, CAUSTICS, n_pixels=60)
    frac, rel = _gate(ours, theirs, leftover, frac=0.93, tol=1e-3)
    assert np.median(rel) < 5e-5, np.median(rel)


def test_lockstep_scaled_scene(tape_driver):
    """data/scaled.json: NON-RIGID sphere transforms (uniform scales 0.5-2
    plus a rotation) — per-sample validation that our general object-space
    layout replicates the reference's determinant-scaled hit distances
    (Raytracer.cpp:70) EXACTLY, including their effect on nearest-hit
    ordering, NEE visibility and MIS weights. The statistical golden gates
    can't see a det-semantics slip this small; the tape can."""
    scene_path = os.path.join(REPO, "data", "scaled.json")
    ours, theirs, leftover = _run_lockstep(tape_driver, scene_path, n_pixels=50)
    frac, rel = _gate(ours, theirs, leftover, frac=0.95, tol=1e-3)
    assert np.median(rel) < 5e-5, np.median(rel)
