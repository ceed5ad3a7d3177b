"""CLI end-to-end: render, save, checkpoint/resume, engine selection."""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import CAUSTICS, REPO


def run_cli(args, timeout=300):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    return subprocess.run(
        [sys.executable, "-m", "kajo_tpu.cli", "--platform", "cpu", *args],
        capture_output=True,
        text=True,
        timeout=timeout,
        cwd=REPO,
        env=env,
    )


def test_render_and_save(tmp_path):
    out = tmp_path / "out.png"
    r = run_cli(["-w", "32", "-h", "24", "--spp", "4", "--passes", "2", "-o", str(out),
                 CAUSTICS])
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists()
    from kajo_tpu.utils.image import load_png

    img = load_png(str(out))
    assert img.shape == (24, 32, 4)
    assert img[..., :3].mean() > 5  # not black
    assert "samples/s" in r.stderr


def test_builtin_test_scene(tmp_path):
    out = tmp_path / "t.png"
    r = run_cli(["-w", "16", "-h", "12", "--spp", "4", "--passes", "1", "-o", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists()


def test_procedural_scene(tmp_path):
    """--procedural N renders the big-scene scaling config from the CLI
    (scene JSONs cannot express it); --scale-jitter takes the non-rigid
    general trace layout."""
    out = tmp_path / "p.png"
    r = run_cli(["-w", "24", "-h", "18", "--spp", "4", "--passes", "1",
                 "--procedural", "200", "--scale-jitter", "0.4", "-o", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    from kajo_tpu.utils.image import load_png

    img = load_png(str(out))
    assert img.shape == (18, 24, 4)
    assert img[..., :3].mean() > 1  # not black


def test_checkpoint_resume(tmp_path):
    out = tmp_path / "c.png"
    ck = tmp_path / "state.npz"
    r1 = run_cli(["-w", "16", "-h", "12", "--spp", "4", "--passes", "2",
                  "-o", str(out), "--checkpoint", str(ck),
                  CAUSTICS])
    assert r1.returncode == 0, r1.stderr[-2000:]
    assert ck.exists()
    data = np.load(ck)
    assert int(data["passes"]) == 2
    r2 = run_cli(["-w", "16", "-h", "12", "--spp", "4", "--passes", "1",
                  "-o", str(out), "--checkpoint", str(ck), "--resume",
                  CAUSTICS])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed" in r2.stderr
    assert int(np.load(ck)["passes"]) == 3


def test_checkpoint_mismatch_refused(tmp_path):
    """Resuming with a different config must not blend unrelated renders."""
    out = tmp_path / "m.png"
    ck = tmp_path / "state.npz"
    r1 = run_cli(["-w", "16", "-h", "12", "--spp", "4", "--passes", "1",
                  "-o", str(out), "--checkpoint", str(ck),
                  CAUSTICS])
    assert r1.returncode == 0, r1.stderr[-2000:]
    # different seed -> refuse the checkpoint, start fresh
    r2 = run_cli(["-w", "16", "-h", "12", "--spp", "4", "--passes", "1",
                  "--seed", "9", "-o", str(out), "--checkpoint", str(ck), "--resume",
                  CAUSTICS])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "does not match" in r2.stderr
    assert "resumed" not in r2.stderr
    assert int(np.load(ck)["passes"]) == 1


def test_bad_scene_path_fails():
    r = run_cli(["/nonexistent/scene.json", "--passes", "1"])
    assert r.returncode != 0


def test_help_lists_reference_flags():
    r = run_cli(["--help"])
    assert r.returncode == 0
    for flag in ("-w", "-h", "-r", "--spp", "--engine", "--full-mis"):
        assert flag in r.stdout


def test_shard_objects_flag(tmp_path):
    out = tmp_path / "so.png"
    r = run_cli(["-w", "16", "-h", "12", "--spp", "4", "--passes", "1",
                 "--shard-objects", "-o", str(out),
                 CAUSTICS])
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists()


def test_preview_keys_esc_stops_and_saves(tmp_path):
    """ESC on the controlling terminal ends the progressive loop early
    (Preview.cpp:216-234 translation); the accumulated image is still saved.
    Driven through a real pty so stdin.isatty() is true in the child."""
    import pty
    import time

    out = tmp_path / "esc.png"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    master, slave = pty.openpty()
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kajo_tpu.cli", "--platform", "cpu",
             "-w", "16", "-h", "12", "--spp", "4", "--passes", "0",
             "-o", str(out), CAUSTICS],
            stdin=slave,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
            cwd=REPO,
            env=env,
            text=True,
        )
        os.close(slave)
        slave = -1
        # keys typed BEFORE the loop enters cbreak mode sit in the pty's
        # canonical line buffer and never arrive — wait for the first pass
        # line (the poller is active by then), like a real user would
        err_lines = []
        deadline = time.time() + 200
        while time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            err_lines.append(line)
            if line.startswith("pass "):
                break
        else:
            proc.kill()
            raise AssertionError("no pass line seen:\n" + "".join(err_lines)[-2000:])
        os.write(master, b"s")  # save-key while running
        os.write(master, b"\x1b")  # ESC: stop (--passes 0 = run forever)
        try:
            _, err_rest = proc.communicate(timeout=120)
            err = "".join(err_lines) + err_rest
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err_rest = proc.communicate()
            err = "".join(err_lines) + err_rest
            raise AssertionError("ESC did not stop the render loop:\n" + err[-2000:])
    finally:
        os.close(master)
        if slave >= 0:
            os.close(slave)
    assert proc.returncode == 0, err[-2000:]
    assert "ESC: stopping" in err, err[-2000:]
    assert "(keypress)" in err, err[-2000:]
    assert out.exists()
