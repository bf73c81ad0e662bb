"""Multi-process distributed path: 2 processes x 2 CPU devices render the
same image as the single-process integrator, bit-identically (VERDICT
round-1 Missing #3; SURVEY.md §5 distributed backend; BASELINE multi-host
target's correctness half — efficiency is measured on real pods)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_render_matches_single(tmp_path):
    out = tmp_path / "img.npy"
    port = _free_port()
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    worker = os.path.join(os.path.dirname(__file__), "distributed_worker.py")
    procs = []
    for pid in range(2):
        env = dict(env_base,
                   PBRLAB_COORDINATOR=f"127.0.0.1:{port}",
                   PBRLAB_NUM_PROCESSES="2",
                   PBRLAB_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, worker, str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    rc = [p.wait(timeout=540) for p in procs]
    for p, r in zip(procs, rc):
        if r != 0:
            sys.stderr.write(p.stderr.read().decode(errors="replace"))
    assert rc == [0, 0]
    got = np.load(out)

    # single-process reference on this test process's CPU backend
    from pbrlab_tpu.render.integrator import render
    from pbrlab_tpu.scene.demo import build_demo_scene
    from pbrlab_tpu.scene.scene import scene_to_device

    scene_np, _ = build_demo_scene(subdiv=1, lambert_only=True)
    ref = np.asarray(render(scene_to_device(scene_np), 16, 16, 2,
                            max_steps=6))
    np.testing.assert_array_equal(got, ref)
