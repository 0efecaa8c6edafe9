"""Worlds of the port's CLI (``python -m tpurt_torch ... --multihost``)
on the CPU over gloo, each rank a subprocess, mirroring
tests/distributed/test_multihost.py. No process group starts in the test
process itself: ``torch.distributed`` state is process-global.

Every world runs under a wall-clock limit and is killed when it runs
out, so a hung collective fails its test instead of the suite. A sharded
render's accumulation equals the single-device render of the same sample
window bit for bit; only rank 0 writes files.
"""

import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpurt_torch.cli import main
from tpurt_torch.render.png import read_png

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 120
FRAME = ["--config", "cornell_pt", "--width", "40", "--height", "24",
         "--spp", "2", "--spp-per-batch", "1", "--max-bounces", "1", "--cpu"]


def reserve_port() -> socket.socket:
    """A socket bound to a free port (SO_REUSEADDR, not listening): the
    port stays out of every other bind until it is closed, while rank 0's
    store can still bind it."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("localhost", 0))
    return s


def child_env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)


def run_bounded(cmd, cwd):
    """``cmd`` in a session of its own, killed with every process it
    started when LIMIT_S runs out: (exit code, stdout, stderr)."""
    p = subprocess.Popen(cmd, cwd=cwd, env=child_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=LIMIT_S)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    return p.returncode, out, err


def run_world(argv_of_rank, n: int, cwd):
    """Ranks 0..n-1 of ``python -m tpurt_torch`` joined through a
    coordinator on a free port; [(exit code, output)] in rank order. The
    whole world is killed when LIMIT_S runs out."""
    held = reserve_port()
    port = held.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpurt_torch", *argv_of_rank(i),
         "--multihost", "--coordinator", f"localhost:{port}",
         "--num-processes", str(n), "--process-id", str(i)],
        cwd=cwd, env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(n)]
    try:
        outs = [p.communicate(timeout=LIMIT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
        held.close()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _accum(path):
    with np.load(path) as z:
        return z["accum"], int(z["n_samples"])


CHILD = """
import sys
from tpurt_torch.parallel import init_multihost

port, out = sys.argv[1], sys.argv[2]
assert init_multihost(f"localhost:{port}", num_processes=1, process_id=0,
                      device="cpu") == (0, 1)
assert init_multihost() == (0, 1)  # a second call is a no-op

from tpurt_torch.cli import main
assert main(["render", "--config", "cornell", "--width", "32", "--height",
             "24", "--spp", "1", "--cpu", "--multihost", "--coordinator",
             f"localhost:{port}", "--num-processes", "1", "--process-id",
             "0", "--out", out]) == 0
print("MULTIHOST_OK")
"""


def test_multihost_single_process(tmp_path):
    out = str(tmp_path / "mh.png")
    with reserve_port() as held:
        _, stdout, stderr = run_bounded(
            [sys.executable, "-c", CHILD, str(held.getsockname()[1]), out],
            REPO)
    assert "MULTIHOST_OK" in stdout, (stdout, stderr[-2000:])
    assert "multihost: process 0/1 (backend gloo)" in stdout
    assert read_png(out).shape == (24, 32, 3)


@pytest.mark.parametrize("pipeline,single", [
    ("staged", "staged"), ("mega", "mega"), ("wavefront", "mega")])
def test_world_2x2_render_equals_single(tmp_path, pipeline, single):
    """Four ranks, 2 sample × 2 tile shards: rank 0's checkpoint holds the
    single-device render of the same window (two batches of one sample)
    bit for bit; the other ranks write nothing. Under a mesh the
    wavefront pipeline runs the megakernel's shards, as in the reference,
    so it is held to the megakernel's render."""
    def argv(i):
        return ["render", *FRAME, "--pipeline", pipeline, "--sample-shards",
                "2", "--tile-shards", "2", "--out", f"w{i}.png",
                "--checkpoint", f"w{i}.npz"]

    res = run_world(argv, 4, tmp_path)
    for i, (rc, out) in enumerate(res):
        assert rc == 0, out[-3000:]
        assert f"multihost: process {i}/4 (backend gloo)" in out
    assert sorted(os.listdir(tmp_path)) == ["w0.npz", "w0.png"]
    assert main(["render", *FRAME, "--pipeline", single, "--out",
                 str(tmp_path / "s.png"), "--checkpoint",
                 str(tmp_path / "s.npz")]) == 0
    (a, na), (b, nb) = _accum(tmp_path / "w0.npz"), _accum(tmp_path / "s.npz")
    assert na == nb == 2
    np.testing.assert_array_equal(a, b)


def test_world_animate_tile_shards(tmp_path):
    """``animate`` on two tile shards: rank 0 writes every frame, equal
    to a single process's, and rank 1 none."""
    args = [*FRAME, "--config", "cornell", "--frames", "2",
            "--tile-shards", "2"]
    res = run_world(lambda i: ["animate", *args, "--out-dir", f"f{i}"], 2,
                    tmp_path)
    for rc, out in res:
        assert rc == 0, out[-3000:]
    assert not os.path.exists(tmp_path / "f1")
    assert main(["animate", *args[:-2], "--out-dir",
                 str(tmp_path / "s")]) == 0
    for k in range(2):
        name = f"frame_{k:04d}.png"
        np.testing.assert_array_equal(read_png(str(tmp_path / "f0" / name)),
                                      read_png(str(tmp_path / "s" / name)))


def test_torchrun_world(tmp_path):
    """torchrun's environment (``env://``) in place of a coordinator."""
    rc, stdout, stderr = run_bounded(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "tpurt_torch", "render", *FRAME,
         "--multihost", "--tile-shards", "2", "--out", "t.png",
         "--checkpoint", "t.npz"], tmp_path)
    assert rc == 0, (stdout[-2000:], stderr[-3000:])
    assert main(["render", *FRAME, "--out", str(tmp_path / "s.png"),
                 "--checkpoint", str(tmp_path / "s.npz")]) == 0
    np.testing.assert_array_equal(_accum(tmp_path / "t.npz")[0],
                                  _accum(tmp_path / "s.npz")[0])


@pytest.mark.cuda
def test_world_on_the_card(tmp_path):
    """Two sample shards of the bunny on cuda:0 (two ranks on one card
    take gloo): rank 0's accumulation equals this process's render on the
    card of the same window. Runs where there is a card
    (``python3 -m pytest --noconftest -q tests/test_torch_multihost.py``
    on the H100; this file imports neither jax nor tpurt)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch finds none)")
    frame = ["--config", "bunny", "--width", "160", "--height", "120",
             "--spp", "2", "--spp-per-batch", "1", "--max-bounces", "2"]
    # the single render first: it builds the kernel library the ranks load
    assert main(["render", *frame, "--out", str(tmp_path / "s.png"),
                 "--checkpoint", str(tmp_path / "s.npz")]) == 0
    res = run_world(lambda i: ["render", *frame, "--sample-shards", "2",
                               "--out", f"w{i}.png", "--checkpoint",
                               f"w{i}.npz"], 2, tmp_path)
    for i, (rc, out) in enumerate(res):
        assert rc == 0, out[-3000:]
        assert f"multihost: process {i}/2 (backend gloo)" in out
    np.testing.assert_array_equal(_accum(tmp_path / "w0.npz")[0],
                                  _accum(tmp_path / "s.npz")[0])


def test_world_with_a_failing_rank_fails_fast(tmp_path):
    """A rank that raises (its scene file is missing) fails its world:
    every rank exits nonzero well inside the limit; none hangs in a
    collective."""
    def argv(i):
        scene = "missing.obj" if i == 1 else "cornell_pt"
        return ["render", *FRAME, "--config", scene, "--tile-shards", "2",
                "--out", f"x{i}.png"]

    res = run_world(argv, 2, tmp_path)
    assert all(rc not in (0, None) for rc, _ in res), res
    assert "missing.obj" in res[1][1]
    assert not os.path.exists(tmp_path / "x0.png")
