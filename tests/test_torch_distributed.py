"""The port's multi-process dispatch (``parallel/distributed.py``), as
``tests/test_distributed.py`` holds the JAX package's: two OS processes
join a ``torch.distributed`` gloo group over local TCP, each computes its
share of a batch on two local CPU shards, and every process must end up
with the whole batch; the single-process API degenerates to a (1, n)
mesh; and the self-test runs with ``jax`` and the JAX package blocked."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from audio_suite_torch.parallel import distributed as D

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    # a host that cannot resolve its own name: gloo binds to loopback
    return dict(os.environ, GLOO_SOCKET_IFNAME="lo",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))


def _run_workers(tmp_path, n: int, prelude: str = "") -> list:
    coord = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"p{i}.json") for i in range(n)]
    run = ["-m", "audio_suite_torch.parallel.distributed"]
    if prelude:
        run = ["-c", prelude + "import runpy\nrunpy.run_module("
               "'audio_suite_torch.parallel.distributed', "
               "run_name='__main__')\n"]
    procs = [subprocess.Popen(
        [sys.executable, *run, coord, str(n), str(i), outs[i], "cpu"],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(n)]
    results = []
    try:
        for p, out in zip(procs, outs):
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, f"rc={p.returncode}\n{stdout}\n{stderr}"
            with open(out) as f:
                results.append(json.load(f))
    finally:
        for p in procs:          # a hung worker must not outlive the test
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def test_two_process_gloo_batch_dispatch(tmp_path):
    results = _run_workers(tmp_path, 2)
    for r in results:
        assert r["ok"], r
        assert r["process_count"] == 2
        assert r["global_devices"] == 4
        assert r["mesh_shape"] == [2, 2]
        assert r["batch"] == 8 and r["device"] == "cpu"
        assert r["max_err"] < 1e-4
        assert r["mix_err"] < 1e-3
    assert {r["process_id"] for r in results} == {0, 1}


def test_single_process_distributed_api_degenerates():
    """The same API in one process with no group: a (1, n_local) mesh and
    the whole batch back."""
    mesh = D.make_global_mesh(devices=["cpu"] * 4)
    assert mesh.devices.shape == (1, 4)
    assert mesh.axis_names == ("dp_host", "dp_chip")
    amps = np.linspace(0.1, 1.0, 2 * mesh.devices.size).astype(np.float32)
    got = D.distributed_batch_render(
        lambda a: a * torch.ones(16, dtype=torch.float32), (amps,), mesh)
    assert got.shape == (len(amps), 16)
    assert np.allclose(got, amps[:, None], atol=1e-7)


def test_selftest_runs_with_jax_blocked(tmp_path):
    prelude = ("import sys\n"
               "sys.modules['jax'] = None\n"
               "sys.modules['audio_suite_tpu'] = None\n")
    (r,) = _run_workers(tmp_path, 1, prelude)
    assert r["ok"] and r["process_count"] == 1 and r["mesh_shape"] == [1, 2]
