"""Multi-process bring-up: the real `jax.distributed` path
(parallel/mesh.py::init_distributed) executed with two OS processes
and a localhost coordinator — cross-process collectives ride Gloo on
the CPU here, the same code path that rides NCCL across GPU hosts.
The reference has no distributed anything (SURVEY section 2.4); this
is the framework's multi-process bring-up test."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    port, pid = sys.argv[1], int(sys.argv[2])
    from dj_brdf_tpu.parallel.mesh import (DATA_AXIS, init_distributed,
                                           make_mesh)
    init_distributed(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 2, jax.device_count()

    # global mesh spanning both processes' devices; psum a sharded
    # value through jit (XLA inserts the cross-process collective)
    mesh = make_mesh()
    data_s = NamedSharding(mesh, P(DATA_AXIS))
    repl_s = NamedSharding(mesh, P())
    local = np.full((4,), float(pid + 1), np.float32)
    arr = jax.make_array_from_process_local_data(data_s, local, (8,))
    total = float(jax.jit(jnp.sum, out_shardings=repl_s)(arr))
    assert abs(total - 12.0) < 1e-6, total

    # one REAL data-parallel fit gradient: batch sharded across the
    # two processes, replicated params, pjit-inserted gradient psum
    # (the product path of fit.lsq under a multi-host mesh)
    from dj_brdf_tpu.core.math import from_spherical
    from dj_brdf_tpu.fit import lsq
    from dj_brdf_tpu.microfacet.ndf import GGX

    n_local = 8
    th = np.linspace(0.1, 1.4, n_local, dtype=np.float32) + 0.01 * pid
    i_l = np.asarray(from_spherical(jnp.asarray(th),
                                    jnp.asarray(th * 2.0)))
    o_l = np.asarray(from_spherical(jnp.asarray(th[::-1].copy()),
                                    jnp.asarray(th * 3.0)))
    t_l = np.abs(np.sin(th))[:, None].repeat(3, 1).astype(np.float32)
    gi = jax.make_array_from_process_local_data(data_s, i_l, (16, 3))
    go = jax.make_array_from_process_local_data(data_s, o_l, (16, 3))
    gt = jax.make_array_from_process_local_data(data_s, t_l, (16, 3))
    raw = jax.device_put(lsq.raw_init(), repl_s)
    loss = lsq.make_loss(GGX())
    val, grads = jax.jit(jax.value_and_grad(loss))(raw, gi, go, gt)
    val = float(val)
    assert np.isfinite(val), val
    g0 = float(jax.device_get(grads.log_ax))
    assert np.isfinite(g0)

    jax.distributed.shutdown()
    print(f"WORKER_OK pid={pid} total={total} loss={val:.6f} "
          f"g={g0:.6f}")
""")


def _free_port():
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    except OSError:
        return None
    finally:
        s.close()


def test_two_process_distributed_psum(tmp_path):
    port = _free_port()
    if port is None:
        pytest.skip("no localhost port available")
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)            # 1 real device per process
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out")
    for rc, out in outs:
        assert rc == 0, out[-2000:]
        assert "WORKER_OK" in out, out[-2000:]
    # both processes agree on the replicated psum result
    loss_lines = [line for _, out in outs for line in out.splitlines()
                  if line.startswith("WORKER_OK")]
    vals = {line.split("loss=")[1] for line in loss_lines}
    assert len(vals) == 1, loss_lines
