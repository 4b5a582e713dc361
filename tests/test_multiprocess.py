"""True multi-process distributed execution.

Spawns two OS processes, each with ONE local CPU device, connected via
jax.distributed.initialize (localhost coordinator). The 'rays' mesh spans
both processes, so sharded_cir's psum runs as a real cross-process
collective — the same code path a multi-host run executes.

The result must match a single-process run of the identical workload
(allclose: the two partial histograms sum in a different f32 order).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multiproc_worker.py")
SOLVER_WORKER = os.path.join(REPO, "scripts", "multiproc_solver_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_cir_matches_single(tmp_path):
    # No pytest-timeout plugin in the image; the communicate(timeout=240)
    # below is the real hang guard.
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # The workers pin their own platform/device count; scrub the test
    # session's fake-device flags so each process gets exactly one device.
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"

    outs = [str(tmp_path / f"ir{i}.npy") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, "2", str(i), outs[i]],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        logs.append(out)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i]}"

    ir0 = np.load(outs[0])
    ir1 = np.load(outs[1])
    # Replicated output: both processes hold the complete psum'd IR.
    np.testing.assert_allclose(ir0, ir1, rtol=0, atol=0)

    # Single-process reference of the identical workload.
    import jax
    import jax.numpy as jnp

    from rfx import sampler
    from rfx.geometry import make_room
    from rfx.parallel import make_mesh, sharded_cir
    from rfx.tracer import Scene

    scene = Scene.from_mesh(make_room())
    dirs = sampler.morton_sphere_directions(jax.random.PRNGKey(0), 4096)
    mesh = make_mesh({"rays": 2}, jax.devices("cpu")[:2])
    ir_ref = np.asarray(
        sharded_cir(
            scene,
            jnp.asarray([3.0, 2.0, 2.0], jnp.float32),
            dirs,
            jnp.asarray([-8.0, -5.0, 3.0], jnp.float32),
            1.0,
            mesh,
            max_bounces=3,
            nbins=2000,
            sample_rate_hz=10e9,
            rx_mode="analytic",
        )
    )
    assert ir0.sum() > 0, "multi-process trace captured nothing"
    np.testing.assert_allclose(ir0, ir_ref, rtol=1e-5, atol=1e-12)


def test_two_process_inverse_solve_step(tmp_path):
    """One full inverse-solve training step (the dryrun_multichip workload)
    over 2 processes x 4 local CPU devices: the {'rays': 4, 'rx': 2} mesh
    spans the process boundary, so the per-step IR psum over 'rays' and loss
    psum over 'rx' run as real cross-process collectives. Both processes must agree on the updated params bit-for-bit,
    and the result must match a single-process 8-fake-device run."""
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"

    outs = [str(tmp_path / f"step{i}.npy") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, SOLVER_WORKER, coord, "2", str(i), outs[i]],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        logs.append(out)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"solver worker {i} failed:\n{logs[i]}"

    s0 = np.load(outs[0])
    s1 = np.load(outs[1])
    # Replicated step output: identical updated params + loss on both hosts.
    np.testing.assert_array_equal(s0, s1)
    assert np.all(np.isfinite(s0)) and s0[-1] > 0  # finite params, nonzero loss

    # Single-process reference (8 fake devices in-process, same mesh shape).
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from oracle import sample_sphere_directions
    from rfx.geometry import make_room
    from rfx.parallel import make_mesh
    from rfx.solver import make_inverse_solver
    from rfx.tracer import Scene

    if len(jax.devices("cpu")) < 8:
        pytest.skip("needs 8 fake CPU devices (conftest sets the XLA flag)")
    mesh = make_mesh({"rays": 4, "rx": 2}, jax.devices("cpu")[:8])
    scene = Scene.from_mesh(make_room())
    dirs = jnp.asarray(sample_sphere_directions(512, seed=0))
    rx_centers = jnp.asarray(
        np.stack([np.linspace(-10, 10, 8), np.zeros(8), np.full(8, 5.0)], axis=1),
        jnp.float32,
    )
    dirs = jax.device_put(dirs, NamedSharding(mesh, P("rays")))
    rx_centers = jax.device_put(rx_centers, NamedSharding(mesh, P("rx")))
    init_fn, step_fn = make_inverse_solver(
        scene, dirs, rx_centers, 1.0, jnp.zeros((8,), jnp.float32),
        max_bounces=2, nbins=256, sample_rate_hz=10e9, mesh=mesh,
    )
    params, opt_state = init_fn(tx0=[5.0, 0.0, 5.0])
    params, _, loss = step_fn(params, opt_state)
    ref = np.concatenate([
        np.asarray(jax.device_get(params.tx_pos)).ravel(),
        [float(jax.device_get(params.log_n1))],
        [float(jax.device_get(loss))],
    ])
    np.testing.assert_allclose(s0, ref, rtol=1e-5, atol=1e-10)
