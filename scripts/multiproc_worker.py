"""Worker for the 2-process jax.distributed CPU test (tests/test_multiprocess.py).

Each process owns one CPU device; the 'rays' mesh spans both processes, so the
psum inside sharded_cir crosses process boundaries — a real multi-host
collective execution of the code path a multi-host run takes (SURVEY.md 2.3
multi-host runtime).

Usage: python multiproc_worker.py <coordinator> <num_procs> <proc_id> <out.npy>
"""
import sys

import numpy as np

coordinator, num_procs, proc_id, out_path = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 1)

# Must run before ANY backend-initialising JAX call — importing rfx builds
# jnp constants at module scope, so initialize first, import rfx after.
jax.distributed.initialize(
    coordinator_address=coordinator, num_processes=num_procs, process_id=proc_id
)

from rfx.parallel import make_mesh, sharded_cir

import jax.numpy as jnp

from rfx import sampler
from rfx.geometry import make_room
from rfx.tracer import Scene

assert jax.process_count() == num_procs, jax.process_count()
assert len(jax.devices()) == num_procs, jax.devices()

scene = Scene.from_mesh(make_room())
n = 4096
dirs = sampler.morton_sphere_directions(jax.random.PRNGKey(0), n)
mesh = make_mesh({"rays": num_procs})

ir = sharded_cir(
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
# out_specs=P() -> fully replicated; every process holds the complete IR.
local = np.asarray(jax.device_get(ir))
np.save(out_path, local)
print(f"proc {proc_id}: ir sum {local.sum():.6e}", flush=True)
