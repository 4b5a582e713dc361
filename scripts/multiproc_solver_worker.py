"""Worker for the 2-process x 4-device inverse-solve test: each OS process owns FOUR local CPU devices; the {'rays': 4,
'rx': 2} mesh spans both processes, so one full training step (trace ->
soft-binned coverage IRs -> loss -> grads -> adam update) runs its IR psum
over 'rays' and loss psum over 'rx' ACROSS the process boundary — the
dryrun_multichip workload executed as a real multi-host collective.

Usage: python multiproc_solver_worker.py <coordinator> <num_procs> <proc_id> <out.npy>
"""
import sys

import numpy as np

coordinator, num_procs, proc_id, out_path = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)

# Must run before ANY backend-initialising JAX call (rfx builds jnp constants
# at module scope).
jax.distributed.initialize(
    coordinator_address=coordinator, num_processes=num_procs, process_id=proc_id
)

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from oracle import sample_sphere_directions
from rfx.geometry import make_room
from rfx.parallel import make_mesh
from rfx.solver import make_inverse_solver
from rfx.tracer import Scene

assert jax.process_count() == num_procs, jax.process_count()
assert len(jax.devices()) == 4 * num_procs, jax.devices()

mesh = make_mesh({"rays": 2 * num_procs, "rx": 2})
scene = Scene.from_mesh(make_room())
n_rays = 512
dirs = jnp.asarray(sample_sphere_directions(n_rays, seed=0))
rx_centers = jnp.asarray(
    np.stack([np.linspace(-10, 10, 8), np.zeros(8), np.full(8, 5.0)], axis=1),
    jnp.float32,
)
dirs = jax.device_put(dirs, NamedSharding(mesh, P("rays")))
rx_centers = jax.device_put(rx_centers, NamedSharding(mesh, P("rx")))
target = jnp.zeros((8,), jnp.float32)

init_fn, step_fn = make_inverse_solver(
    scene, dirs, rx_centers, 1.0, target,
    max_bounces=2, nbins=256, sample_rate_hz=10e9, mesh=mesh,
)
params, opt_state = init_fn(tx0=[5.0, 0.0, 5.0])
params, opt_state, loss = step_fn(params, opt_state)
tx = np.asarray(jax.device_get(params.tx_pos)).ravel()
out = np.concatenate([
    tx,
    [float(jax.device_get(params.log_n1))],
    [float(jax.device_get(loss))],
]).astype(np.float64)
np.save(out_path, out)
print(f"proc {proc_id}: loss {out[-1]:.6e} tx {tx}", flush=True)
