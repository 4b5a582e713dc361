"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; sharding correctness is validated
on fake CPU devices per SURVEY.md section 4 ("Distributed without a cluster").
Must run before the first `import jax` anywhere in the test session.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

# Force CPU even when a GPU is visible: the tests validate semantics and
# sharding on fake CPU devices. Tests that need the card are marked `gpu`
# and skip; chip_smoke.py runs their checks on the card.
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from rfx.geometry import TriangleMesh, load_stl, make_room

REFERENCE_MODELS = "/root/reference/models"


@pytest.fixture(scope="session")
def room_mesh() -> TriangleMesh:
    """The reference's room scene if the read-only mirror is present,
    otherwise the procedural equivalent."""
    path = os.path.join(REFERENCE_MODELS, "room.stl")
    if os.path.exists(path):
        return load_stl(path)
    return make_room()


@pytest.fixture(scope="session")
def box_room() -> TriangleMesh:
    """Plain open box room (the reference room.stl contains an interior
    dividing wall; geometric tests want a predictable empty box)."""
    return make_room()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
