"""chip_smoke.py rehearsed on the CPU: every phase at tiny sizes (the GPU
kernel through its interpreter), and the script's refusal to run without a
GPU. The full-size run happens on the card: `python chip_smoke.py`."""

import os
import subprocess
import sys

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("phase", list(chip_smoke.ONE_CARD))
def test_one_card_phase_tiny_cpu(phase):
    assert chip_smoke.ONE_CARD[phase](chip_smoke.TINY)


@pytest.mark.parametrize("phase", list(chip_smoke.FOUR_CARDS))
def test_four_card_phase_tiny_cpu(phase):
    assert chip_smoke.FOUR_CARDS[phase](chip_smoke.TINY)


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr
