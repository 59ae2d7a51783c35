import os

# Tests always run on CPU with a virtual 8-device mesh for sharding tests
# (GPU runs are chip_smoke.py's job).
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

# Parity oracles: /root/refbin lives outside the repo and is wiped
# between rounds; rebuild from /root/reference on first use so a fresh
# environment doesn't fail every parity test with FileNotFoundError.
if not os.path.exists("/root/refbin/syncasm"):
    import subprocess as _sp

    _script = os.path.join(os.path.dirname(__file__), "..", "tools", "build_refbin.sh")
    try:
        _sp.run(["bash", _script], check=True, capture_output=True, timeout=600)
    except Exception:
        pass  # individual tests will report the missing oracle


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def random_read(rng, L, hp_prob=0.1, n_prob=0.0):
    bases = rng.choice(list("ACGT"), size=L)
    out = []
    for b in bases:
        out.append(b)
        if rng.random() < hp_prob:
            out.extend([b] * rng.integers(1, 6))
    seq = np.array(out)
    if n_prob > 0:
        seq[rng.random(len(seq)) < n_prob] = "N"
    return "".join(seq)
