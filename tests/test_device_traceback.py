"""Device-side traceback walk parity (ops/sw_global.traceback_device).

The (tmax, qmax, B) direction tensor stays on the device and only a
per-step op stream comes back to the host.  The walk must be step-identical to the host `traceback`
(ksw.c:588-602 semantics), including the quirk that the raw 2-bit read
(even value 3) becomes the next step's shift state.
"""

import os

import numpy as np
import pytest

from arachne_tpu.config import MemOptions
from arachne_tpu.ops.sw_global import BatchGlobal


@pytest.fixture(autouse=True)
def _restore_env():
    old = os.environ.get("ARACHNE_DEVICE_TB")
    yield
    if old is None:
        os.environ.pop("ARACHNE_DEVICE_TB", None)
    else:
        os.environ["ARACHNE_DEVICE_TB"] = old


def _gapped_problems(rng, n, opt):
    out = []
    for _ in range(n):
        t = rng.integers(0, 4, int(rng.integers(60, 300))).astype(np.int8)
        q = list(t[5 : 5 + int(rng.integers(40, min(180, len(t) - 10)))])
        for _ in range(int(rng.integers(0, 3))):
            j = int(rng.integers(1, len(q) - 1))
            r = rng.random()
            if r < 0.4:
                del q[j]
            elif r < 0.8:
                q.insert(j, int(rng.integers(0, 4)))
            else:
                q[j] = (q[j] + 1) % 4
        out.append((np.array(q, np.int8), t, opt.w))
    return out


def _run(problems, opt, flag):
    os.environ["ARACHNE_DEVICE_TB"] = flag
    bg = BatchGlobal(opt)
    bg.CHUNK_Z = 64  # multiple chunks + padding edge cases
    for q, t, w in problems:
        bg.submit(q, t, w)
    return bg.run()


def test_device_traceback_matches_host_walk(rng):
    opt = MemOptions()
    problems = _gapped_problems(rng, 200, opt)
    host = _run(problems, opt, "0")
    dev = _run(problems, opt, "1")
    assert host == dev
    # the fixture genuinely exercises gaps
    gapped = sum(1 for _s, c in host if c is not None and any(op in (1, 2) for op, _n in c))
    assert gapped >= 50


def test_device_traceback_narrow_band_and_tiny(rng):
    opt = MemOptions()
    problems = []
    for _ in range(40):
        t = rng.integers(0, 4, int(rng.integers(8, 40))).astype(np.int8)
        q = t[: max(4, len(t) - int(rng.integers(0, 4)))].copy()
        problems.append((q, t, int(rng.integers(1, 4))))  # tight bands
    host = _run(problems, opt, "0")
    dev = _run(problems, opt, "1")
    assert host == dev
