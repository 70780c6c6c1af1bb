"""The DP batchers at production shapes, and the device-facing rules
around them: chunking and padding, the errors a missing native library
raises on a GPU, the device memory budget, card pinning of distributed
processes, the compile-cache directory and the smoke's refusal to run
without a GPU.  chip_smoke.py repeats the batcher parity on the card.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arachne_tpu.align import ksw
from arachne_tpu.config import MemOptions
from arachne_tpu.ops import sw_extend
from arachne_tpu.ops.sw_extend import BatchExtender, pad_batch
from arachne_tpu.ops.sw_global import BatchGlobal
from arachne_tpu.ops.sw_local import BatchLocalSW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (options, problem generator settings): N bases, z-drop off, a custom
# scoring matrix, and the window edge a large seed score exposes
EXTEND_CASES = {
    "default": (MemOptions(), dict()),
    "n_bases": (MemOptions(), dict(n_rate=0.08)),
    "zdrop_off": (MemOptions(zdrop=0), dict()),
    "custom_scoring": (
        MemOptions(a=2, b=5, o_del=5, e_del=2, o_ins=4, e_ins=2, zdrop=60), dict()
    ),
    "large_h0_narrow_band": (MemOptions(), dict(h0_min=60, w_max=12)),
}


def _extension_problems(seed, n, qmax=192, tmax=512, n_rate=0.01, h0_min=1, w_max=150):
    """Seed extensions up to the production (qmax, tmax): related and
    unrelated pairs (z-drop and zero-row exits), N bases, any band."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tlen = int(rng.integers(1, tmax + 1))
        t = rng.integers(0, 4, tlen).astype(np.uint8)
        t[rng.random(tlen) < n_rate] = 4
        qlen = int(rng.integers(1, qmax + 1))
        if i % 3 == 2 or tlen < qlen:
            q = rng.integers(0, 5, qlen).astype(np.uint8)
        else:
            q = t[:qlen].copy()
            hit = rng.random(qlen) < 0.04
            q[hit] = rng.integers(0, 5, int(hit.sum()))
        w = int(rng.integers(1, w_max + 1))
        out.append((q, t, w, 5, int(rng.integers(h0_min, 200))))
    return out


def _oracle(opt, p):
    q, t, w, eb, h0 = p
    return ksw.extend2(
        q, t, opt.scoring_matrix(), opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        w, eb, opt.zdrop, h0,
    )


@pytest.mark.parametrize("case", sorted(EXTEND_CASES))
def test_xla_extension_matches_oracle_at_production_shape(case):
    opt, gen = EXTEND_CASES[case]
    probs = _extension_problems(7, 40, **gen)
    be = BatchExtender(opt)
    assert (be.qmax, be.tmax) == (192, 512)
    for p in probs:
        be.submit(*p)
    assert be.run() == [_oracle(opt, p) for p in probs]


# Two problems where the reference reads eh[] slots its window left
# untouched (A: a column re-entering right of a shrunk end reads the first
# row's H(-1, j); B: the first-column boundary left of the window must not
# feed F).  (options, query, target, w, h0) as digit strings of codes.
WINDOW_EDGES = {
    "stale_slot_right_of_end": (
        MemOptions(zdrop=0),
        "4400321034340232341004302321030211004131110432112420344220402324"
        "300134112012303123442140032333",
        "3330230130033202001230211110333312330313120001311001033122233013"
        "2311200133310101214202023001310130234103022223100321310222112210"
        "3201001333131131103212013312102200322113003200123323303001132020"
        "0133011002001013322020213010133230110310100233011002002303110321"
        "2103020123011001003213213210132",
        6, 117,
    ),
    "boundary_left_of_window": (
        MemOptions(),
        "320043004243222002222244404340",
        "2312211032200223320130123133314012013021122222242113030321030220"
        "0021131122300330101321130103321303324021122321330122031203233212"
        "2323012300320310233100003301012031100002101213303010321133020103"
        "1332212312422303211300213011333",
        7, 43,
    ),
}


@pytest.mark.parametrize("case", sorted(WINDOW_EDGES))
def test_xla_extension_window_edges_match_oracle(case):
    opt, q, t, w, h0 = WINDOW_EDGES[case]
    p = (np.array(list(q), np.uint8), np.array(list(t), np.uint8), w, 5, h0)
    be = BatchExtender(opt)
    be.submit(*p)
    assert be.run() == [_oracle(opt, p)]


@pytest.mark.parametrize("seed", [0, 1])
def test_local_matches_oracle_at_production_shape(seed):
    opt = MemOptions()
    mat = opt.scoring_matrix()
    rng = np.random.default_rng(seed)
    b = BatchLocalSW(opt)
    assert (b.qmax, b.tmax) == (192, 768)
    probs = []
    for i in range(24):
        tlen = int(rng.integers(40, 769))
        t = rng.integers(0, 4, tlen).astype(np.uint8)
        t[rng.random(tlen) < 0.02] = 4
        qlen = int(rng.integers(20, min(150, tlen) + 1))
        off = int(rng.integers(0, tlen - qlen + 1))
        q = t[off : off + qlen].copy() if i % 4 else rng.integers(0, 4, qlen).astype(np.uint8)
        hit = rng.random(qlen) < 0.03
        q[hit] = rng.integers(0, 5, int(hit.sum()))
        probs.append((q, t, opt.min_seed_len * opt.a))
        b.submit(*probs[-1])
    for (q, t, minsc), r in zip(probs, b.run_align2()):
        e = ksw.align2(q, t, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                       ksw.KSW_XSUBO | ksw.KSW_XSTART | minsc)
        assert (r.score, r.te, r.qe, r.score2, r.te2, r.tb, r.qb) == (
            e.score, e.te, e.qe, e.score2, e.te2, e.tb, e.qb
        )


@pytest.mark.parametrize("walk", ["device", "host"])
def test_global_matches_oracle_at_production_shape(walk, monkeypatch):
    monkeypatch.setenv("ARACHNE_DEVICE_TB", "1" if walk == "device" else "0")
    opt = MemOptions()
    mat = opt.scoring_matrix()
    rng = np.random.default_rng(5)
    b = BatchGlobal(opt)
    assert (b.qmax, b.tmax) == (192, 320)
    probs = []
    for i in range(40):
        tlen = int(rng.integers(20, 193))
        t = rng.integers(0, 4, tlen).astype(np.uint8)
        s = list(t)
        for _ in range(int(rng.integers(0, 3)) if i % 2 else 0):
            j = int(rng.integers(1, len(s) - 1))
            if rng.random() < 0.5:
                del s[j]
            else:
                s.insert(j, int(rng.integers(0, 4)))
        q = np.array(s, np.uint8)
        q[rng.random(len(q)) < 0.02] = 4
        # bands as gen_cigar_prepare sets them: never below |tlen - qlen| + 3
        probs.append((q, t, abs(len(t) - len(q)) + 3 + int(rng.integers(0, 98))))
        b.submit(*probs[-1])
    got = b.run()
    assert got == [
        ksw.global2(q, t, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w)
        for q, t, w in probs
    ]
    assert any(op in (1, 2) for _sc, cig in got for op, _n in cig)


@pytest.mark.parametrize("walk", ["device", "host"])
def test_global_multi_base_indels_match_oracle(walk, monkeypatch):
    """Insertions and deletions of 2-5 bases: the traceback must stay in
    the gap state (ksw.c stores the F continuation as 2<<4), so each indel
    comes out as one run, from the oracle and from the batcher alike."""
    monkeypatch.setenv("ARACHNE_DEVICE_TB", "1" if walk == "device" else "0")
    opt = MemOptions()
    mat = opt.scoring_matrix()
    rng = np.random.default_rng(9)
    b = BatchGlobal(opt)
    probs, planted = [], []
    for i in range(24):
        t = rng.integers(0, 4, int(rng.integers(60, 190))).astype(np.uint8)
        n = int(rng.integers(2, 6))
        j = int(rng.integers(20, len(t) - 20))
        if i % 2:
            q = np.concatenate([t[:j], rng.integers(0, 4, n).astype(np.uint8), t[j:]])
        else:
            q = np.concatenate([t[:j], t[j + n:]])
        probs.append((q, t, n + 8))
        planted.append((1 if i % 2 else 2, n))
        b.submit(*probs[-1])
    got = b.run()
    want = [ksw.global2(q, t, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w)
            for q, t, w in probs]
    assert got == want
    for (_sc, cig), (op, n) in zip(want, planted):
        assert [(o, l) for o, l in cig if o in (1, 2)] == [(op, n)]


def test_extension_chunks_pad_and_unsort(monkeypatch):
    """Several full-size chunks (the last one padded), the problems sorted
    by target length across them, results back in submission order."""
    calls = []
    real = sw_extend._extend_stacked

    def spy(qs, ts, meta, mat, **kw):
        calls.append((qs.shape, qs.dtype, ts.shape, meta.shape, meta.dtype,
                      np.asarray(meta)))
        return real(qs, ts, meta, mat, **kw)

    monkeypatch.setattr(sw_extend, "_extend_stacked", spy)
    opt = MemOptions()
    be = BatchExtender(opt)
    be.CHUNK = 64
    probs = _extension_problems(6, 150, qmax=80, tmax=200)
    for p in probs:
        be.submit(*p)
    assert be.run() == [_oracle(opt, p) for p in probs]
    assert [c[0] for c in calls] == [(64, 192)] * 3
    assert all(c[1] == jnp.int8 and c[2] == (64, 512) and c[3] == (4, 64)
               and c[4] == jnp.int32 for c in calls)
    tlens = np.concatenate([c[5][1] for c in calls])[: len(probs)]
    assert list(tlens) == sorted(len(t) for _q, t, *_ in probs)
    # padding lanes of the last chunk: qlen 1, tlen 0 (no rows), w 1, h0 1
    last = calls[-1][5][:, len(probs) - 128:]
    assert (last == np.array([[1], [0], [1], [1]])).all()


def test_small_batches_pad_to_power_of_two_buckets():
    assert [pad_batch(n) for n in (1, 64, 65, 200, 4096)] == [64, 64, 128, 256, 4096]
    assert pad_batch(5, 32) == 32


def test_native_library_failure_raises_on_gpu(monkeypatch):
    from arachne_tpu import native
    from arachne_tpu.config import ArachneConfig
    from arachne_tpu.index import FMIndex, build_fmindex, pack_reference
    from arachne_tpu.ops import engine

    rng = np.random.default_rng(2)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 2000)])
    packed = pack_reference([("c", "", seq)])
    idx = FMIndex(packed, build_fmindex(packed))

    class _Gpu:
        platform = "gpu"

    monkeypatch.setattr(jax, "devices", lambda *a, **k: [_Gpu()])
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native host library unavailable"):
        engine.TpuEngine(idx, ArachneConfig())


def test_cached_build_names_by_content_and_reports_failure(tmp_path):
    from arachne_tpu.native import cached_build

    src = tmp_path / "a.c"
    src.write_text("int f(void) { return 1; }\n")
    built = []

    def cmd(out):
        built.append(out)
        return ["cp", str(src), out]

    p1 = cached_build("x", [str(src)], cmd, str(tmp_path / "build"))
    n = len(built)
    assert os.path.exists(p1) and cached_build("x", [str(src)], cmd, str(tmp_path / "build")) == p1
    assert len(built) == n + 1        # the second call only hashed the command
    src.write_text("int f(void) { return 2; }\n")
    p2 = cached_build("x", [str(src)], cmd, str(tmp_path / "build"))
    assert p2 != p1 and os.path.exists(p2)
    with pytest.raises(RuntimeError, match="building y failed"):
        cached_build("y", [str(src)], lambda out: ["false"], str(tmp_path / "build"))


@pytest.mark.parametrize(
    "stats, env, want",
    [
        ({"bytes_limit": 80 << 30}, None, (80 << 30) - (4 << 30)),
        (None, None, 1 << 62),
        ({"bytes_limit": 80 << 30}, "12345", 12345),
    ],
    ids=["device_limit", "no_limit_reported", "env_override"],
)
def test_table_budget_from_device_memory(stats, env, want, monkeypatch):
    from arachne_tpu.ops.engine import TABLE_HEADROOM_BYTES, table_budget

    class _Dev:
        def memory_stats(self):
            return stats

    if env is None:
        monkeypatch.delenv("ARACHNE_HBM_BUDGET", raising=False)
    else:
        monkeypatch.setenv("ARACHNE_HBM_BUDGET", env)
    assert TABLE_HEADROOM_BYTES == 4 << 30
    assert table_budget(_Dev()) == want


def test_device_seeding_flag_is_off_by_default_and_strict(monkeypatch):
    from arachne_tpu.ops.engine import _device_seeding_from_env

    monkeypatch.delenv("ARACHNE_DEVICE_SEEDING", raising=False)
    assert _device_seeding_from_env() is False
    monkeypatch.setenv("ARACHNE_DEVICE_SEEDING", "1")
    assert _device_seeding_from_env() is True
    monkeypatch.setenv("ARACHNE_DEVICE_SEEDING", "yes")
    with pytest.raises(ValueError):
        _device_seeding_from_env()


@pytest.mark.parametrize("platforms, cards, pid, want", [
    ("", 4, 6, [2]),          # the third card of the second four-card host
    ("", 0, 1, None),         # no card on the host: nothing to pin
    ("cpu", 4, 1, None),      # a CPU run never pins
])
def test_init_distributed_pins_each_process_to_a_card(platforms, cards, pid, want,
                                                      monkeypatch):
    from arachne_tpu.parallel import distributed

    seen = {}
    monkeypatch.setattr(distributed.jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.setattr(distributed.jax, "process_index", lambda: pid)
    monkeypatch.setattr(distributed.jax, "process_count", lambda: 8)
    monkeypatch.setattr(distributed, "gpus_on_host", lambda: cards)
    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    ctx = distributed.init_distributed("localhost:1", 8, pid)
    assert ctx.initialized and ctx.process_index == pid
    assert seen["local_device_ids"] == want
    assert seen["process_id"] == pid and seen["num_processes"] == 8


@pytest.mark.parametrize("env", [None, "/some/shared/cache"], ids=["unset", "set"])
def test_compile_cache_dir_rule(env, monkeypatch):
    from arachne_tpu import cli

    updates = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.__setitem__(k, v))
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    cli.enable_compilation_cache()
    if env is None:
        assert updates["jax_compilation_cache_dir"] == os.path.join(REPO, ".jax_cache")
    else:
        assert "jax_compilation_cache_dir" not in updates


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_gpu(where, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        alone = tmp_path / "chip_smoke.py"
        alone.write_text(open(script).read())
        script = str(alone)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, script], env=env, capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path))
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


@pytest.mark.gpu
def test_extension_on_the_card_equals_host_backend(gpu_device):
    """On the card: the extension batcher at the production shape against
    the same program on the host backend (chip_smoke.py runs the full
    parity set)."""
    opt = MemOptions()
    probs = _extension_problems(12, 512)
    runs = []
    for dev in (gpu_device, jax.devices("cpu")[0]):
        with jax.default_device(dev):
            be = BatchExtender(opt)
            for p in probs:
                be.submit(*p)
            runs.append(be.run())
    assert runs[0] == runs[1]
