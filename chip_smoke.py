"""Drive the engine's main path on NVIDIA GPUs and check every answer.

    python chip_smoke.py              # phases (a) and (b) on one GPU
    python chip_smoke.py --chips 4    # phase (c) only, on four GPUs

(a) Contest mix through the CLI: a seeded SIGMOD-2018-contest workload
    (radixhashjoin_tpu/datagen.py) is written in the binary/text formats,
    piped into ``python -m radixhashjoin_tpu`` and every output line is
    compared with oracle.py on the same data. The same workload then runs
    in-process through the materialized paths (factorized=False), the sort
    join backend and grouped rounds (stage_group=4).
(b) Huge-node path: a Zipf(1.1) foreign-key join of a 2^30 + tail row
    fact table with a 2^20-key dimension and two exact u64 SUMs through
    Engine.run_workload, against the closed-form NumPy answer.
(c) Four GPUs: (a)'s workload factorized and, at 1/20 of its size,
    with factorized=False (the all_to_all level-0 exchange), then (b)'s
    join row-sharded, each over a 4-device mesh.

Every comparison is exact. With no GPU the script exits non-zero and
prints no result line. Earlier lines report the card, the native host
runtime, per-phase wall and compile times and peak device memory; the
last line of stdout is the JSON result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
CONTEST_SCALE = 100         # oracle.py takes about a minute on the host
# phase (c) with factorized=False runs the exchange path, which compiles
# one program per distinct step shape: ~150 programs at scale 1 and ~220
# at scale 10 (four devices), ~1.3 s each on an H100. At 1/20 of the
# contest's size it needs ~30 and still moves every join's pairs through
# all_to_all.
MESH_EXCHANGE_SCALE = 0.05
HUGE_LOG_ROWS = 30          # the fact table of the engine's flagship join
HUGE_TAIL = 12345           # ragged tail: exercises the last-window path
N_KEYS = 1 << 20


class SmokeFailure(AssertionError):
    """A phase produced a wrong answer."""


def log(msg: str) -> None:
    print(msg, flush=True)


def check_gpu() -> dict:
    """The device as JAX reports it, from a short child process, so that
    this process stays off the card while the CLI phase runs. Raises
    SystemExit unless the default device is a GPU."""
    probe = ("import json, jax; d = jax.devices(); print(json.dumps("
             "{'platform': d[0].platform, 'kind': d[0].device_kind, "
             "'count': len(d)}))")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise SystemExit(f"chip_smoke: JAX found no device:\n{r.stderr}")
    dev = json.loads(r.stdout.strip().splitlines()[-1])
    if dev["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: no GPU, JAX runs on "
                         f"{dev['platform']}; refusing to go on")
    return dev


def card_line() -> str:
    """name, power.limit of every card, as nvidia-smi prints them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


class CompileClock:
    """Seconds XLA spent compiling programs (or fetching them from the
    persistent cache) since construction. Tracing and lowering are not
    counted: their events nest, so their durations overlap."""

    _EVENTS = ("/jax/core/compile/backend_compile_duration",
               "/jax/compilation_cache/cache_retrieval_time_sec")

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_kw):
        if event in self._EVENTS:
            self.total += duration


def timed_run(engine, batches, clock):
    """Cold run (compiles) then one warm run; returns (lines, stats)."""
    c0, t0 = clock.total, time.perf_counter()
    lines = engine.run_workload(batches)
    cold = time.perf_counter() - t0
    compile_s = clock.total - c0
    t0 = time.perf_counter()
    again = engine.run_workload(batches)
    warm = time.perf_counter() - t0
    if again != lines:
        raise SmokeFailure("warm run disagrees with cold run")
    return lines, {"cold_s": round(cold, 3), "warm_s": round(warm, 4),
                   "compile_s": round(compile_s, 3)}


def compare(name, got, want):
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if len(got) != len(want) or bad:
        raise SmokeFailure(
            f"{name}: {len(bad)} of {len(want)} lines differ from the "
            f"oracle (first: {bad[:5]}; got {len(got)} lines)")


# ---------------------------------------------------------------- (a)

def contest_workload(scale, seed, out_dir):
    """Generate, write and answer (oracle.py) the contest workload."""
    from radixhashjoin_tpu.datagen import generate, write_workload
    t0 = time.perf_counter()
    w = generate(seed, scale)
    write_workload(w, out_dir)
    rels = w.relations()
    gen_s = time.perf_counter() - t0
    return w, rels, gen_s


def run_cli(out_dir):
    """Start the CLI on init + Done + work; returns (Popen, stdin text)."""
    with open(os.path.join(out_dir, "contest.init")) as f:
        init = f.read()
    with open(os.path.join(out_dir, "contest.work")) as f:
        work = f.read()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "radixhashjoin_tpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=out_dir, env=env)
    return proc, init + work


def phase_contest_cli(scale, seed, out_dir):
    """(a), first half: the CLI in a child process (which owns the card
    meanwhile) while this process computes the oracle's answers."""
    from radixhashjoin_tpu.oracle import run_workload
    w, rels, gen_s = contest_workload(scale, seed, out_dir)
    t0 = time.perf_counter()
    proc, stdin_text = run_cli(out_dir)
    t_o = time.perf_counter()
    want = run_workload(rels, w.batches)
    oracle_s = time.perf_counter() - t_o
    out, err = proc.communicate(stdin_text, timeout=900)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SmokeFailure(f"CLI exited {proc.returncode}:\n{err[-4000:]}")
    compare("contest via CLI", out.splitlines(), want)
    stats = {"tuples": int(sum(len(c[0]) for c in w.columns)),
             "queries": sum(len(b) for b in w.batches),
             "datagen_s": round(gen_s, 3), "oracle_s": round(oracle_s, 3),
             "cli_wall_s": round(cli_s, 3)}
    return w, rels, want, stats


CONTEST_CONFIGS = {
    "materialized": {"factorized": False},
    "sort_backend": {"join_backend": "sort"},
    "stage_group4": {"stage_group": 4},
}


def phase_contest_inproc(rels, batches, want, clock, configs=None,
                         **common):
    """(a), second half: the same workload in-process per config."""
    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.models.engine import Engine
    out = {}
    for name, kw in (configs or CONTEST_CONFIGS).items():
        engine = Engine(rels, EngineConfig(**kw, **common))
        got, st = timed_run(engine, batches, clock)
        compare(f"contest {name}", got, want)
        out[name] = st
        del engine
    return out


# ---------------------------------------------------------------- (b)

def zipf_join(log_rows, tail, n_keys=N_KEYS, seed=3):
    """Fact (key, value) with Zipf(1.1) keys over a dense n_keys-row
    dimension, generated on the device and brought to the host; returns
    (relations, query, expected line). Hot key n_keys-1 holds ~25% of
    the rows."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from radixhashjoin_tpu.storage import ColumnStats, Relation
    from radixhashjoin_tpu.workload import (FilterPred, JoinPred,
                                            Projection, Query)
    n = (1 << log_rows) + tail
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)

    @jax.jit
    def gen():
        u = jax.random.uniform(k1, (n,), minval=1e-12, maxval=1.0)
        zk = jnp.minimum(u ** -10.0, n_keys - 1).astype(jnp.int32)
        return zk, jax.random.randint(k2, (n,), 0, 1000, jnp.int32)

    zk32, v32 = (np.asarray(a) for a in gen())
    dv = np.asarray(jax.random.randint(k3, (n_keys,), 0, 1000, jnp.int32)
                    ).astype(np.uint64)
    zk, vals = zk32.astype(np.uint64), v32.astype(np.uint64)

    def stats(col, bound):
        nz = np.flatnonzero(np.bincount(col, minlength=bound))
        return ColumnStats(int(nz[0]), int(nz[-1]), int(nz.size))

    fact = Relation([zk, vals], compute_stats=False)
    fact.set_stats([stats(zk32, n_keys), stats(v32, 1000)])
    dim = Relation([np.arange(n_keys, dtype=np.uint64), dv])
    # closed form: dim keys are unique, so fact row r joins iff its key
    # passes the dim filter; SUM(dim.value) weights each passing key by
    # its fact multiplicity
    keep = (dv < 900)[zk32]
    e0 = int(vals[keep].sum(dtype=np.uint64))
    cnt = np.bincount(zk32[keep], minlength=n_keys).astype(np.uint64)
    e1 = int((dv * cnt * (dv < 900)).sum(dtype=np.uint64))
    q = Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(1, 1, "<", 900)],
              [Projection(0, 1), Projection(1, 1)])
    return [fact, dim], q, f"{e0 % 2**64} {e1 % 2**64}"


def phase_huge(log_rows, tail, clock, **config):
    """(b): the huge-node window loops (ops/factorized.py) and their
    ragged tail, through Engine.run_workload. Reports the device memory
    each device holds while the engine is alive (gib_in_use)."""
    import jax
    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.models.engine import Engine
    from radixhashjoin_tpu.ops import factorized
    t0 = time.perf_counter()
    rels, q, want = zipf_join(log_rows, tail)
    gen_s = time.perf_counter() - t0
    n = rels[0].num_tuples
    t0 = time.perf_counter()
    engine = Engine(rels, EngineConfig(**config))
    load_s = time.perf_counter() - t0
    got, st = timed_run(engine, [[q]], clock)
    compare(f"huge zipf join ({n} rows)", got, [want])
    st.update(rows=n, huge_path=n > factorized._BIG_WAVE_ROWS,
              datagen_s=round(gen_s, 3), load_s=round(load_s, 3),
              gib_in_use=memory_gib(
                  jax.devices()[:config.get("mesh_devices", 1)],
                  "bytes_in_use"))
    del engine
    return st


def memory_gib(devices, stat="peak_bytes_in_use"):
    return [round((d.memory_stats() or {}).get(stat, 0) / 2**30, 2)
            for d in devices]


# ---------------------------------------------------------------- (c)

def oracle_child(scale, seed, out_dir):
    """Start a CPU child process that writes oracle.py's answers for the
    contest workload to out_dir/contest.result (datagen --result), so
    that the oracle runs while the engine does."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "radixhashjoin_tpu.datagen", "--out",
         out_dir, "--seed", str(seed), "--scale", str(scale), "--result"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def oracle_lines(child, out_dir):
    _, err = child.communicate(timeout=900)
    if child.returncode != 0:
        raise SmokeFailure(f"oracle child exited {child.returncode}:\n"
                           f"{err[-4000:]}")
    with open(os.path.join(out_dir, "contest.result")) as f:
        return f.read().splitlines()


def mesh_contest(scale, seed, out_dir, clock, n_devices, **config):
    """The contest workload on an n-device mesh against oracle.py."""
    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.datagen import generate
    from radixhashjoin_tpu.models.engine import Engine
    child = oracle_child(scale, seed, out_dir)
    w = generate(seed, scale)
    engine = Engine(w.relations(),
                    EngineConfig(mesh_devices=n_devices, **config))
    got, st = timed_run(engine, w.batches, clock)
    del engine, w
    compare(f"contest {config or 'factorized'} on {n_devices} devices",
            got, oracle_lines(child, out_dir))
    return st


def phase_mesh(clock, out_dir, n_devices=4, scale=CONTEST_SCALE,
               exchange_scale=MESH_EXCHANGE_SCALE, log_rows=HUGE_LOG_ROWS,
               tail=HUGE_TAIL):
    """(c): the contest workload over an n-device mesh, factorized (psum'd
    d_ftree waves) and materialized (the all_to_all level-0 exchange),
    then the huge join row-sharded over the mesh. Logs each step as it
    ends. Raises SmokeFailure if the engine's device memory is lopsided
    across the mesh."""
    import jax
    st = mesh_contest(scale, SEED, os.path.join(out_dir, "fact"), clock,
                      n_devices)
    log(f"phase c (contest, factorized, {n_devices} GPUs): {json.dumps(st)}")
    st = mesh_contest(exchange_scale, SEED, os.path.join(out_dir, "mat"),
                      clock, n_devices, factorized=False)
    st["scale"] = exchange_scale
    log(f"phase c (contest, factorized=False, {n_devices} GPUs): "
        f"{json.dumps(st)}")
    st = phase_huge(log_rows, tail, clock, mesh_devices=n_devices)
    st["peak_gib"] = memory_gib(jax.devices()[:n_devices])
    log(f"phase c (huge join, {n_devices} GPUs): {json.dumps(st)}")
    held = st["gib_in_use"]
    if min(held) < max(held) / 4:
        raise SmokeFailure(f"the engine's device memory is lopsided "
                           f"across the mesh: {held} GiB")


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = p.parse_args(argv)

    import radixhashjoin_tpu  # noqa: F401  (fails outside the repo)

    dev = check_gpu()
    if dev["count"] < args.chips:
        raise SystemExit(f"chip_smoke: {args.chips} GPUs asked for, "
                         f"{dev['count']} found")
    log(f"card: {card_line()}")
    from radixhashjoin_tpu.runtime import native_available
    log(f"native host runtime loaded: {native_available()}")

    with tempfile.TemporaryDirectory(prefix="rhj_smoke_") as tmp:
        if args.chips == 1:
            w, rels, want, st = phase_contest_cli(CONTEST_SCALE, SEED, tmp)
            log(f"phase a (CLI): {json.dumps(st)}")
            import jax
            clock = CompileClock()
            st = phase_contest_inproc(rels, w.batches, want, clock)
            log(f"phase a (in-process): {json.dumps(st)}")
            del w, rels
            st = phase_huge(HUGE_LOG_ROWS, HUGE_TAIL, clock)
            st["peak_gib"] = memory_gib(jax.devices()[:1])[0]
            log(f"phase b: {json.dumps(st)}")
        else:
            phase_mesh(CompileClock(), tmp)
    import jax
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
