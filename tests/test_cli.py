"""CLI smoke tests (stream contract + flags) on the cpu platform."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
       "PATH": "/usr/bin:/bin:/usr/local/bin"}


@pytest.fixture(scope="module")
def run(contest_dir):
    def _run(args, stdin_text):
        return subprocess.run(
            [sys.executable, "-m", "radixhashjoin_tpu", *args],
            input=stdin_text, capture_output=True, text=True,
            cwd=contest_dir, env=ENV, timeout=300)
    return _run


@pytest.fixture(scope="module")
def tiny_stream(contest_dir):
    with open(os.path.join(contest_dir, "contest.work")) as f:
        lines = [l for l in f][:3]
    init = "".join(f"./r{i}\n" for i in range(14))
    return init + "Done\n" + "".join(lines) + "F\n"


def test_cli_null_and_selfjoin(run):
    out = run([], "./r0\nDone\n0|0.0=123456789|0.0\nF\n")
    assert out.returncode == 0 and out.stdout == "NULL\n"


def test_cli_backend_flags_agree(run, tiny_stream):
    a = run(["--backend", "dense"], tiny_stream)
    b = run(["--backend", "sort"], tiny_stream)
    c = run(["--oracle"], tiny_stream)
    assert a.returncode == b.returncode == c.returncode == 0
    assert a.stdout == b.stdout == c.stdout
    assert a.stdout.count("\n") == 3


def test_cli_missing_relation_graceful(run):
    out = run([], "no_such_file\nDone\n")
    assert out.returncode == 1
    assert "cannot load relations" in out.stderr


def test_cli_malformed_query_graceful(run):
    out = run([], "./r0\nDone\ngarbage\nF\n")
    assert out.returncode == 1
    assert "malformed work stream" in out.stderr
