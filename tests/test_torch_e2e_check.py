"""The port's e2e gate, tested: hack/e2e_check_torch.py driven against the
port's API-server emulator with the port's CLI binaries (`python -m
nos_tpu_torch.cli` apiserver, scheduler, partitioner, tpu-agent) as
subprocesses, the process topology of tests/test_e2e_check.py:30 on the
JAX package. Every hop (binary startup, kubeconfig, watch informers, the
annotations protocol, bind) crosses a real process and socket boundary.
Marked `slow` like its reference: the tier-1 run deselects it."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn(args, env):
    return subprocess.Popen(
        [sys.executable, "-m", "nos_tpu_torch.cli", *args],
        cwd=REPO,
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )


def _kubeconfig_parses(path):
    """The file holds a whole kubeconfig naming a cluster server: the
    apiserver writes it in place, so a reader between the open and the
    write sees an empty file (ROADMAP C8)."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return False
    clusters = raw.get("clusters") if isinstance(raw, dict) else None
    return bool(clusters and clusters[0].get("cluster", {}).get("server"))


@pytest.mark.slow
def test_e2e_check_passes_against_emulator_with_real_binaries(tmp_path):
    kubeconfig = str(tmp_path / "kubeconfig")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    try:
        procs.append(
            _spawn(["apiserver", "--port", "0", "--write-kubeconfig", kubeconfig], env)
        )
        deadline = time.monotonic() + 60
        while not _kubeconfig_parses(kubeconfig):
            assert time.monotonic() < deadline, "apiserver never wrote a whole kubeconfig"
            assert procs[0].poll() is None, procs[0].stdout.read()
            time.sleep(0.2)
        kube_env = dict(env, KUBECONFIG=kubeconfig)
        # The scheduler, the partitioner and the agent as the chart deploys
        # them. The agent's node is created by the gate; the agent retries
        # until it exists.
        procs.append(_spawn(["scheduler", "--kubeconfig", kubeconfig], kube_env))
        procs.append(_spawn(["partitioner", "--kubeconfig", kubeconfig], kube_env))
        procs.append(
            _spawn(["tpu-agent", "--kubeconfig", kubeconfig, "--node", "e2e-node-ci"],
                   kube_env)
        )
        check = subprocess.run(
            [sys.executable, os.path.join(REPO, "hack", "e2e_check_torch.py"),
             "--timeout", "90", "--node-name", "e2e-node-ci"],
            cwd=REPO,
            env=dict(kube_env, NOS_E2E_KUBECONFIG=kubeconfig),
            capture_output=True,
            text=True,
            timeout=240,
        )
        assert check.returncode == 0, (
            f"e2e_check_torch failed:\n{check.stdout}\n{check.stderr}\n"
            + "\n".join(f"--- {p.args[3]} alive={p.poll() is None}" for p in procs)
        )
        assert "PASS: full dynamic-partitioning loop" in check.stdout
        for rung in range(1, 7):
            assert f"{rung}/6" in check.stdout
    finally:
        for p in procs:
            try:
                p.send_signal(signal.SIGTERM)
            except Exception:  # noqa: BLE001
                pass
        for p in procs:
            try:
                p.wait(timeout=10)
            except Exception:  # noqa: BLE001
                p.kill()
