"""The reference cases that wait on the port's scheduler, wiring and CLI
(`nos_tpu_torch/{config,system,cli}.py`, `scheduler/scheduler.py`), taken
by name from files whose other cases earlier test files already hold:

- tests/test_resources.py :68-130 (pod-resources accounting through the
  agents) and tests/test_scheduler_args.py :64-106 (plugin args through
  `SchedulerConfig`); tests/test_torch_api.py holds the rest of both;
- the five `build_tpu_agent` cases of tests/test_local_tpulib.py (the
  grant gate and the backend ladder: local chips on an explicit grant,
  else the native shim, else the fake);
- tests/test_gpu_modes.py::test_cli_gpu_agent_modes_start,
  tests/test_quota_operator.py::test_operator_plus_scheduler_preemption_path;
- one scenario of the soak and sweep files:
  tests/test_kube_soak.py::test_two_schedulers_one_leader_no_double_bind
  and one parameter set of tests/test_scheduler_property_sweep.py (with its
  checkpoint-budget probe);
- tests/test_perf_planner.py's group-mode round (:135) and its
  defrag-armed twin (:216), 64 hosts of 2x2 and 100 gangs, 3.0 s ceilings;
- tests/test_kube_backend.py::TestApiserverCli::
  test_apiserver_subprocess_with_kubeconfig, rewritten for ROADMAP C8 (and
  given 30 s, not 10, for the port's CLI to start: it imports torch);
- `python -m nos_tpu_torch.cli demo` in a fresh process, which must exit 0
  with neither `jax` nor the JAX package imported.

Every case but the last two is the reference's own, read from its file
with its `nos_tpu` names pointed at the port (`torch_mirror`)."""

import json
import os
import subprocess
import sys

import test_torch_fleet_parity as fp
import torch_mirror

_time_limit = fp.time_limit(60)
_reset_state = torch_mirror.reset_state()

torch_mirror.mirror(globals(), "test_resources", only=[
    "test_tpu_pod_resources_accounting", "test_gpu_pod_resources_accounting",
    "test_agents_expose_pod_resources"])
torch_mirror.mirror(globals(), "test_scheduler_args", only=[
    "test_scheduler_config_applies_plugin_config",
    "test_scheduler_config_rejects_bad_plugin_config",
    "test_plugin_config_does_not_clobber_explicit_flat_knobs",
    "test_plugin_config_applies_on_programmatic_construction"])
torch_mirror.mirror(globals(), "test_local_tpulib", only=[
    "test_grant_gate_rejects_conventional_disable_values",
    "test_agent_builder_prefers_local_chips_when_granted",
    "test_agent_builder_declines_local_on_topology_mismatch",
    "test_agent_builder_survives_undiscoverable_chips",
    "test_agent_builder_never_probes_without_explicit_grant"])
torch_mirror.mirror(globals(), "test_gpu_modes", only=["test_cli_gpu_agent_modes_start"])
torch_mirror.mirror(globals(), "test_quota_operator",
                    only=["test_operator_plus_scheduler_preemption_path"])
torch_mirror.mirror(globals(), "test_kube_soak",
                    only=["test_two_schedulers_one_leader_no_double_bind"])
torch_mirror.mirror(globals(), "test_perf_planner", only=[
    "test_control_round_v5e_256_slice_group_64_hosts",
    "test_control_round_with_defrag_armed_slice_group"])
_sweep = torch_mirror.mirror(globals(), "test_scheduler_property_sweep",
                             only=["test_checkpoint_budget_is_enforced_per_workload"])


def test_no_starvation_no_unbounded_eviction_sticky_clears():
    """The sweep's parameter set of the round-3 live-lock (every job
    checkpointable, reservations on), on two 4x4 meshes, seed 0."""
    _sweep.test_no_starvation_no_unbounded_eviction_sticky_clears(
        shape="two-4x4", fraction=1.0, seed=0, reservations_on=True)


def _kubeconfig_parses(path):
    """The file holds a whole kubeconfig naming a cluster server."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return False
    clusters = raw.get("clusters") if isinstance(raw, dict) else None
    return bool(clusters and clusters[0].get("cluster", {}).get("server"))


class TestApiserverCli:
    def test_apiserver_subprocess_with_kubeconfig(self, tmp_path):
        """tests/test_kube_backend.py:526 on the port's CLI, waiting until
        the kubeconfig parses, not merely until the file exists: the server
        writes it in place, so a reader between the open and the write sees
        an empty file and would connect to the default 127.0.0.1:8080
        (ROADMAP C8)."""
        kube_backend = torch_mirror.load("test_kube_backend")
        kubeconfig = str(tmp_path / "kubeconfig")
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "nos_tpu_torch.cli", "apiserver",
                "--port", "0", "--write-kubeconfig", kubeconfig,
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        try:
            kube_backend.wait_for(lambda: os.path.exists(kubeconfig) and
                                  _kubeconfig_parses(kubeconfig),
                                  timeout=30.0, msg="kubeconfig written and parsed")
            kube = kube_backend.KubeCluster(kubeconfig_path=kubeconfig)
            kube.create(kube_backend.Node(metadata=kube_backend.ObjectMeta(name="cli-node")))
            assert kube.get("Node", "", "cli-node").metadata.name == "cli-node"
            kube.close()
        finally:
            proc.terminate()
            proc.wait(timeout=10)


def test_cli_demo_subprocess_imports_neither_jax_nor_nos_tpu():
    """`python -m nos_tpu_torch.cli demo` exits 0, and at its end neither
    `jax` nor the JAX package is in `sys.modules` (the CLI's imports are
    lazy, so only a run of the command sees them all)."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['nos_tpu_torch.cli', 'demo']\n"
        "try:\n"
        "    runpy.run_module('nos_tpu_torch.cli', run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = [m for m in sys.modules if m in ('jax', 'nos_tpu')\n"
        "       or m.startswith(('jax.', 'nos_tpu.'))]\n"
        "assert 'nos_tpu_torch.system' in sys.modules\n"
        "assert 'nos_tpu_torch.scheduler.plugins.capacity' in sys.modules\n"
        "print('rc', rc, 'bad', bad)\n"
        "sys.exit(rc if not bad else 3)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=50, cwd=str(torch_mirror.TESTS.parent))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "pod bound to: tpu-node-0" in res.stdout
    assert "rc 0 bad []" in res.stdout
