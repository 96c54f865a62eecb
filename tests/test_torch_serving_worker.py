"""The port's in-pod serving worker (samples/workloads/serving_worker_torch.py)
as tests/test_e2e_process.py drives the JAX worker: a PodCliqueSet decode
clique whose pod is the worker as a real process, Running strictly before
Ready, and Ready only after the engine is warm (the readiness file comes
after the warm line); and the worker started alone on the CPU, serving
for about two seconds."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from grove_tpu.agent.process import ProcessKubelet
from grove_tpu.api import Pod, PodCliqueSet, constants as c, new_meta
from grove_tpu.api.core import ContainerSpec, PodPhase
from grove_tpu.api.meta import is_condition_true
from grove_tpu.api.podcliqueset import (
    PodCliqueSetSpec,
    PodCliqueSetTemplate,
    PodCliqueTemplate,
)
from grove_tpu.cluster import new_cluster
from grove_tpu.topology.fleet import FleetSpec, SliceSpec

from test_e2e_simple import wait_for

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "samples" / "workloads" / "serving_worker_torch.py"
WARM = "engine warm (test-tiny), signalling ready"


@pytest.mark.timeout(150)
def test_pod_goes_ready_only_after_the_engine_is_warm(tmp_path):
    fleet = FleetSpec(slices=[SliceSpec(generation="v5e", topology="2x4",
                                        count=1)], fake=False)
    cl = new_cluster(fleet=fleet, fake_kubelet=False)
    cl.manager.add_runnable(ProcessKubelet(cl.client, workdir=str(tmp_path)))
    log_dir = tmp_path / "pod-logs"

    def logs() -> str:
        # One log file per pod incarnation: scan them all.
        return "".join(f.read_text() for f in log_dir.glob(
            "default.torchserve-0-decode-0.*.log"))

    with cl:
        client = cl.client
        client.create(PodCliqueSet(
            meta=new_meta("torchserve"),
            spec=PodCliqueSetSpec(replicas=1, template=PodCliqueSetTemplate(
                cliques=[PodCliqueTemplate(
                    name="decode", replicas=1, tpu_chips_per_pod=4,
                    container=ContainerSpec(
                        argv=[sys.executable, str(WORKER), "--device",
                              "cpu"],
                        env={"GROVE_SERVE_SECONDS": "60"},
                        readiness_file="ready",
                        readiness_period_s=0.2,
                        readiness_timeout_s=120.0))],
            ))))
        sel = {c.LABEL_PCS_NAME: "torchserve"}

        def pod():
            pods = client.list(Pod, selector=sel)
            return pods[0] if pods else None

        def running():
            live = pod()
            return live is not None and live.status.phase == PodPhase.RUNNING

        wait_for(running, timeout=20.0, desc="process running")
        p = pod()
        assert p is None or not is_condition_true(
            p.status.conditions, c.COND_READY), "Ready before the engine warmed"

        seen = []

        def ready():
            live = pod()
            if live is not None and is_condition_true(
                    live.status.conditions, c.COND_READY):
                seen.append(logs())   # the log as Ready is first seen
                return True
            return False

        wait_for(ready, timeout=130.0, desc="ready after engine warm")
        # The worker prints the warm line before it writes the probe file.
        assert WARM in seen[0], seen[0]
        assert "signalling ready" in logs()


@pytest.mark.timeout(120)
def test_worker_alone_serves_on_the_cpu(tmp_path):
    env = dict(os.environ, GROVE_SERVE_SECONDS="2", GROVE_POD_NAME="solo",
               GROVE_READY_FILE=str(tmp_path / "ready"))
    proc = subprocess.run([sys.executable, str(WORKER), "--device", "cpu"],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=100)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == f"worker solo: {WARM}", lines
    assert (tmp_path / "ready").read_text() == "ok"
    served = [ln for ln in lines if ln.startswith("served ")]
    assert len(served) == 1, lines
    n = int(served[0].split()[1])
    assert n > 0 and n % 8 == 0, served
