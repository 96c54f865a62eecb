"""The torch.distributed twin of the in-pod bootstrap
(samples/workloads/allreduce_worker_torch.py), as
tests/test_e2e_jax_distributed.py drives the JAX worker: a PodCliqueSet
whose pods are real processes that form a gloo group purely from the
injected env contract (TPU_WORKER_ID / TPU_WORKER_HOSTNAMES) and agree on
a cross-process all-reduce; and the same two workers started directly,
without the control plane."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from grove_tpu.agent.process import ProcessKubelet
from grove_tpu.api import Pod, PodCliqueSet, constants as c, new_meta
from grove_tpu.api.core import ContainerSpec, PodPhase
from grove_tpu.api.podcliqueset import (
    PodCliqueSetSpec,
    PodCliqueSetTemplate,
    PodCliqueTemplate,
)
from grove_tpu.cluster import new_cluster
from grove_tpu.topology.fleet import FleetSpec, SliceSpec

from test_e2e_simple import wait_for

ROOT = Path(__file__).resolve().parents[1]
WORKER = "samples/workloads/allreduce_worker_torch.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _results(out_dir: Path, n: int) -> list[float] | None:
    vals = []
    for i in range(n):
        f = out_dir / f"result-{i}.txt"
        if not f.exists():
            return None
        text = f.read_text().strip()
        if not text:
            return None
        vals.append(float(text))
    return vals


@pytest.mark.timeout(120)
def test_gang_bootstraps_a_torch_process_group(tmp_path):
    n = 2
    fleet = FleetSpec(slices=[SliceSpec(generation="v5e", topology="2x4",
                                        count=1)], fake=False)
    cl = new_cluster(fleet=fleet, fake_kubelet=False)
    cl.manager.add_runnable(ProcessKubelet(cl.client))
    port = free_port()
    with cl:
        cl.client.create(PodCliqueSet(
            meta=new_meta("torchdist"),
            spec=PodCliqueSetSpec(replicas=1, template=PodCliqueSetTemplate(
                cliques=[PodCliqueTemplate(
                    name="w", replicas=n, min_available=n,
                    tpu_chips_per_pod=4,
                    container=ContainerSpec(
                        argv=[sys.executable, WORKER, "--device", "cpu"],
                        env={"GROVE_COORD_HOST": "127.0.0.1",
                             "GROVE_COORD_PORT": str(port),
                             "GROVE_OUT_DIR": str(tmp_path)},
                        workdir=str(ROOT)))],
            ))))

        wait_for(lambda: all(
            p.status.phase == PodPhase.RUNNING for p in cl.client.list(
                Pod, selector={c.LABEL_PCS_NAME: "torchdist"})) and len(
            cl.client.list(Pod, selector={c.LABEL_PCS_NAME: "torchdist"}))
            == n, timeout=30.0, desc="workers running")

        expected = float(sum(range(1, n + 1)))  # Σ (wid+1)
        wait_for(lambda: _results(tmp_path, n) == [expected] * n,
                 timeout=60.0,
                 desc=f"all workers computed all_reduce == {expected}")


@pytest.mark.timeout(90)
def test_two_workers_agree_without_the_control_plane(tmp_path):
    """Each worker reads only its env: the rendezvous at worker 0's
    address, gloo on the CPU by the flag, and a world of 2."""
    n, port = 2, free_port()
    procs = []
    try:
        for wid in range(n):
            env = dict(os.environ, TPU_WORKER_ID=str(wid),
                       TPU_WORKER_HOSTNAMES="w-0,w-1",
                       GROVE_COORD_HOST="127.0.0.1",
                       GROVE_COORD_PORT=str(port),
                       GROVE_OUT_DIR=str(tmp_path), GROVE_HOLD_SECONDS="0")
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / WORKER), "--device", "cpu"],
                env=env, cwd=tmp_path, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    assert [p.returncode for p in procs] == [0] * n, outs
    assert _results(tmp_path, n) == [3.0, 3.0]
    for wid, out in enumerate(outs):
        assert f"worker {wid}/2 (gloo): all_reduce = 3.0" in out
