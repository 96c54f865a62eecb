"""Workload-side metric reporting — the autoscaling feedback loop.

The port's copy of ``grove_tpu/serving/metrics_push.py``; the pump takes
``samples_for_push`` from the port's ``serving/slo.py``.

Engines running inside pods push their scaling signal (queue depth, rps)
to the control plane's HTTP API using only the injected environment:

- ``GROVE_CONTROL_PLANE`` — the serve daemon URL (injected by the node
  agent when the cluster runs in serve mode),
- ``GROVE_API_CA`` — CA bundle pinning an https control plane (injected
  alongside the URL when serve runs with --tls),
- ``GROVE_PCSG_NAME`` / ``GROVE_PCLQ_NAME`` — which object the metric
  scales.

Zero dependencies beyond urllib; failures are swallowed (metrics are
advisory — a serving engine must never crash because the control plane
blinked).
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

ENV_CONTROL_PLANE = "GROVE_CONTROL_PLANE"
ENV_CA = "GROVE_API_CA"


def _scope(kind: str | None, name: str | None,
           namespace: str | None) -> tuple[str, str, str] | None:
    """Resolve the scaling scope from args or the injected env:
    scaling group if the pod belongs to one (scaling whole model
    instances), else its clique. None = nothing to report against."""
    if kind is None or name is None:
        pcsg = os.environ.get("GROVE_PCSG_NAME", "")
        if pcsg:
            kind, name = "PodCliqueScalingGroup", pcsg
        else:
            kind, name = "PodClique", os.environ.get("GROVE_PCLQ_NAME", "")
    if not name:
        return None
    return (kind, name,
            namespace or os.environ.get("GROVE_NAMESPACE", "default"))


def push_metric(metric: str, value: float, *, kind: str | None = None,
                name: str | None = None, namespace: str | None = None,
                server: str | None = None) -> bool:
    """Report one metric for this pod's scaling scope. Returns True
    when the control plane accepted the sample."""
    scope = _scope(kind, name, namespace)
    if scope is None:
        return False
    kind, name, namespace = scope
    return _post({
        "kind": kind, "name": name, "metric": metric, "value": value,
        "namespace": namespace,
        # Per-reporter samples: the registry aggregates fresh samples
        # across reporters instead of last-write-wins.
        "reporter": os.environ.get("GROVE_POD_NAME", "_default"),
    }, server)


def push_samples(samples: list[dict], *, kind: str | None = None,
                 name: str | None = None, namespace: str | None = None,
                 server: str | None = None) -> bool:
    """Batched push: ONE POST carrying every sample in ``samples``
    (each ``{"metric", "value"}`` with an optional ``"agg"`` —
    sum|max|avg — telling the registry how to combine reporters).

    This is how an engine ships its whole SLO digest (queue depth, KV
    utilization, TTFT/TPOT percentiles — serving/slo.samples_for_push)
    per reporting tick: the single-metric ``push_metric`` would cost
    one control-plane round trip per signal."""
    scope = _scope(kind, name, namespace)
    if scope is None or not samples:
        return False
    kind, name, namespace = scope
    return _post({
        "kind": kind, "name": name, "namespace": namespace,
        "reporter": os.environ.get("GROVE_POD_NAME", "_default"),
        "samples": [{"metric": s["metric"], "value": s["value"],
                     **({"agg": s["agg"]} if s.get("agg") else {})}
                    for s in samples],
    }, server)


def _post(payload_dict: dict, server: str | None) -> bool:
    server = server or os.environ.get(ENV_CONTROL_PLANE, "")
    if not server:
        return False
    payload = json.dumps(payload_dict).encode()
    headers = {"Content-Type": "application/json"}
    # Workload identity: the kubelet injects GROVE_API_TOKEN alongside the
    # control-plane URL; without it, a server running with
    # require_token_for_metrics rejects the push as anonymous (401).
    token = os.environ.get("GROVE_API_TOKEN", "")
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        f"{server}/metrics/push", data=payload, method="POST",
        headers=headers)
    try:
        ctx = None
        if server.startswith("https"):
            import ssl
            # Inside the try: a missing/unreadable CA file must degrade
            # to a skipped push, not crash the engine's metrics loop.
            ctx = ssl.create_default_context(
                cafile=os.environ.get(ENV_CA) or None)
        with urllib.request.urlopen(req, timeout=2, context=ctx) as resp:
            return resp.status == 200
    except (OSError, ValueError):
        # URLError, SSLError, FileNotFoundError are all OSError;
        # ValueError covers a malformed CA bundle path/content.
        return False


def start_telemetry_pump(telemetry, interval: float = 2.0, stop=None,
                         **kwargs):
    """Background thread pushing an EngineTelemetry's full SLO digest
    (serving/slo.samples_for_push) every ``interval`` seconds as ONE
    batched POST — the digest twin of ``queue_depth_hook``. ``stop``
    (a threading.Event) ends the pump; push failures are swallowed like
    every other metrics path (advisory, never crash the engine).
    Returns the started thread."""
    import threading

    from grove_tpu_torch.serving.slo import samples_for_push

    stop = stop or threading.Event()

    def pump() -> None:
        while not stop.is_set():
            try:
                push_samples(samples_for_push(telemetry), **kwargs)
            except Exception:  # noqa: BLE001 - advisory path
                pass
            stop.wait(interval)

    t = threading.Thread(target=pump, name="slo-push", daemon=True)
    t.stop_event = stop
    t.start()
    return t


def queue_depth_hook(**kwargs):
    """A DecodeEngine ``metric_hook``: reports the engine's queue depth.

    Pushes happen on a background thread (latest value wins) — the hook
    itself never blocks the decode loop, even when the control plane is
    slow or down.
    """
    import queue
    import threading

    latest: "queue.Queue[float]" = queue.Queue(maxsize=1)

    def pump() -> None:
        while True:
            depth = latest.get()
            # Coalesce to the most recent value.
            try:
                while True:
                    depth = latest.get_nowait()
            except queue.Empty:
                pass
            push_metric("queue_depth", depth, **kwargs)

    threading.Thread(target=pump, name="metrics-push", daemon=True).start()

    def hook(depth: float) -> None:
        try:
            latest.put_nowait(depth)
        except queue.Full:
            try:
                latest.get_nowait()
            except queue.Empty:
                pass
            try:
                latest.put_nowait(depth)
            except queue.Full:
                pass

    return hook
