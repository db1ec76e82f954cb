"""The port's serving fleet as subprocesses on the CPU: two demo replicas
(``python -m tensorframes_tpu_torch.serving.replica_main --demo --device
cpu``) supervised by :class:`ServingFleet` behind the router ingress.

* kill -9 of a replica under load: every request answered exactly once
  with 200, one crash restart, and the restarted replica ran no kernel
  build (``kernel_builds == 0``) and has no more dispatch keys than its
  warm-up's (the port's counterpart of the reference's zero-compile
  restart);
* a rolling restart by ``POST /admin/drain``: the replica exits clean,
  respawns with attempt 1 without touching the crash budget, and the
  fleet serves;
* a SIGSTOPped replica: detected by its stale heartbeat, killed and
  restarted once, and its fresh incarnation not judged by the old beat.

Each drill bounds itself: deadlines on every wait, ``fleet.stop()`` in
``finally`` (which kills stragglers).
"""

import json
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

from tensorframes_tpu_torch.compilecache import serving_row_buckets
from tensorframes_tpu_torch.serving import ServingFleet
from tensorframes_tpu_torch.serving.replica import read_cards

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MAX_BATCH_ROWS = 8
ENV = {"TFTPU_HEARTBEAT_INTERVAL_S": "0.1", "OMP_NUM_THREADS": "1",
       "PYTHONPATH": _REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}


def _fleet_cmd():
    return [sys.executable, "-m", "tensorframes_tpu_torch.serving.replica_main", "--demo",
            "--max-batch-rows", str(MAX_BATCH_ROWS), "--device", "cpu"]


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _wait(cond, timeout):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)
    return cond()


def test_fleet_kill9_under_load_exactly_once_and_no_build_on_restart():
    fleet = ServingFleet(_fleet_cmd(), 2, heartbeat_timeout_s=3.0, env=ENV)
    fleet.start()
    results = []
    lock = threading.Lock()

    def load(n, tid):
        for i in range(n):
            st, body = _post(fleet.url + "/v1/score",
                             {"inputs": {"x": [[float((tid * n + i) % 5)] * 8]},
                              "deadline_s": 30.0})
            with lock:
                results.append((st, body))
            time.sleep(0.01)

    try:
        threads = [threading.Thread(target=load, args=(20, t)) for t in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        assert fleet.kill_replica(1, signal.SIGKILL) is not None
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        # exactly one response per request, and with a survivor and a
        # generous deadline every one is a success
        assert len(results) == 60
        assert all(st == 200 for st, _ in results), [(st, b) for st, b in results
                                                      if st != 200][:3]
        # the supervisor's scan may trail the load under a busy host
        assert _wait(lambda: 1 in fleet.restart_reports, 60.0), fleet.status()
        assert fleet.restarts == 1
        report = fleet.restart_reports[1]
        assert report["attempt"] == 1
        # the restart built nothing and dispatched at its warm-up's keys
        assert report["kernel_builds"] == 0, report
        assert report["xla_compiles"] == len(serving_row_buckets(MAX_BATCH_ROWS)), report
        fleet.wait_ready(timeout=30.0)
        st, body = _post(fleet.url + "/v1/score",
                         {"inputs": {"x": [[1.0] * 8]}, "deadline_s": 30.0})
        assert st == 200
        assert fleet.status()["router"]["rejected"] == {"no_replica": 0, "deadline": 0}
    finally:
        fleet.stop()


def test_fleet_rolling_restart_via_http_drain():
    """Draining one replica over HTTP makes it exit clean; the fleet
    respawns it with attempt 1 without charging the crash budget."""
    fleet = ServingFleet(_fleet_cmd(), 2, heartbeat_timeout_s=3.0, env=ENV)
    fleet.start()
    try:
        cards = read_cards(fleet.rendezvous_dir, fleet.run_id)
        st, body = _post(f"http://127.0.0.1:{cards[0]['port']}/admin/drain", {})
        assert st == 202

        # the fleet records its report once the router reads the respawned
        # incarnation (attempt 1) as running
        assert _wait(lambda: fleet.restart_reports.get(0, {}).get("attempt") == 1, 60.0), \
            fleet.status()
        snap = fleet.router.replicas()[0]
        assert snap["attempt"] == 1 and snap["state"] == "running", snap
        assert fleet.restarts == 0  # a clean exit is budget-free
        assert not fleet.degraded
        assert fleet.restart_reports[0]["kernel_builds"] == 0
        st, body = _post(fleet.url + "/v1/score",
                         {"inputs": {"x": [[2.0] * 8]}, "deadline_s": 30.0})
        assert st == 200
    finally:
        fleet.stop()


def test_fleet_wedged_replica_detected_by_heartbeat_and_restarted():
    """A SIGSTOPped replica (alive, silent) is detected by its stale
    heartbeat, killed and restarted; the restarted one is not killed
    again by its predecessor's beat still on disk."""
    fleet = ServingFleet(_fleet_cmd(), 2, heartbeat_timeout_s=1.5, env=ENV)
    fleet.start()
    try:
        os.kill(fleet.pid(1), signal.SIGSTOP)
        assert _wait(lambda: 1 in fleet.restart_reports, 90.0), fleet.status()
        assert fleet.restarts == 1
        fleet.wait_ready(timeout=30.0)
        # soak past the heartbeat timeout: a stale-beat misjudgment of the
        # fresh incarnation would restart it again here
        time.sleep(2.5)
        assert fleet.restarts == 1, fleet.status()
        assert _wait(lambda: fleet.router.live_count() == 2, 10.0), fleet.status()
        st, body = _post(fleet.url + "/v1/score",
                         {"inputs": {"x": [[1.0] * 8]}, "deadline_s": 30.0})
        assert st == 200
    finally:
        fleet.stop()
